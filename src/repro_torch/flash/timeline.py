"""Timeline coupling for functional backends: flushes -> SSD resource time.

The functional path (``frontend.replay``, the index structures, the sharded
backend) computes bit-exact results but, on its own, no latency: time lives
in the analytic simulator (flash/ssd.py).  This module is the adapter that
joins them.  A ``ShardedSsdBackend`` reports every flush as a list of
per-chip ``ChipBurst`` records — how many page senses, match ops and bus
bytes each chip contributed to the burst — and ``BurstTimeline`` replays
those counts against a real ``SSDSim``'s monotone resource timelines (die
sense/program lines, per-channel internal buses, the PCIe link).  The
result: ``frontend.replay`` returns measured bitmaps/values *plus* a
simulated latency distribution and energy account per burst, so
fig14/15-style latency plots are reproducible from the functional backend
rather than only from the closed-form simulator.

Accounting model (per paper §III-B/§IV-E, mirrored from SSDSim.read_sim):

  * every unique page a chip's burst touches costs one array sense on that
    chip's die timeline (the page open), amortized over all of the chip's
    queued queries — the §IV-E batch-matching amortization;
  * match ops serialize on the die after its senses (t_match each).  A
    fused range plan (Op.PLAN) charges one match op per include/exclude
    pass — the latches still evaluate every pass — but only ONE 64 B
    combined bitmap per page on the bus (the in-latch Fig 10 accumulation);
    the per-pass split path would cross 64 B per pass per page;
  * match-mode payloads (open verification transfers, 64 B bitmaps, 64 B
    gathered chunks) share the chip's *channel* bus timeline, so chips on
    one channel contend while chips on different channels overlap — the
    channel parallelism the paper's speedups come from;
  * dirty-plane restages (pages reprogrammed since the last flush that
    touches them) cross the channel bus in *storage* mode before the chip
    can serve match mode — the deferred half of the write path, i.e. the
    dirty-page stall.  Overwrites of one page within a window coalesce
    (only the final image crosses, as in an application-managed write
    buffer), and a written page that is never searched again defers its
    bus hop indefinitely; cold first-touch arena staging is an artifact
    of keeping pages resident on the accelerator and is never charged;
  * every chip's results funnel through the one PCIe link.

Writes (``observe_program``) model SiM's application-managed write buffer:
the program queues on the die's separate program timeline (read-priority /
program-suspend, as in SSDSim) and the client clock does NOT advance — the
cost surfaces later, as restage bytes and program-line backlog.

The timeline is numpy on the host: the device a backend runs on never
changes its numbers.  With a ``DeviceFaultState`` attached
(``attach_faults``), the stall windows active at each service time block
their die or channel lines before the burst's chains run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .params import FlashParams, PAGE_BYTES
from .ssd import SSDSim


@dataclasses.dataclass
class ChipBurst:
    """One chip's share of one flush, in resource-consumption units."""
    chip: int                   # chip index == die index (see geometry note)
    senses: int = 0             # array senses (unique pages opened)
    matches: int = 0            # SiM match ops executed
    bus_match_bytes: int = 0    # match-mode channel payload (bitmaps/chunks)
    bus_storage_bytes: int = 0  # storage-mode payload (dirty-plane restage)
    pcie_bytes: int = 0         # host-link payload
    retry_senses: int = 0       # extra senses from §IV-C2 read retries
    fallback_reads: int = 0     # full-page storage-mode reads (ECC fallback)
    degraded_reads: int = 0     # full-page reads served host-side off a
                                # replica because the primary chip is dead
                                # (device-fault tier; charged like fallback)


class BurstTimeline:
    """Feeds per-chip flush reports into SSDSim's resource timelines.

    Geometry: chip index c maps to die c (and therefore channel
    ``c % params.channels``, SSDSim's own die->channel striping), so the
    adapter requires ``params.n_dies`` chips.  Construct with
    ``BurstTimeline.for_chips(n_chips)`` to get a square-ish default.
    """

    def __init__(self, params: FlashParams):
        self.params = params
        # Device-fault state (repro_torch.reliability.DeviceFaultState) or
        # None; survives reset() — the replay attaches it once, before the
        # post-load reset.
        self.faults = None
        self.reset()

    @staticmethod
    def for_chips(n_chips: int, base: FlashParams | None = None
                  ) -> "BurstTimeline":
        """Params with ``channels x dies_per_channel == n_chips``, keeping
        the channel count near the paper's 8 (or n_chips if smaller)."""
        base = base or FlashParams()
        channels = n_chips
        for c in (8, 4, 2):
            if n_chips % c == 0 and n_chips >= c:
                channels = c
                break
        return BurstTimeline(dataclasses.replace(
            base, channels=channels, dies_per_channel=n_chips // channels))

    # ------------------------------------------------------------- control
    def reset(self) -> None:
        """Zero the clock, timelines, latencies and energy (keep params).

        ``frontend.replay`` calls this after the initial page load so the
        recorded distribution covers the replayed op stream only.
        """
        self.sim = SSDSim(self.params, n_index_pages=0, cache_pages=0,
                          system="sim")
        self.now = 0.0
        self.burst_latencies: list[float] = []
        self.write_latencies: list[float] = []

    def attach_faults(self, state) -> None:
        """Attach a DeviceFaultState: transient stall windows active at
        each service time are scheduled onto the SSDSim resource lines
        (``block_die``/``block_channel``) before the chains run."""
        self.faults = state

    def _apply_stalls(self, t: float) -> None:
        if self.faults is None:
            return
        for w in self.faults.stalls_active_at(t):
            if w.kind == "die":
                self.sim.block_die(w.target % self.params.n_dies,
                                   w.t_end_ns)
            else:
                self.sim.block_channel(w.target % self.params.channels,
                                       w.t_end_ns)

    @property
    def n_chips(self) -> int:
        return self.params.n_dies

    @property
    def energy_pj(self) -> float:
        return self.sim.energy.total_pj

    def latency_percentiles(self, qs=(50, 99)) -> dict[int, float]:
        lats = np.asarray(self.burst_latencies or [0.0])
        return {int(q): float(np.percentile(lats, q)) for q in qs}

    # ------------------------------------------------------------- events
    def observe_flush(self, bursts: list[ChipBurst], *,
                      at: float | None = None,
                      wait_program_lines: bool = False) -> float:
        """Advance the clock across one flush; returns the burst latency.

        All chips start at the flush submit time (``at``, default the
        adapter clock ``self.now``); each chip's chain is restage ->
        senses -> matches -> match-mode bus -> PCIe.  Die timelines
        overlap freely, channel buses serialize chips per channel, the
        PCIe link serializes everything — queueing falls out of SSDSim's
        max(ready, resource_free) discipline.

        ``wait_program_lines`` models a FIFO command queue without
        program suspend: each chip's chain additionally queues behind the
        die's outstanding program backlog.  The default (False) is the
        read-priority discipline baked into SSDSim's split sense/program
        timelines — reads suspend programs and never wait on them.
        """
        if not bursts:
            return 0.0
        sim = self.sim
        start = self.now if at is None else at
        self._apply_stalls(start)
        end = start
        for b in bursts:
            die = b.chip % self.params.n_dies
            t = start
            if wait_program_lines:
                t = max(t, float(sim.die_prog_free[die]))
            if b.bus_storage_bytes:
                t = sim._bus(die, t, b.bus_storage_bytes, match_mode=False)
            # Reliability tier: a read-retried open re-senses the page; an
            # ECC fallback decode additionally moves the WHOLE page over
            # the channel bus in storage mode (the §IV-C "give up and read
            # it out" path) before match mode resumes.  Device-fault
            # degraded reads (replica failover to host) are charged the
            # same way: one sense plus a full page in storage mode — no
            # free recovery.
            for _ in range(b.retry_senses + b.fallback_reads
                           + b.degraded_reads):
                t = sim._sense(die, t)
            if b.fallback_reads or b.degraded_reads:
                t = sim._bus(die, t,
                             (b.fallback_reads + b.degraded_reads)
                             * PAGE_BYTES, match_mode=False)
            for _ in range(b.senses):
                t = sim._sense(die, t)
            if b.matches:
                t = sim._match(t, b.matches)
            if b.bus_match_bytes:
                t = sim._bus(die, t, b.bus_match_bytes, match_mode=True)
            if b.pcie_bytes:
                t = sim._pcie(t, b.pcie_bytes)
            end = max(end, t)
        end += self.params.mmio_ns
        self.burst_latencies.append(end - start)
        self.now = max(self.now, end)
        return end - start

    def observe_program(self, chip: int, *,
                        at: float | None = None) -> float:
        """A page program: PCIe in, program on the die's program timeline.

        The channel-bus hop is charged when the dirty plane restages at a
        later flush (``bus_storage_bytes``) — write-back is deferred and
        overwrites coalesce, so at most one bus crossing per page per
        write window (see the module docstring for the exact semantics).
        The clock does not advance — SiM's write buffer is asynchronous;
        backlog surfaces via the die timelines.  ``at`` overrides the
        submit time (the event frontend passes its dispatch timestamp);
        the return value is the program's completion latency from submit.
        """
        sim = self.sim
        start = self.now if at is None else at
        self._apply_stalls(start)
        t = sim._pcie(start, PAGE_BYTES)
        t = sim._program(chip % self.params.n_dies, t)
        self.write_latencies.append(t - start)
        return t - start

    def observe_program_group(self, chips: list[int],
                              restage_chips: list[int] | None = None,
                              *, at: float | None = None) -> list[float]:
        """A deferred write-buffer flush: the whole dirty group at once.

        Each page crosses PCIe (serialized on the one link) and queues on
        its die's program timeline — dies program in parallel, a hot die
        accumulates backlog.  ``restage_chips`` lists the pages whose
        device-resident planes re-staged with the group: each crosses its
        channel bus in storage mode (the write-back hop; overwrites
        already coalesced, so it is at most one hop per page per group).
        The client clock does NOT advance — SiM's write buffer drains
        asynchronously; the cost surfaces as program-line backlog and bus
        occupancy.  Returns the per-program completion latencies, which
        also append to ``write_latencies``.
        """
        start = self.now if at is None else at
        out = [self.observe_program(c, at=at) for c in chips]
        for c in restage_chips or ():
            self.sim._bus(c % self.params.n_dies, start, PAGE_BYTES,
                          match_mode=False)
        return out
