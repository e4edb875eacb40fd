"""System under test of the ``kv`` configurations: the port's replay core
(``repro_torch.frontend.replay.ReplayCore``) over a SiM backend.

Set-up builds the chips and the backend, wraps the generated stream in the
port's ``Workload``, constructs the core (its constructor is the bulk
load), makes every page resident and runs the stream's first ops as the
warm-up.  The window then drives the core op by op as the serial replay
does: reads queue into bursts and flush at ``burst``; a scan and an update
first flush the open burst.  A read completes when its burst has been
drained (with the fused path's depth-1 pipeline, after the next burst's
flush), an update or a scan when its call returns.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from simbench.window import make_resident, sync

CORE_COUNTERS = ("flushes", "programs", "n_reads", "n_writes", "n_scans")


class System:
    host_layer = "frontend"

    def __init__(self, config: dict, inputs, device):
        from repro_torch.backend import make_backend
        from repro_torch.core.engine import SimChipArray
        from repro_torch.frontend.config import RunConfig
        from repro_torch.frontend.replay import ReplayCore
        from repro_torch.workload.ycsb import Workload

        kp, n_chips = int(config["n_key_pages"]), int(config["n_chips"])
        chips = SimChipArray(n_chips=n_chips,
                             pages_per_chip=-(-2 * kp // n_chips) + 1,
                             device_seed=int(config["device_seed"]))
        self.backend = make_backend(config["backend"], chips, device=device)
        self.device = device
        self.inputs = inputs
        self.run_config = RunConfig(burst=int(config["burst"]),
                                    fused=bool(config["fused"]),
                                    write_buffer=bool(config["write_buffer"]))
        wl = Workload(ops=inputs.ops, key_pages=inputs.key_pages,
                      value_pages=inputs.value_pages, alpha=inputs.alpha,
                      read_ratio=inputs.read_ratio, n_index_pages=2 * kp,
                      keys=inputs.keys, scan_lens=inputs.scan_lens)
        self.core = ReplayCore(wl, self.backend, self.run_config)
        make_resident(self.backend, range(2 * kp))
        self.ops = inputs.ops.tolist()      # Python ints: a cheaper loop
        self.window_ops = np.zeros(0, np.int64)
        self.counters: dict = {}

    def _run(self, indices) -> None:
        core, ops, burst = self.core, self.ops, self.run_config.burst
        for qi in indices:
            qi = int(qi)
            op = ops[qi]
            if op == 0:
                if core.queue_read(qi) and len(core.pending) >= burst:
                    core.resolve_burst()
            elif op == 2:
                core.scan(qi)
            else:
                core.write(qi)
        core.finish()
        sync(self.device)

    def warm_up(self) -> None:
        self._run(range(self.inputs.warmup))

    def window(self, win) -> tuple[int, np.ndarray]:
        """Run ops from the stream until the window closes; return the ops
        done and their latencies (s)."""
        core, ops, burst = self.core, self.ops, self.run_config.burst
        n = self.inputs.n_stream
        start = qi = self.inputs.warmup
        t_issue, t_done = np.zeros(n), np.zeros(n)
        clock = time.perf_counter
        groups = collections.deque()   # flushed bursts not yet drained
        open_reads: list[int] = []
        before = self._counters()
        win.open()
        while qi < n and win.tick(qi - start):
            op = ops[qi]
            t_issue[qi] = clock()
            if op == 0:
                if core.queue_read(qi):
                    open_reads.append(qi)
                    if len(core.pending) >= burst:
                        core.resolve_burst()
                else:                   # answered without the device
                    t_done[qi] = clock()
            elif op == 2:
                core.scan(qi)
            else:
                core.write(qi)
            now = clock()
            if op:
                t_done[qi] = now
            if open_reads and not core.pending:
                groups.append(open_reads)
                open_reads = []
            hits = core.hits
            while groups and hits[groups[0][-1]]:
                t_done[groups.popleft()] = now
            qi += 1
        core.finish()
        win.close(qi - start)
        for g in (*groups, open_reads):
            t_done[g] = win.t1
        self.window_ops = np.arange(start, qi)
        after = self._counters()
        self.counters = {k: after[k] - before[k] for k in after}
        return qi - start, (t_done - t_issue)[start:qi]

    def _counters(self) -> dict:
        out = {k: v for k, v in dataclasses.asdict(self.backend.stats).items()
               if isinstance(v, int)}
        out.update({k: getattr(self.core, k) for k in CORE_COUNTERS
                    if hasattr(self.core, k)})
        out["hits"] = int(self.core.hits.sum())
        return out

    def results(self) -> tuple[dict, dict]:
        """Read back the tail's keys, then hand over what the window
        produced: the executed op indices, and the read values, hits and
        scan counts by op index."""
        self._run(self.inputs.readback)
        executed = {"warmup": np.arange(self.inputs.warmup),
                    "window": self.window_ops,
                    "tail": np.asarray(self.inputs.readback)}
        core = self.core
        return executed, {"out": core.out.copy(), "hits": core.hits.copy(),
                          "scan_counts": core.scan_counts.copy()}
