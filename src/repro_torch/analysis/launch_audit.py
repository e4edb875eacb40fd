"""Launch auditor: prove the one-launch-per-burst contract on the kernels.

The kernel backends' performance story is a claim about what each flush
sends to the card, not a style claim about the source: each flush phase
must make exactly ONE kernel launch (the chip axis included), with no
host synchronization inside it, a bounded set of launch shapes across
burst sizes, and byte counters that reconcile against the operands the
launch actually took.

The auditor enforces this dynamically.  It wraps each kernel entry point
where the backend looks it up (``sim_search``/``sim_plan``/
``sim_fused_lookup``/``sim_gather`` in ``repro_torch.backend.batched``;
``sim_search_chips``/``sim_plan_chips`` in ``repro_torch.backend.sharded``,
whose lookups and gathers go through the batched module's launch
helpers) with a recorder that summarizes every call's tensor operands and
outputs, counts the kernel's runs inside it — ``native.LAUNCHES`` on the
card, calls of the plain version in ``ref.py`` on the CPU — and watches
for host syncs.  It then drives a scripted scenario through every flush
path — search (cold + warm), plan, lookup, gather, the zero-launch
program group, search after it — checking after each phase:

  * SIM101 — exactly one recorded entry per flush phase, and exactly one
    run of the entry's kernel inside it: on the card ``native.LAUNCHES``
    moved by one (a wrapper that ran ``ref.py`` on a CUDA tensor shows
    here), on the CPU its plain version ran once.  Over the whole phase
    ``native.LAUNCHES`` moves only inside the recorded entries, so a
    kernel launched elsewhere in the flush shows too;
  * SIM102 — no host sync inside an entry.  On the card every entry runs
    under ``torch.cuda.set_sync_debug_mode("error")`` (reset afterwards,
    even on failure); a sync raises there, is recorded, and ends the
    scenario.  On the CPU the recorder catches ``Tensor.item``/``tolist``/
    ``cpu``/``numpy`` and ``torch.cuda.synchronize`` called while an entry
    runs (outside the plain version, which stands in for the kernel);
  * SIM103 — distinct operand signatures of the search entry across a
    burst-size sweep 1..16 stay within log2(16) + 1.  A signature holds
    the per-burst operands only (queries, masks, rows, bitmaps, flags),
    not the arena planes: the in-place kernels take the whole arena,
    whose capacity may grow mid-sweep, and that is residency, not a
    launch shape.  Plus the pure ``padded_rows`` bound;
  * SIM104 — ``staged_bytes`` deltas equal PAGE_BYTES x newly staged pages
    (ZERO when warm), ``result_bytes`` deltas the exact 64 B-granular
    payload of the command mix and no more than the recorded outputs'
    bytes, ``kernel_launches`` the phase's one launch, ``programs``/
    ``programs_coalesced`` the program group's; a search's ``rows``
    operand is ``(padded_rows(unique pages, PAGE_BLOCK),)`` on batched
    and ``(next_pow2(active chips), n_pad)`` on sharded, and the plan
    phase's copied planes (``take``/``take2d``) hold exactly as many rows.

The JAX package's SIM105 (lowered-HLO parameter and result bytes against
the jaxpr's) has no counterpart: a CUDA launch has no lowered HLO, and
SIM104 already holds the operand and output bytes the recorder sees.

Failures surface as :class:`Finding` rows (path ``audit:<backend>``) that
flow through the same baseline/check gate as the AST lint.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import math

import torch

from repro_torch.backend.base import MatchBackend, make_backend
from repro_torch.backend.batched import PAGE_BLOCK
from repro_torch.backend.planestore import next_pow2, padded_rows
from repro_torch.backend.sharded import SHARDED_PAGE_BLOCK
from repro_torch.core.bits import PAGE_BYTES
from repro_torch.core.commands import Command
from repro_torch.core.engine import SimChipArray
from repro_torch.core.range_query import exact_range
from repro_torch.kernels import native

from .findings import Finding

_BATCHED = "repro_torch.backend.batched"
_PATCH_POINTS = {
    "batched": ((_BATCHED, ("sim_search", "sim_plan", "sim_fused_lookup",
                            "sim_gather")),),
    "sharded": (("repro_torch.backend.sharded",
                 ("sim_search_chips", "sim_plan_chips")),
                (_BATCHED, ("sim_fused_lookup", "sim_gather"))),
}

# entry -> (its ops module, the kernel it launches, the plain version in
# ref.py it runs on the CPU, looked up in the ops module at call time)
_ENTRIES = {
    "sim_search": ("repro_torch.kernels.sim_search.ops", "sim_search",
                   "sim_search_ref"),
    "sim_search_chips": ("repro_torch.kernels.sim_search.ops", "sim_search",
                         "sim_search_chips_ref"),
    "sim_plan": ("repro_torch.kernels.sim_plan.ops", "sim_plan",
                 "sim_plan_ref"),
    "sim_plan_chips": ("repro_torch.kernels.sim_plan.ops", "sim_plan",
                       "sim_plan_chips_ref"),
    "sim_fused_lookup": ("repro_torch.kernels.sim_fused.ops", "sim_lookup",
                         "sim_lookup_ref"),
    "sim_gather": ("repro_torch.kernels.sim_gather.ops", "sim_gather",
                   "sim_gather_ref"),
}

#: operands that change with the burst (SIM103's signature)
BURST_OPERANDS = frozenset({"queries", "masks", "flags", "rows", "bitmap",
                            "key_rows", "value_rows"})
#: host syncs the CPU recorder catches on ``torch.Tensor``
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_ERROR = "synchronizing CUDA operation"


# ----------------------------------------------------------------- recorder
@dataclasses.dataclass(frozen=True)
class OperandSummary:
    """Tensor operands (by parameter name) and outputs of one entry call."""
    operands: tuple[tuple[str, tuple, str], ...]   # (name, shape, dtype)
    out_shapes: tuple[tuple[tuple, str], ...]
    in_bytes: int
    out_bytes: int

    def shape_of(self, name: str) -> tuple | None:
        return next((s for n, s, _ in self.operands if n == name), None)

    @property
    def signature(self) -> tuple:
        return tuple(o for o in self.operands if o[0] in BURST_OPERANDS)


@dataclasses.dataclass
class LaunchRecord:
    entry: str                # patched entry point name
    kernel: str               # its key in ``native.LAUNCHES``
    summary: OperandSummary
    launches: int             # native.LAUNCHES[kernel] moved inside it
    plain_runs: int           # runs of its plain version inside it
    syncs: tuple[str, ...]    # host syncs caught inside it (CPU)


class HostSyncInEntry(RuntimeError):
    """A kernel entry synchronized with the host under sync debug mode."""

    def __init__(self, entry: str, message: str):
        super().__init__(f"{entry}: {message}")
        self.entry = entry
        self.message = message


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def summarize(params: dict, out) -> OperandSummary:
    """Summarize the tensor operands (``params``: name -> value, in call
    order) and the output (a tensor or a tuple of them)."""
    ops = [(n, tuple(v.shape), str(v.dtype)) for n, v in params.items()
           if isinstance(v, torch.Tensor)]
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    outs = [t for t in outs if isinstance(t, torch.Tensor)]
    return OperandSummary(
        operands=tuple(ops),
        out_shapes=tuple((tuple(t.shape), str(t.dtype)) for t in outs),
        in_bytes=sum(_tensor_bytes(v) for v in params.values()
                     if isinstance(v, torch.Tensor)),
        out_bytes=sum(_tensor_bytes(t) for t in outs))


class _Watch:
    """Recorder state shared by the wrappers: plain-version runs per
    kernel, and the host syncs caught while an entry runs on the CPU."""

    def __init__(self):
        self.plain = dict.fromkeys(native.LAUNCHES, 0)
        self.in_plain = 0
        self.syncs: list[str] | None = None    # set while an entry runs

    def caught(self, name: str) -> None:
        if self.syncs is not None and not self.in_plain:
            self.syncs.append(name)


@contextlib.contextmanager
def _catch_host_syncs(watch: _Watch):
    """Route ``Tensor.item/tolist/cpu/numpy`` and ``torch.cuda.synchronize``
    through ``watch`` while the block runs; restore them after."""
    saved = {n: torch.Tensor.__dict__.get(n) for n in SYNC_METHODS}
    saved_sync = torch.cuda.synchronize

    def method(name):
        base = getattr(torch._C.TensorBase, name)

        def caught(self, *args, **kwargs):
            watch.caught(f"Tensor.{name}")
            return base(self, *args, **kwargs)
        return caught

    def synchronize(*args, **kwargs):
        watch.caught("torch.cuda.synchronize")
        return saved_sync(*args, **kwargs)

    try:
        for n in SYNC_METHODS:
            setattr(torch.Tensor, n, method(n))
        torch.cuda.synchronize = synchronize
        yield
    finally:
        torch.cuda.synchronize = saved_sync
        for n, f in saved.items():
            if f is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, f)


def _record_wrapper(orig, entry: str, records: list, watch: _Watch):
    opsmod, kernel, _ = _ENTRIES[entry]
    sig = inspect.signature(getattr(importlib.import_module(opsmod), entry))

    def wrapped(*args, **kwargs):
        params = sig.bind(*args, **kwargs).arguments
        on_card = any(isinstance(v, torch.Tensor) and v.device.type == "cuda"
                      for v in params.values())
        launches0, plain0 = native.LAUNCHES[kernel], watch.plain[kernel]
        syncs: list[str] = []
        if on_card:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(*args, **kwargs)
            except RuntimeError as e:
                if _SYNC_ERROR in str(e):
                    raise HostSyncInEntry(entry, str(e)) from e
                raise
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        else:
            watch.syncs = syncs
            try:
                with _catch_host_syncs(watch):
                    out = orig(*args, **kwargs)
            finally:
                watch.syncs = None
        records.append(LaunchRecord(
            entry=entry, kernel=kernel, summary=summarize(params, out),
            launches=native.LAUNCHES[kernel] - launches0,
            plain_runs=watch.plain[kernel] - plain0, syncs=tuple(syncs)))
        return out
    return wrapped


def _plain_wrapper(orig, kernel: str, watch: _Watch):
    def counted(*args, **kwargs):
        watch.plain[kernel] += 1
        watch.in_plain += 1
        try:
            return orig(*args, **kwargs)
        finally:
            watch.in_plain -= 1
    return counted


@contextlib.contextmanager
def record_launches(kind: str):
    """Patch ``kind``'s kernel entry points where the backend looks them
    up, and count the plain versions they run; yields the record list.
    Raises KeyError for a backend without kernels (``"scalar"``)."""
    points = _PATCH_POINTS[kind]
    watch = _Watch()
    records: list[LaunchRecord] = []
    saved = []
    try:
        for modname, names in points:
            mod = importlib.import_module(modname)
            for n in names:
                saved.append((mod, n, getattr(mod, n)))
                setattr(mod, n, _record_wrapper(getattr(mod, n), n, records,
                                                watch))
                opsmod, kernel, ref = _ENTRIES[n]
                ops = importlib.import_module(opsmod)
                saved.append((ops, ref, getattr(ops, ref)))
                setattr(ops, ref, _plain_wrapper(getattr(ops, ref), kernel,
                                                 watch))
        yield records
    finally:
        for mod, n, f in reversed(saved):
            setattr(mod, n, f)


# ----------------------------------------------------------------- scenario
def _key(page: int, i: int) -> int:
    """Distinct programmed u64 keys, high nibble tagged to dodge headers."""
    return (0xA << 60) | (page << 16) | i


N_KEY_PAGES = 6
VAL_BASE = 6
N_ENTRIES = 12


@dataclasses.dataclass
class PhaseLog:
    """What one flush phase launched and moved."""
    kind: str
    phase: str
    entries: list[str]
    launches: dict            # native.LAUNCHES deltas over the phase
    staged_bytes: int
    result_bytes: int
    kernel_launches: int

    def format(self) -> str:
        moved = {k: v for k, v in self.launches.items() if v}
        return (f"audit:{self.kind} {self.phase}: entries {self.entries}, "
                f"native launches {moved}, staged_bytes "
                f"{self.staged_bytes}, result_bytes {self.result_bytes}, "
                f"kernel_launches {self.kernel_launches}")


def _chips(kind: str) -> SimChipArray:
    return SimChipArray(n_chips=4 if kind == "sharded" else 2,
                        pages_per_chip=64, device_seed=11)


class _Auditor:
    def __init__(self, kind: str, *, device=None):
        if kind not in _PATCH_POINTS:
            raise KeyError(kind)
        self.kind = kind
        self.device = device
        self.findings: list[Finding] = []
        self.phases: list[PhaseLog] = []
        self.phase = "setup"
        self.chips = _chips(kind)
        self.backend: MatchBackend = make_backend(kind, self.chips,
                                                  device=device)
        self.on_card = self.backend.device.type == "cuda"
        for p in range(N_KEY_PAGES):
            self.backend.program_entries(
                p, [_key(p, i) for i in range(N_ENTRIES)])
            self.backend.program_entries(
                VAL_BASE + p,
                [(0xB << 60) | (p << 16) | i for i in range(N_ENTRIES)])

    def check(self, cond: bool, rule: str, symbol: str, slug: str,
              msg: str) -> None:
        if not cond:
            self.findings.append(Finding(
                rule, f"audit:{self.kind}", symbol, slug, message=msg))

    # ------------------------------------------------------------ one phase
    def run_phase(self, records: list, phase: str, submit, *,
                  expect_result_bytes: int, expect_staged_bytes: int,
                  expect_rows: tuple | None = None,
                  expect_plane_rows: int | None = None,
                  expect_launches: int = 1):
        self.phase = phase
        r0 = len(records)
        stats = self.backend.stats
        staged0, result0 = stats.staged_bytes, stats.result_bytes
        launches0 = stats.kernel_launches
        native0 = dict(native.LAUNCHES)
        tickets = submit()
        self.backend.flush()
        recs = records[r0:]

        self.check(len(recs) == expect_launches, "SIM101", phase,
                   "launch-count",
                   f"flush dispatched {len(recs)} launches, expected "
                   f"{expect_launches}")
        for rec in recs:
            self.check_record(rec, phase)
            if expect_rows is not None:
                got = rec.summary.shape_of("rows")
                self.check(got == expect_rows, "SIM104", phase,
                           f"rows-operand:{rec.entry}",
                           f"{rec.entry} rows operand {got}, expected "
                           f"{expect_rows}")
            if expect_plane_rows is not None:
                self.check_plane_operands(rec, phase, expect_plane_rows)

        self.check(
            stats.staged_bytes - staged0 == expect_staged_bytes, "SIM104",
            phase, "staged-bytes",
            f"staged_bytes moved {stats.staged_bytes - staged0}, expected "
            f"{expect_staged_bytes} (PAGE_BYTES x newly staged pages)")
        self.check(
            stats.kernel_launches - launches0 == expect_launches, "SIM104",
            phase, "counter:kernel_launches",
            f"kernel_launches counted "
            f"{stats.kernel_launches - launches0} for {len(recs)} "
            "recorded launches")

        for t in tickets:
            t.result()
        moved = {k: native.LAUNCHES[k] - native0[k] for k in native0}
        inside = dict.fromkeys(native0, 0)
        for rec in recs:
            inside[rec.kernel] += rec.launches
        self.check(moved == inside, "SIM101", phase, "launches-outside-entry",
                   f"native.LAUNCHES moved {moved} over the phase, "
                   f"{inside} of it inside the recorded entries")

        got = stats.result_bytes - result0
        self.check(got == expect_result_bytes, "SIM104", phase,
                   "result-bytes",
                   f"result_bytes moved {got}, expected "
                   f"{expect_result_bytes} from the submitted command mix")
        if recs and expect_result_bytes:
            out_bytes = sum(r.summary.out_bytes for r in recs)
            self.check(got <= out_bytes, "SIM104", phase,
                       "result-within-launch",
                       f"result_bytes {got} exceeds the recorded launch "
                       f"outputs' {out_bytes}")
        self.phases.append(PhaseLog(
            self.kind, phase, [r.entry for r in recs], moved,
            stats.staged_bytes - staged0, got,
            stats.kernel_launches - launches0))
        return recs

    def check_record(self, rec: LaunchRecord, phase: str) -> None:
        """SIM101: one run of the entry's kernel (on the card a launch);
        SIM102: no host sync caught inside it."""
        runs = rec.launches + rec.plain_runs
        self.check(runs == 1, "SIM101", phase, f"kernel-count:{rec.entry}",
                   f"{rec.entry} ran its kernel {runs} times "
                   f"({rec.launches} launches, {rec.plain_runs} runs of the "
                   "plain version), expected exactly 1")
        if self.on_card:
            self.check(rec.plain_runs == 0, "SIM101", phase,
                       f"plain-on-card:{rec.entry}",
                       f"{rec.entry} ran its plain version on the card "
                       f"{rec.plain_runs} times instead of the kernel")
        self.check(not rec.syncs, "SIM102", phase, f"host-sync:{rec.entry}",
                   f"{rec.entry} synchronized with the host inside the "
                   f"launch: {list(rec.syncs)}")

    def check_plane_operands(self, rec: LaunchRecord, phase: str,
                             expect_rows: int) -> None:
        """Copied page planes (``take``/``take2d``) must hold exactly
        ``expect_rows`` padded rows — PAGE_BYTES per padded row."""
        planes = [rec.summary.shape_of(n) for n in ("lo", "hi")]
        planes = [s for s in planes if s is not None and s[-1] == 512]
        self.check(len(planes) == 2, "SIM104", phase,
                   f"plane-operands:{rec.entry}",
                   f"{rec.entry} has {len(planes)} plane-shaped operands, "
                   "expected lo+hi")
        for dims in planes:
            rows = math.prod(dims[:-1])
            self.check(rows == expect_rows, "SIM104", phase,
                       f"plane-rows:{rec.entry}",
                       f"{rec.entry} plane operand has {rows} padded rows "
                       f"({dims}), expected {expect_rows}")

    # ------------------------------------------------------------ scenario
    def per_chip(self, addrs: list[int]) -> list[list[int]]:
        if self.kind == "batched":
            return [sorted(set(addrs), key=addrs.index)]
        n = len(self.chips.chips)
        out: list[list[int]] = [[] for _ in range(n)]
        for a in addrs:
            if a not in out[a % n]:
                out[a % n].append(a)
        return out

    def expected_rows(self, addrs: list[int]) -> tuple:
        """The ``rows`` operand a search over ``addrs`` must take: one flat
        padded row list (batched), or the (chips, rows) matrix of the
        chip-axis launch (sharded)."""
        lists = self.per_chip(addrs)
        if self.kind == "batched":
            return (padded_rows(len(lists[0]), PAGE_BLOCK),)
        active = [a for a in lists if a]
        return (next_pow2(len(active)),
                max(padded_rows(len(a), SHARDED_PAGE_BLOCK) for a in active))

    def run(self) -> list[Finding]:
        try:
            with record_launches(self.kind) as records:
                self._scenario(records)
        except HostSyncInEntry as e:
            self.check(False, "SIM102", self.phase, f"host-sync:{e.entry}",
                       f"{e.entry} synchronized with the host inside the "
                       f"launch ({e.message}); the scenario stopped there")
        self._retrace_sweep()
        return self.findings

    def _scenario(self, records: list) -> None:
        b = self.backend

        # --- search, cold: 13 commands, 12 unique (query, page) cells ----
        search_cmds = [Command.search(p, _key(p, i))
                       for p in range(N_KEY_PAGES) for i in (0, 1)]
        search_cmds.append(Command.search(0, _key(0, 0)))    # dedup'd twin
        self.run_phase(
            records, "search-cold",
            lambda: [b.submit_search(c) for c in search_cmds],
            expect_result_bytes=64 * 12,
            expect_staged_bytes=PAGE_BYTES * N_KEY_PAGES,
            expect_rows=self.expected_rows(
                [c.page_addr for c in search_cmds]))

        # --- search, warm: same pages, new queries -> ZERO page restage --
        warm_cmds = [Command.search(p, _key(p, 2))
                     for p in range(N_KEY_PAGES)]
        self.run_phase(
            records, "search-warm",
            lambda: [b.submit_search(c) for c in warm_cmds],
            expect_result_bytes=64 * N_KEY_PAGES,
            expect_staged_bytes=0,
            expect_rows=self.expected_rows([c.page_addr for c in warm_cmds]))

        # --- fused plans: 2 distinct plans, 7 commands, 6 unique cells ---
        plan_a = exact_range(_key(0, 0), _key(0, 8))
        plan_b = exact_range(_key(1, 0), _key(1, 4))
        plan_cmds = [Command.plan(p, plan_a.include, plan_a.exclude)
                     for p in range(4)]
        plan_cmds += [Command.plan(p, plan_b.include, plan_b.exclude)
                      for p in range(2)]
        plan_cmds.append(Command.plan(0, plan_a.include, plan_a.exclude))
        self.run_phase(
            records, "plan",
            lambda: [b.submit_plan(c) for c in plan_cmds],
            expect_result_bytes=64 * 6,
            expect_staged_bytes=0,
            expect_plane_rows=math.prod(self.expected_rows(
                [c.page_addr for c in plan_cmds])))

        # --- fused lookups: 4 hits + 1 miss; value pages stage cold ------
        lookup_cmds = [Command.lookup(i, VAL_BASE + i, _key(i, 1))
                       for i in range(4)]
        lookup_cmds.append(Command.lookup(0, VAL_BASE, _key(5, 999)))
        self.run_phase(
            records, "lookup",
            lambda: [b.submit_lookup(c) for c in lookup_cmds],
            expect_result_bytes=64 * 5 + 64 * 4,
            expect_staged_bytes=PAGE_BYTES * 4)      # value pages 6..9

        # --- gathers: explicit chunk bitmaps, 64 B per selected chunk ----
        bitmaps = [0b1011, 0b1, 0b1110001]
        gather_cmds = [Command.gather(p, bm)
                       for p, bm in enumerate(bitmaps)]
        n_chunks = sum(bin(bm).count("1") for bm in bitmaps)
        self.run_phase(
            records, "gather",
            lambda: [b.submit_gather(c) for c in gather_cmds],
            expect_result_bytes=64 * n_chunks,
            expect_staged_bytes=0)

        # --- program group: ZERO launches, coalescing + grouped restage --
        def submit_programs():
            new = [_key(2, 100 + i) for i in range(N_ENTRIES)]
            newer = [_key(2, 200 + i) for i in range(N_ENTRIES)]
            other = [_key(3, 300 + i) for i in range(N_ENTRIES)]
            return [b.submit_program(2, new), b.submit_program(2, newer),
                    b.submit_program(3, other)]

        stats = b.stats
        programs0, coalesced0 = stats.programs, stats.programs_coalesced
        self.run_phase(
            records, "program-group", submit_programs,
            expect_result_bytes=0,
            expect_staged_bytes=PAGE_BYTES * 2,      # pages 2+3, one scatter
            expect_launches=0)
        self.check(stats.programs - programs0 == 2, "SIM104",
                   "program-group", "counter:programs",
                   f"programs counted {stats.programs - programs0}, "
                   "expected 2 (page 2 coalesced last-wins + page 3)")
        self.check(stats.programs_coalesced - coalesced0 == 1, "SIM104",
                   "program-group", "counter:programs_coalesced",
                   f"programs_coalesced counted "
                   f"{stats.programs_coalesced - coalesced0}, expected 1")

        # --- post-program search: group restage means NO further staging -
        post_cmds = [Command.search(2, _key(2, 200)),
                     Command.search(3, _key(3, 300))]
        self.run_phase(
            records, "search-after-program",
            lambda: [b.submit_search(c) for c in post_cmds],
            expect_result_bytes=64 * 2,
            expect_staged_bytes=0)

    # -------------------------------------------------------- retrace sweep
    def _retrace_sweep(self, burst_sizes=(1, 2, 3, 4, 5, 6, 8, 12, 16)):
        """Distinct operand signatures of the search entry across a burst
        sweep must stay within the pow2-padding bound: O(log max_burst),
        not O(bursts)."""
        self.phase = "retrace-sweep"
        backend = make_backend(self.kind, _chips(self.kind),
                               device=self.device)
        for p in range(4):
            backend.program_entries(p, [_key(p, i) for i in range(32)])
        with record_launches(self.kind) as records:
            q = 0
            for size in burst_sizes:
                tickets = []
                for _ in range(size):
                    tickets.append(backend.submit_search(
                        Command.search(q % 4, _key(q % 4, q % 32))))
                    q += 1
                backend.flush()
                for t in tickets:
                    t.result()
        sigs = {r.summary.signature for r in records
                if r.entry in ("sim_search", "sim_search_chips")}
        bound = int(math.log2(next_pow2(max(burst_sizes)))) + 1
        self.check(0 < len(sigs) <= bound, "SIM103", "retrace-sweep",
                   "distinct-signatures",
                   f"{len(sigs)} distinct launch signatures across burst "
                   f"sizes {list(burst_sizes)}; pow2 padding bounds this "
                   f"by log2(max)+1 = {bound}")

        # Pure-arithmetic half of the same invariant, over the full range.
        for block in (8, 32):
            distinct = {padded_rows(n, block) for n in range(1, 1025)}
            bound = int(math.log2(next_pow2(-(-1024 // block)))) + 1
            self.check(len(distinct) <= bound, "SIM103", "retrace-sweep",
                       f"padded-rows-bound:block{block}",
                       f"padded_rows yields {len(distinct)} distinct row "
                       f"counts for n in 1..1024 at block {block} "
                       f"(bound {bound})")


def audit_backend(kind: str, *, device=None, phase_log: list | None = None
                  ) -> list[Finding]:
    """Run the full launch audit for one backend kind on ``device`` (None:
    the card).  ``phase_log`` receives each phase's :class:`PhaseLog`."""
    aud = _Auditor(kind, device=device)
    findings = aud.run()
    if phase_log is not None:
        phase_log.extend(aud.phases)
    return findings


def run_audit(*, device=None, phase_log: list | None = None
              ) -> list[Finding]:
    """Run the launch audit of both kernel backends on ``device``."""
    findings: list[Finding] = []
    for kind in ("batched", "sharded"):
        findings.extend(audit_backend(kind, device=device,
                                      phase_log=phase_log))
    return findings
