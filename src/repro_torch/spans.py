"""Spans of the port's SiM path and LM serving path: where a replay's or a
served token's host time goes.

A span is a named stretch of host time on ``time.perf_counter_ns()``: its
start and end, the span it opened inside (its parent, kept by a stack) and,
where it has one, the id of the flush whose burst it serves (a flush's
children and the lazy tail of its launch carry the flush's id).  Spans are
off by default; a span site then costs one global check and records and
allocates nothing::

    s = spans.ON and spans.begin("backend.flush.stage")
    ...
    if s:
        spans.end(s)

An operator's use::

    from repro_torch import spans
    spans.enable()            # aggregates by name from here on
    ...                       # the ops
    before = spans.totals()   # {name: (count, total_ns, self_ns)}
    spans.mark()              # full records from here on, as well
    ...                       # the part a device trace covers
    spans.disable()
    recs = spans.records()    # the Records between mark() and disable()
    spans.reset()             # forget everything

``self_ns`` is a span's time less the time its child spans cover.  Nothing
here synchronizes the device or records a CUDA event (invariant I3 in
``repro_torch.backend.base``): a span is host time, and a launch's device
time is the device trace's to give.

The sites, by layer:

* frontend (``frontend/replay.py``): ``frontend.read`` (``queue_read``),
  ``frontend.burst`` (``resolve_burst``), ``frontend.drain`` (``_drain``),
  ``frontend.scan`` with ``frontend.scan.plan`` (the ``exact_range``
  decomposition), ``frontend.write``;
* backend: ``backend.flush`` (the batched backend's flush) with
  ``backend.flush.programs`` (deferred programs and their restage),
  ``backend.flush.stage`` (arena rows, index and operand uploads) and
  ``backend.flush.launch`` (the kernel wrapper); ``backend.program``
  (``program_entries``); ``backend.tail`` (a lazy tail, ``base.py``) and
  beside it ``backend.result_wait``, from the end of the tail's flush to
  the tail's start (not a span of the stack: the host does other work
  meanwhile); ``planestore.restage`` (``PlaneStore._stage``);
* chip model: ``chip.program`` (``SimChip.program_entries``) with
  ``chip.ecc`` (header and chunk parities) and ``chip.randomize``;
* copies and kernels: ``copy.h2d`` and ``copy.d2h`` (``kernels/layout.py``),
  ``kernel.launch`` (``kernels/native.py``);
* the LM serving path (``serve/batching.py``): ``serve.admit`` (a request's
  prefill and its prompt's mirror), ``serve.decode`` (one slot's decode
  step), ``serve.mirror`` (one token's block-table lookup, allocation and
  program, whose page programs run ``chip.program``); and in the published
  hymba model (``models/hymba.py``) each layer's ``model.attn.global`` or
  ``model.attn.window`` and ``model.mamba``.

The rest of the module reads records against a device trace on another
clock, by the kernels the ``kernel.launch`` spans issued:
:func:`clock_offset` maps the span clock onto the trace's host clock,
:func:`device_drift` the trace's device clock onto its host clock (the two
drift apart by a few parts a million), :func:`check_launches` checks the
mapping, and :func:`split` divides stretches of time (a device's idle
gaps) among the innermost spans over them.
"""
from __future__ import annotations

import collections
import itertools
import re
import statistics
import time
from typing import NamedTuple

ON = False                  # the one check every span site makes
RESULT_WAIT = "backend.result_wait"
FLUSH = "backend.flush"
CLIENT = "client"           # time in no span: the caller's own work

# An open span: [name, start_ns, child_ns, id, parent id, flush id, end_ns];
# a span left open by an exception or a reset gets end_ns _DROPPED.
_NAME, _T0, _CHILD, _ID, _PARENT, _FLUSH, _END = range(7)
_DROPPED = -1

_clock = time.perf_counter_ns
_stack: list[list] = []
_totals: dict[str, list] = {}      # name -> [count, total_ns, self_ns]
_records: list = []
_keep = False
_ids = itertools.count(1)
_flush_ids = itertools.count(1)


class Record(NamedTuple):
    id: int                # 0 for a span opened before mark()
    parent: int | None     # the enclosing span's id; None at the top
    name: str
    start_ns: int
    end_ns: int
    flush: int | None      # the flush whose burst the span serves


# ------------------------------------------------------------ the recorder
def enable() -> None:
    global ON
    ON = True


def mark() -> None:
    """Keep full records from here until :func:`disable`."""
    global _keep
    _records.clear()
    _keep = True


def disable() -> None:
    """Stop recording; aggregates and records stay readable."""
    global ON, _keep
    ON = False
    _keep = False


def reset() -> None:
    """Forget every aggregate, record and open span."""
    global _keep
    for f in _stack:
        f[_END] = _DROPPED
    _stack.clear()
    _totals.clear()
    _records.clear()
    _keep = False


def totals() -> dict[str, tuple[int, int, int]]:
    """``{name: (count, total_ns, self_ns)}`` since the last reset."""
    return {k: tuple(v) for k, v in _totals.items()}


def records() -> list[Record]:
    """The spans that ended between :func:`mark` and :func:`disable`, in
    the order they ended."""
    return [Record(*r) for r in _records]


def new_flush() -> int:
    """A fresh flush id, for a flush's span."""
    return next(_flush_ids)


def begin(name: str, flush: int | None = None) -> list:
    """Open span ``name`` inside the innermost open one; it serves
    ``flush``, or its parent's flush.  Returns the open span for
    :func:`end` (always true)."""
    if _stack:
        parent = _stack[-1]
        if flush is None:
            flush = parent[_FLUSH]
        frame = [name, 0, 0, next(_ids) if _keep else 0, parent[_ID], flush,
                 None]
    else:
        frame = [name, 0, 0, next(_ids) if _keep else 0, None, flush, None]
    _stack.append(frame)
    frame[_T0] = _clock()
    return frame


def end(frame: list) -> None:
    """Close ``frame`` and any span still open inside it (an exception
    skipped its end); a span opened before :func:`reset` is dropped."""
    t = _clock()
    if frame[_END] is not None:             # dropped
        return
    top = _stack.pop()
    while top is not frame:                 # left open inside it
        top[_END] = _DROPPED
        top = _stack.pop()
    frame[_END] = t
    dur = t - frame[_T0]
    agg = _totals.get(frame[_NAME])
    if agg is None:
        agg = _totals[frame[_NAME]] = [0, 0, 0]
    agg[0] += 1
    agg[1] += dur
    agg[2] += dur - frame[_CHILD]
    if _stack:
        _stack[-1][_CHILD] += dur
    if _keep:
        _records.append((frame[_ID], frame[_PARENT], frame[_NAME],
                         frame[_T0], t, frame[_FLUSH]))


def open_flush():
    """The innermost open flush span, for a lazy tail to remember (False
    when there is none)."""
    for f in reversed(_stack):
        if f[_NAME] == FLUSH:
            return f
    return False


def begin_tail(flush) -> list:
    """Open ``backend.tail`` for the launch of ``flush`` (an
    :func:`open_flush` frame, or False), and record ``backend.result_wait``
    from that flush's end to now."""
    frame = begin("backend.tail", flush[_FLUSH] if flush else None)
    if flush and flush[_END] is not None and flush[_END] != _DROPPED:
        t0, t1 = flush[_END], frame[_T0]
        agg = _totals.get(RESULT_WAIT)
        if agg is None:
            agg = _totals[RESULT_WAIT] = [0, 0, 0]
        agg[0] += 1
        agg[1] += t1 - t0
        agg[2] += t1 - t0
        if _keep:
            _records.append((next(_ids), None, RESULT_WAIT, t0, t1,
                             flush[_FLUSH]))
    return frame


# -------------------------------------------- reading against a trace
def innermost(recs) -> list[tuple[int, int, str]]:
    """Disjoint ``(start_ns, end_ns, name)`` pieces of the span clock, each
    named by the innermost span over it, in time order (waits left out)."""
    spans = sorted((r.start_ns, -r.end_ns, r.name) for r in recs
                   if r.name != RESULT_WAIT)
    out, stack, cur = [], [], None
    for t0, neg_t1, name in spans:
        while stack and stack[-1][0] <= t0:
            t1, top = stack.pop()
            if t1 > cur:
                out.append((cur, t1, top))
                cur = t1
        if stack and t0 > cur:
            out.append((cur, t0, stack[-1][1]))
        cur = t0
        stack.append((-neg_t1, name))
    while stack:
        t1, top = stack.pop()
        if t1 > cur:
            out.append((cur, t1, top))
            cur = t1
    return out


def split(intervals, pieces) -> collections.Counter:
    """ns of each name over ``intervals`` (sorted, disjoint ``(start_ns,
    end_ns)`` on the span clock): each interval's time is divided among
    the :func:`innermost` ``pieces`` it intersects, the rest under
    ``client``."""
    out = collections.Counter()
    j = 0
    for g0, g1 in intervals:
        if g1 <= g0:
            continue
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        covered = 0
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            s0, s1, name = pieces[k]
            d = min(s1, g1) - max(s0, g0)
            if d > 0:
                out[name] += d
                covered += d
            k += 1
        out[CLIENT] += (g1 - g0) - covered
    return out


def named(name: str, kernels) -> bool:
    """Whether trace name ``name`` is that of one of ``kernels``."""
    return any(re.search(rf"(^|[\s:]){k}(<|\(|$)", name) for k in kernels)


def trace_launches(events):
    """From a ``torch.profiler`` trace's events: the device's kernels
    ``(name, start_ns, correlation id)`` and the host's kernel launch calls
    ``{correlation id: (start_ns, end_ns)}`` (CUPTI's ``cudaLaunchKernel``;
    none where the trace lacks them)."""
    import torch
    kernels, calls = [], {}
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((name, e.start_ns(), e.correlation_id()))
        elif "LaunchKernel" in name:
            calls[e.correlation_id()] = (e.start_ns(), e.end_ns())
    return kernels, calls


def launch_pairs(recs, device_kernels, kernel_names):
    """The ``kernel.launch`` records paired in order with the device
    kernels of ``kernel_names`` (``(name, start_ns, correlation id)``, on
    the trace's clock), taken in start order: the kernels the spans
    issued, on one stream.  None when the counts differ."""
    launches = sorted((r for r in recs if r.name == "kernel.launch"),
                      key=lambda r: r.start_ns)
    kernels = sorted((k for k in device_kernels
                      if named(k[0], kernel_names)), key=lambda k: k[1])
    if len(launches) != len(kernels):
        return None
    return list(zip(launches, kernels))


def clock_offset(pairs, runtime) -> tuple[int, int] | None:
    """The span clock's offset onto the trace's (``trace = span + off``)
    from the runtime calls (``{correlation id: (start_ns, end_ns)}``, such
    as CUPTI's ``cudaLaunchKernel``) that each paired launch span made:
    every call lies inside its span, which bounds ``off`` from both sides.
    Returns (the middle of the bounds, their width), or None where the
    trace has no such calls or the bounds cross."""
    lo, hi = -(1 << 62), 1 << 62
    n = 0
    for rec, (_, _, corr) in pairs:
        call = runtime.get(corr)
        if call is None:
            continue
        lo = max(lo, call[1] - rec.end_ns)
        hi = min(hi, call[0] - rec.start_ns)
        n += 1
    if not n or lo > hi:
        return None
    return (lo + hi) // 2, hi - lo


def device_drift(pairs, runtime, pieces: int = 10):
    """How far the trace's device clock runs ahead of its host clock, as a
    line ``(t0, a, b)``: at host time ``t`` the device reads ``a + b (t -
    t0)`` ns later.  A kernel starts no earlier than its launch call, and
    on an idle device soon after it, so the line is fitted through the
    least "kernel start less call start" of each of ``pieces`` runs of
    paired launches.  None without two such calls."""
    pts = sorted((runtime[k[2]][0], k[1] - runtime[k[2]][0])
                 for _, k in pairs if k[2] in runtime)
    if len(pts) < 2:
        return None
    size = -(-len(pts) // pieces)
    env = [min(pts[i:i + size], key=lambda p: p[1])
           for i in range(0, len(pts), size)]
    t0 = pts[0][0]
    if len(env) < 2:
        return t0, float(env[0][1]), 0.0
    ts = [t - t0 for t, _ in env]
    mt, ms = statistics.fmean(ts), statistics.fmean(d for _, d in env)
    var = sum((t - mt) ** 2 for t in ts)
    b = (sum((t - mt) * (d - ms) for t, (_, d) in zip(ts, env)) / var
         if var else 0.0)
    return t0, ms - b * mt, b


def on_host(t_device: int, drift) -> int:
    """A device time of the trace on its host clock (``drift``: a
    :func:`device_drift` line, or None to take it as it is)."""
    if drift is None:
        return t_device
    t0, a, b = drift
    return t0 + round((t_device - t0 - a) / (1 + b))


def check_launches(pairs, offset: int, drift=None
                   ) -> tuple[int, float | None]:
    """Kernels that start before the mapped start of the launch span that
    issued them (a wrong mapping), and the median lag (ns) from that start
    to the kernel's; the kernels' starts corrected by ``drift``."""
    lags = [on_host(k[1], drift) - (rec.start_ns + offset)
            for rec, k in pairs]
    return (sum(lag < 0 for lag in lags),
            statistics.median(lags) if lags else None)
