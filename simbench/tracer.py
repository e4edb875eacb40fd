"""Tracing of a ``--trace 1`` run, all of it from the benchmark's side.

* **Spans**: the backend's ``submit_*``, ``flush``, ``program_entries``
  and the tickets' ``result()`` are wrapped; the outermost call's time is
  the backend's host time, and the rest of the window is the layer above
  it (the system's host layer, such as the frontend).  Spans count in the first part of the
  window only, before the profiler starts, so that the profiler's own cost
  is not in them.
* **Launch records**: the Python wrapper of each kernel that a roofline
  metric of the cell describes (its ``KERNEL`` spec, ``roofline.py``) is
  wrapped while the profiler runs; each launch keeps what the spec's bound
  needs (the real rows of the flush, and what the spec records), read back
  from the device once the window has closed.
* **Profiler**: ``torch.profiler`` over the window's last part: device
  activity, kernel time by name, and the idle gaps, each labelled by the
  backend span the host was in (outside any: the layer above).
"""
from __future__ import annotations

import collections
import importlib
import re
import sys
import time

import numpy as np
import torch

from simbench.yardstick import bounds

BACKEND_CALLS = ("submit_search", "submit_gather", "submit_lookup",
                 "submit_plan", "submit_program", "flush", "program_entries")


class Tracer:
    def __init__(self, device: torch.device, host_layer: str,
                 kernels=()):
        """``kernels``: the ``roofline.KernelSpec`` of each kernel whose
        launches the cell's metrics read."""
        self.device = device
        self.host_layer = host_layer
        self.kernels = {k.name: k for k in kernels}
        self.depth = 0
        self.accounting = True
        self.profiling = False
        self.backend_s = 0.0
        self.call_s = collections.Counter()
        self.calls = collections.Counter()
        self.spans: list[tuple] = []       # (name, start, end) while profiling
        self._pending = {k: self._empty(k) for k in self.kernels}
        self._flush = {k: 0 for k in self.kernels}
        self.launches: dict[str, list] = {k: [] for k in self.kernels}
        self._undo: list = []
        self.prof = None
        self._wall0 = self._wall1 = 0
        self._perf0 = 0.0
        self.device_kinds: dict = {}
        self.edges_us = None

    # ------------------------------------------------------------ install
    def install(self, backend) -> None:
        for name in BACKEND_CALLS:
            fn = getattr(backend, name, None)
            if fn is not None:
                setattr(backend, name, self._span(name, fn))
                self._undo.append((backend, name, None))
        from repro_torch.backend import base
        orig = base.Ticket.result
        base.Ticket.result = self._span("result", orig)
        self._undo.append((base.Ticket, "result", orig))
        for kernel, spec in self.kernels.items():
            fn_name = spec.wrapper
            try:
                orig = getattr(importlib.import_module(spec.module), fn_name)
            except (ImportError, AttributeError):
                continue
            wrapped = self._kernel(kernel, orig)
            for mod in list(sys.modules.values()):
                name = getattr(mod, "__name__", "") or ""
                if (name.split(".")[0] == "repro_torch"
                        and getattr(mod, fn_name, None) is orig):
                    setattr(mod, fn_name, wrapped)
                    self._undo.append((mod, fn_name, orig))

    def uninstall(self) -> None:
        for obj, name, orig in reversed(self._undo):
            if orig is None:
                delattr(obj, name)
            else:
                setattr(obj, name, orig)
        self._undo.clear()

    # -------------------------------------------------------------- spans
    def _empty(self, kernel):
        return set() if self.kernels[kernel].row_key is not None else 0

    def _note(self, name, args) -> None:
        """Count the rows queued for each kernel; a flush takes them."""
        if name == "flush":
            self._flush = {k: len(p) if isinstance(p, set) else p
                           for k, p in self._pending.items()}
            self._pending = {k: self._empty(k) for k in self.kernels}
            return
        for kernel, spec in self.kernels.items():
            if spec.submit != name:
                continue
            if spec.row_key is None:
                self._pending[kernel] += 1
            else:
                self._pending[kernel].add(spec.row_key(args))

    def _span(self, name, fn):
        clock = time.perf_counter
        note = self._note if name != "result" else None

        def wrapped(*args, **kw):
            if note is not None:
                note(name, args)
            if self.depth:
                self.depth += 1
                try:
                    return fn(*args, **kw)
                finally:
                    self.depth -= 1
            self.depth = 1
            t0 = clock()
            try:
                return fn(*args, **kw)
            finally:
                t1 = clock()
                self.depth = 0
                if self.accounting:
                    self.backend_s += t1 - t0
                    self.call_s[name] += t1 - t0
                    self.calls[name] += 1
                elif self.profiling:
                    self.spans.append((name, t0, t1))
        return wrapped

    def _kernel(self, kernel, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if self.profiling:
                try:
                    self.launches[kernel].append(self.kernels[kernel].record(
                        self._flush[kernel], args, kw, out))
                except (IndexError, KeyError, TypeError):
                    pass                    # a changed signature: no record
            return out
        return wrapped

    # ----------------------------------------------------------- profiler
    def _profiler(self):
        """Device activity only on the card: recording every host-side op
        as well slowed the window's host work by about a sixth."""
        acts = ([torch.profiler.ProfilerActivity.CUDA]
                if self.device.type == "cuda"
                else [torch.profiler.ProfilerActivity.CPU])
        return torch.profiler.profile(activities=acts, record_shapes=False,
                                      with_stack=False, profile_memory=False)

    def begin_profile(self) -> None:
        self.accounting = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof = self._profiler()
        self.prof.start()
        # The trace's clock is the system clock in ns; the spans' is
        # perf_counter's.  Read both together to map one onto the other.
        self._wall0, self._perf0 = time.time_ns(), time.perf_counter()
        self.profiling = True

    def end_profile(self) -> None:
        if self.prof is None or not self.profiling:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiling = False
        self._wall1 = time.time_ns()
        self.prof.stop()

    # ------------------------------------------------------------ summary
    def summary(self) -> dict | None:
        """Device busy time, kernel time and bound by kernel, the device
        operations that took most time and the idle gaps by host span, over
        the profiled window; None when no profiler ran."""
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        w0, w1 = self._wall0, self._wall1
        dev, kinds, edges = [], collections.Counter(), [None, None]
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s, d = e.start_ns(), e.duration_ns()
            kinds[_kind(e.name())] += 1
            edges = [s if edges[0] is None else min(edges[0], s),
                     s + d if edges[1] is None else max(edges[1], s + d)]
            if d > 0 and s < w1 and s + d > w0:
                dev.append((e.name(), max(s, w0), min(s + d, w1)))
        self.device_kinds = dict(kinds)
        # How far the first and last device operation lie from the window's
        # edges (us): a check that the two clocks agree.
        self.edges_us = (None if edges[0] is None else
                         ((edges[0] - w0) * 1e-3, (edges[1] - w1) * 1e-3))
        dev.sort(key=lambda x: x[1])
        busy, gaps, cur_s, cur_e = 0, [], None, w0
        for _, s, e in dev:
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, w1))
        by_op = collections.Counter()
        kernels = {k: [0.0, 0] for k in self.kernels}
        for name, s, e in dev:
            by_op[_short(name)] += (e - s) * 1e-9
            for k, spec in self.kernels.items():
                if re.search(rf"(^|[\s:]){spec.trace_name}(<|\(|$)", name):
                    kernels[k][0] += (e - s) * 1e-9
                    kernels[k][1] += 1
        return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
                "kernels": kernels, "bounds": self._bounds(),
                "device_ops": by_op.most_common(10),
                "idle_gaps": self._label_gaps(gaps, w0).most_common(10)}

    def _label_gaps(self, gaps, w0_ns) -> collections.Counter:
        """Sum each idle gap under the backend call the host was in at its
        midpoint, or under the layer above when it was in none."""
        starts = np.array([s for _, s, _ in self.spans])
        ends = np.array([e for _, _, e in self.spans])
        out = collections.Counter()
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            mid = self._perf0 + ((g0 + g1) / 2 - w0_ns) * 1e-9
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            label = (f"backend.{self.spans[i][0]}"
                     if i >= 0 and ends[i] >= mid else self.host_layer)
            out[label] += (g1 - g0) * 1e-9
        return out

    def _bounds(self) -> dict:
        """Summed bound (s) and launch count by kernel over the launches
        recorded while the profiler ran."""
        out = {}
        for kernel, recs in self.launches.items():
            bound = self.kernels[kernel].bound
            total = sum(bounds.bound(*bound(rec))[0] for rec in recs) * 1e-3
            out[kernel] = [total, len(recs)]
        return out


def _kind(name: str) -> str:
    return name.split()[0] if name.startswith(("Memcpy", "Memset")) \
        else "kernel"


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.removeprefix("void ").strip()[:100]
