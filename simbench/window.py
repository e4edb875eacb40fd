"""The measured window, and what every system needs around it."""
from __future__ import annotations

import math
import os
import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_resident(backend, pages) -> None:
    """Stage every loaded page into the backend's device arena at set-up,
    as a deployment holds its index on the device; a backend without an
    arena stages on first use."""
    store = getattr(backend, "store", None)
    if store is not None and hasattr(store, "stage_group"):
        store.stage_group(list(pages))


def process_cpu_s() -> float:
    """CPU seconds this process has used, all its threads."""
    t = os.times()
    return t.user + t.system


def host_probe_ms(repeats: int = 3) -> float:
    """The least time (ms) of a fixed pure-Python loop: how fast the host
    runs the window's kind of work at this moment.  Logged beside each run,
    since the host's speed, not the program, sets most of the spread
    between runs."""
    best = math.inf
    for _ in range(repeats):
        t = time.perf_counter()
        s = 0
        for i in range(200_000):
            s += i * i
        best = min(best, time.perf_counter() - t)
    return best * 1e3


class Window:
    """``open``, then ``tick`` before each op (False once ``seconds`` have
    passed), then ``close`` once the last op has completed.  With a tracer,
    the spans count the ops of the first ``seconds - profile_s`` seconds
    (``span_ops`` in ``span_s``); then the profiler starts, and the window
    runs ``profile_s`` seconds more from the moment it has started (a
    process's first start of the profiler takes seconds)."""

    def __init__(self, seconds: float, device: torch.device, tracer=None,
                 profile_s: float = 0.0):
        self.seconds = seconds
        self.device = device
        self.tracer = tracer
        self.profile_s = profile_s if tracer is not None else 0.0
        self.t0 = self.t1 = 0.0
        self.span_ops = None
        self.span_s = 0.0
        self.cpu_s = 0.0

    def open(self) -> None:
        self._cpu0 = process_cpu_s()
        self.t0 = time.perf_counter()
        self._end = self.t0 + self.seconds
        self._profile_at = (self._end - self.profile_s
                            if self.tracer is not None else math.inf)

    def tick(self, done: int) -> bool:
        now = time.perf_counter()
        if now >= self._profile_at:
            self._profile_at = math.inf
            self.span_ops, self.span_s = done, now - self.t0
            self.tracer.begin_profile()
            now = time.perf_counter()
            self._end = now + self.profile_s
        return now < self._end

    def close(self, done: int) -> None:
        sync(self.device)
        self.t1 = time.perf_counter()
        self.cpu_s = process_cpu_s() - self._cpu0
        if self.span_ops is None:
            self.span_ops, self.span_s = done, self.t1 - self.t0
        if self.tracer is not None:
            self.tracer.end_profile()

    @property
    def seconds_open(self) -> float:
        return self.t1 - self.t0
