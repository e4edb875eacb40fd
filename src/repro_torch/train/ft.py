"""Fault tolerance: straggler watchdog + failure injection hooks.

At 1000+ nodes the common failures are (a) a slow chip/host dragging every
synchronous step (stragglers), (b) hard node loss.  The framework handles
them with:

  * StragglerWatchdog — per-step wall-time tracking against a rolling
    median; a step slower than ``threshold x median`` raises a flag the
    training loop acts on (log, re-dispatch, or — with a real fleet — hot-spare
    swap).  In the tests the "straggler" is simulated by injecting sleep
    into a step.
  * checkpoint/restart — launch/train.py checkpoints every N steps and
    resumes from the latest durable checkpoint after a crash; bitwise
    equality with an uninterrupted run is asserted in tests (deterministic
    data pipeline + stateless-by-step optimizer + deterministic kernels
    make this exact).

Pure Python, the JAX package's ``train/ft.py``; the step durations are
public (``durations``), which ``launch.train`` reports.
"""
from __future__ import annotations

import dataclasses
import statistics
import time


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float

    @property
    def slowdown(self) -> float:
        return self.duration_s / self.median_s if self.median_s else 0.0


class StragglerWatchdog:
    """Rolling-median step timer; flags steps slower than threshold x median."""

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 warmup_steps: int = 3):
        self.threshold = threshold
        self.window = window
        self.warmup_steps = warmup_steps
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> StragglerEvent | None:
        assert self._t0 is not None, "start_step not called"
        dur = time.perf_counter() - self._t0
        self._t0 = None
        history = self.durations[-self.window:]
        self.durations.append(dur)
        if len(history) < self.warmup_steps:
            return None
        med = statistics.median(history)
        if med > 0 and dur > self.threshold * med:
            ev = StragglerEvent(self._step, dur, med)
            self.events.append(ev)
            return ev
        return None


class FailureInjector:
    """Deterministic crash injection for restart tests: raises at a chosen
    step, once."""

    def __init__(self, crash_at_step: int | None = None):
        self.crash_at_step = crash_at_step
        self.fired = False

    def maybe_crash(self, step: int) -> None:
        if (self.crash_at_step is not None and not self.fired
                and step == self.crash_at_step):
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")
