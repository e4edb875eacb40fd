"""A kernel's share of its roofline, read from a ``--trace 1`` run.

A roofline metric's reader (``metrics/<kernel>_roofline.py``) describes its
kernel by a ``KERNEL`` spec.  The tracer wraps the spec's Python wrapper of
the kernel while the profiler runs and keeps, for each launch, what the
spec's ``record`` returns; it sums the kernel's device time in the trace
under ``trace_name``, and each recorded launch's frozen bound by the spec's
``bound``.  A roofline of another kernel is a new reader file with its
spec, and nothing else.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str              # the kernel, as its metric and the summary name it
    module: str            # module of the kernel's Python wrapper
    wrapper: str           # the wrapper's name there (and where imported)
    trace_name: str        # the kernel's function name in the device trace
    submit: str            # the backend call that queues a row of a launch
    record: Callable       # (rows, args, kw, out) -> what ``bound`` needs
    bound: Callable        # record -> (operations, bytes) of the launch
    # args of ``submit`` -> a key; the rows of a launch are then the
    # distinct keys queued since the last flush, not the calls
    row_key: Callable | None = None


def words(t) -> np.ndarray:
    """A small device tensor's values: int32 read as uint32 bit patterns."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def share(run, kernel: str) -> float | None:
    """The kernel's frozen bound over its device time, as a mean per launch,
    in percent; None where the trace holds no launch of it."""
    prof = run.profile
    if prof is None:
        return None
    bound_s, n_bound = prof["bounds"].get(kernel, (0.0, 0))
    dev_s, n_dev = prof["kernels"].get(kernel, (0.0, 0))
    if not (n_bound and n_dev and dev_s > 0):
        return None
    return 100.0 * (bound_s / n_bound) / (dev_s / n_dev)
