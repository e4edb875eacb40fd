"""Arrival processes: when each workload op reaches the frontend.

The serial replay has no notion of time — op ``qi`` executes when op
``qi - 1`` finishes.  The event frontend turns the same op stream into
*requests*: op ``qi`` belongs to client stream ``qi % concurrency`` and
arrives at a simulated timestamp drawn from the configured process:

  * ``zero``    — everything arrives at t=0 (closed backlog; with one
                  stream and FIFO this is the serial-parity anchor);
  * ``poisson`` — each stream is an independent Poisson process, the N
                  streams splitting ``arrival_rate_qps`` evenly; stream s
                  draws from ``default_rng([seed, s])`` so runs are
                  deterministic and streams are decorrelated;
  * ``trace``   — explicit per-op times from ``config.arrival_times_ns``
                  (the hypothesis NCQ-bound property and the crafted
                  program-backlog test drive this).

Within a stream, ops keep their workload order only if the times say so —
a trace may interleave arbitrarily; determinism, not ordering, is the
contract here.
"""
from __future__ import annotations

import numpy as np

from .config import RunConfig


def arrival_times(config: RunConfig,
                  n_ops: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-op (arrival_time_ns, stream_id) arrays for one workload."""
    streams = np.arange(n_ops, dtype=np.int64) % config.concurrency
    if config.arrival == "zero":
        return np.zeros(n_ops, dtype=np.float64), streams
    if config.arrival == "trace":
        times = np.asarray(config.arrival_times_ns, dtype=np.float64)
        if len(times) != n_ops:
            raise ValueError(
                f"arrival_times_ns has {len(times)} entries for "
                f"{n_ops} workload ops")
        return times, streams
    # Poisson: exponential inter-arrivals per stream, offered load split
    # evenly so the aggregate process is Poisson(arrival_rate_qps).
    mean_ns = 1e9 * config.concurrency / config.arrival_rate_qps
    times = np.zeros(n_ops, dtype=np.float64)
    for s in range(config.concurrency):
        idx = np.nonzero(streams == s)[0]
        if not len(idx):
            continue
        rng = np.random.default_rng([config.seed, s])
        times[idx] = np.cumsum(rng.exponential(mean_ns, size=len(idx)))
    return times, streams
