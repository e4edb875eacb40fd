"""Deterministic synthetic data pipeline.

Batches are a pure function of (seed, step): a crashed-and-restarted run
regenerates exactly the stream it would have seen, which is what makes the
bitwise-resume test meaningful.  The generator is a Markov-ish mixture so
the LM loss actually decreases (unlike uniform noise).  The numpy stream
is the JAX package's, draw for draw, so both packages train on the same
tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 64        # latent pattern count (learnable structure)


def batch_at_step(cfg: DataConfig, step: int, *, device=None) -> dict:
    """{tokens, labels}, int32 (B, S) tensors on ``device`` (the card by
    default), for one step — stateless in ``step``."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # each sequence follows one of n_patterns affine token recurrences
    pat = rng.integers(0, cfg.n_patterns, size=(b, 1))
    mult = 1 + 2 * (pat % 37)
    add = 7 + pat % 23
    t0 = rng.integers(0, v, size=(b, 1))
    idx = np.arange(s)[None, :]
    tokens = ((t0 + add * idx) * mult) % v
    noise = rng.random((b, s)) < 0.02
    tokens = np.where(noise, rng.integers(0, v, size=(b, s)), tokens)
    labels = np.roll(tokens, -1, axis=1).copy()
    labels[:, -1] = -1                       # IGNORE tail position
    device = resolve_device(device)
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(device)}


def batches(cfg: DataConfig, start_step: int = 0, *, device=None):
    step = start_step
    while True:
        yield step, batch_at_step(cfg, step, device=device)
        step += 1
