# analysis: pretend-path=src/repro_torch/fixtures/sim008_tp.py
"""SIM008 true positives in the port's idiom: torch generators and draws
whose entropy never traces to a declared seed — including the
interprocedural case where the seed is a parameter and a call site passes
an unseeded value."""
import numpy as np
import torch


def no_entropy_at_all():
    return np.random.default_rng()          # unseeded-rng


def bare_generator(device):
    return torch.Generator(device=device)   # unseeded-rng: never seeded


def draw_on_global_rng(n):
    return torch.randint(0, 8, (n,))        # unseeded-rng: no generator=


def os_entropy_laundered():
    import time
    noise = time.time_ns()                  # not a seed: wall-clock entropy
    return torch.Generator().manual_seed(noise)     # untraced-rng


def _fixture_gen_from_knob(knob):
    # provenance depends on every caller: flagged via the call sites below
    return torch.Generator().manual_seed(knob)      # untraced-rng:knob


def passes_wallclock(clock):
    return _fixture_gen_from_knob(clock.tick())
