# analysis: pretend-path=src/repro_torch/fixtures/sim008_tn.py
"""SIM008 true negatives in the port's idiom: seeded torch generators,
draws through ``generator=``, and the numpy seeding idioms the port keeps."""
import numpy as np
import torch


def seeded_generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def draw_through_generator(seed, n):
    g = torch.Generator().manual_seed(seed ^ 0xD1CE)
    return torch.randint(0, 8, (n,), generator=g)


def literal_seed():
    return torch.Generator().manual_seed(1234)


def entropy_list_idiom(seed, qi, attempt):
    # one seeded component makes the mix deterministic given the seed
    return np.random.default_rng([seed, 0xB0FF, qi, attempt])


def _fixture_gen_from_key(key):
    # the parameter is proven seeded at every call site below
    return torch.Generator().manual_seed(key)


def all_sites_seeded(schedule):
    return _fixture_gen_from_key(schedule.seed)
