# analysis: pretend-path=src/repro_torch/backend/fixture_flush.py
"""SIM003 true positives: host syncs on launch outputs inside the flush."""
import torch

from repro_torch.kernels.layout import tensor_to_words


def sim_search(lo, hi, q, m):
    return lo


def _flush_searches(lo, hi, q, m):
    out = sim_search(lo, hi, q, m)
    host = out.cpu()                # device->host copy at flush time
    words = tensor_to_words(out)    # the same copy through the layout helper
    total = out[0, 0].item()        # blocking scalar sync at flush time
    torch.cuda.synchronize()        # explicit barrier in the hot path
    return host, words, total


def _flush_plans(n):
    flags = torch.zeros(n, dtype=torch.int32)   # torch.* builds a device value
    first = int(flags[0])           # a cast is a blocking sync
    return first, flags.tolist(), flags.numpy()
