# analysis: pretend-path=src/repro_torch/backend/fixture_flush.py
"""SIM003 true negatives: host tail deferred, host values freely cast."""
import numpy as np
import torch

from repro_torch.kernels.layout import tensor_to_words


def sim_search(lo, hi, q, m):
    return lo


def _flush_searches(lo, hi, q, m, cmds):
    out = sim_search(lo, hi, q, m)
    n = int(len(cmds))              # host value: int() here is fine
    bitmap = np.asarray(cmds[0], np.uint32)
    k = int(bitmap.sum())           # host numpy: no device involved

    def tail(out=out):
        # nested def = deferred tail, runs after the flush returns
        return tensor_to_words(out)[:n], out.cpu().numpy()

    return tail, k


def resolve_burst(out):
    # not a hot-scope name: the drain path MAY sync
    torch.cuda.synchronize()
    return tensor_to_words(out)
