"""flash_attention_roofline: the frozen bound of the attention kernel's
launches recorded while the profiler ran over their device time in the
trace, as a mean per launch, in percent.

A launch's bound is ``chip_smoke.attn_bound``'s as it stood when the
metric was defined: the multiply-adds of the visible (query, key) pairs of
QK^T and PV (4 B H D a pair) at the dtype's peak, against q and the output
once, the k/v rows some row sees once and, with the log-sum-exp output, its
float32 rows; the larger of the two times.  The launch is recorded where
the kernel's wrapper runs it (``ops._run``), which every call reaches
whatever attention function its caller bound.
"""
import numpy as np

from simbench.roofline import KernelSpec, share
from simbench.yardstick import bounds

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core and float32 (outside
# the tensor cores) FLOP/s, as the program's ``launch/roofline.py``.
BF16_FLOPS, F32_FLOPS = 989e12, 67e12


def attention_pairs(sq, sk, causal, window, q_offset):
    """(visible (query, key) pairs, keys some query sees) of one head:
    query row i at ``q_offset + i`` sees key j < sk when j <= q_offset + i
    (causal) and j > q_offset + i - window (window)."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.zeros(sq, np.int64) if window is None \
        else np.maximum(pos - window + 1, 0)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    seen = hi >= lo
    lo, hi = lo[seen], hi[seen]
    before = np.concatenate([[-1], np.maximum.accumulate(hi)[:-1]])
    new = np.maximum(hi - np.maximum(lo, before + 1) + 1, 0)
    return int((hi - lo + 1).sum()), int(new.sum())


def attn_work(rec):
    """(flops, bytes, the dtype's peak) of one recorded launch."""
    es, (b, sq, sk, h, hkv, d), causal, window, q_offset, lse = rec
    pairs, seen = attention_pairs(sq, sk, causal, window, q_offset)
    flops = 4 * b * h * d * pairs
    nbytes = es * (2 * b * h * sq * d + 2 * b * hkv * seen * d) \
        + (4 * b * sq * h if lse else 0)
    return flops, nbytes, BF16_FLOPS if es == 2 else F32_FLOPS


def _bound(rec):
    # the tracer holds (operations, bytes) to yardstick/bounds.py's integer
    # peak: the FLOPs are given in that peak's units
    flops, nbytes, peak = attn_work(rec)
    return flops * bounds.INT32_OPS / peak, nbytes


def _record(rows, args, kw, out):
    q, k, _, causal, window, _, q_offset, lse = args[:8]
    b, sq, h, d = q.shape
    return (q.element_size(), (b, sq, k.shape[1], h, k.shape[2], d),
            bool(causal), window or None, int(q_offset), lse is not None)


KERNEL = KernelSpec(
    name="flash_attention", module="repro_torch.kernels.flash_attention.ops",
    wrapper="_run", trace_name="attn_kernel", submit="submit_attention",
    record=_record, bound=_bound)


def read(run):
    return share(run, KERNEL.name)
