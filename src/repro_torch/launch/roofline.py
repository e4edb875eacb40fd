"""Roofline terms of a traced step on the NVIDIA H100, and the card's peaks.

The counterpart of the JAX package's ``launch/roofline.py``, whose terms
come from a compiled TPU module and whose constants are a v5e's.  Here the
terms come from ``launch/trace_analysis.py``'s count of the ops the port
dispatches for one step, on the device it runs on, and the constants are
the H100 SXM's.  Three terms per step, all per device (a traced rank's
counts against one card's peaks):

    compute    = dot FLOPs / bf16 dense peak
    memory     = bytes accessed / HBM bandwidth
    collective = collective operand bytes / per-GPU network bandwidth

"Bytes accessed" is each op's operands plus its results: eager PyTorch
fuses nothing, so every op reads its operands from HBM and writes its
results there (a decode step's weight reads included, which the JAX
package's materialised-result proxy leaves out).

The card's peaks live in this module only: ``chip_smoke.py`` bounds each
kernel with them, and a step's roofline fraction reads against them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# H100 SXM, NVIDIA H100 Tensor Core GPU data sheet (dense, no sparsity), at
# the 700 W power limit.
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor-core FLOP/s
F32_FLOPS = 67e12            # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # bytes/s of HBM3
HBM_BYTES = 80e9             # the data sheet's 80 GB of HBM3
# 32-bit integer add, compare, logic and shift: 64 results per SM per clock
# for compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
# Instructions" throughput table) on 132 SMs at the 1.98 GHz boost clock.
# Integer multiplies are counted at the same rate.
INT32_OPS = 132 * 64 * 1.98e9
# Per-GPU bandwidth of the collectives: the 400 Gb/s NDR InfiniBand NIC
# that a DGX H100 gives each of its 8 GPUs (ConnectX-7, one per GPU; NVIDIA
# DGX H100 user guide), 50e9 bytes/s.  NVLink (450e9 bytes/s each way) joins
# only the 8 GPUs of a node: the production mesh's 16-wide axes span nodes,
# so every ring over one of them crosses the NIC.
NET_BW = 50e9

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def attention_pairs(sq: int, sk: int, *, causal: bool = True,
                    window: int | None = None,
                    q_offset: int | None = None) -> tuple[int, int]:
    """(visible (query, key) pairs, keys that some query sees) of one head's
    attention: query row i sits at ``q_offset + i`` (default ``Sk - Sq``)
    and sees key j < Sk when ``j <= q_offset + i`` (causal) and
    ``j > q_offset + i - window`` (window), the kernel's masks."""
    q_offset = sk - sq if q_offset is None else q_offset
    pos = q_offset + np.arange(sq, dtype=np.int64)
    lo = np.zeros(sq, np.int64) if window is None \
        else np.maximum(pos - window + 1, 0)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    seen = hi >= lo
    lo, hi = lo[seen], hi[seen]
    # both ends rise with the row, so a row's new keys start past the
    # highest key of the rows before it
    before = np.concatenate([[-1], np.maximum.accumulate(hi)[:-1]])
    new = np.maximum(hi - np.maximum(lo, before + 1) + 1, 0)
    return int((hi - lo + 1).sum()), int(new.sum())


def attention_flops(b: int, sq: int, sk: int, h: int, d: int, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int | None = None) -> int:
    """The useful FLOPs of one attention: the multiply-adds of QK^T and PV
    over the visible pairs, 4·B·H·D a pair."""
    pairs, _ = attention_pairs(sq, sk, causal=causal, window=window,
                               q_offset=q_offset)
    return 4 * b * h * d * pairs


@dataclasses.dataclass
class Roofline:
    flops: float               # dot FLOPs per device
    bytes_accessed: float      # operand + result bytes per device
    coll: dict                 # per-kind collective operand bytes
    n_devices: int
    result_bytes: float = 0.0  # the JAX package's memory proxy, for reference
    n_ops: int = 0
    peak_bytes: int = 0        # live device bytes at the trace's peak

    @property
    def collective_total(self) -> int:
        return sum(self.coll.values())

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_total / NET_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, model_flops_per_dev: float) -> float:
        """Achievable MFU bound: useful-FLOPs time / dominant-term time."""
        if self.bound_s == 0:
            return 0.0
        return (model_flops_per_dev / PEAK_FLOPS) / self.bound_s

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "bytes_per_dev": self.bytes_accessed,
            "result_bytes_per_dev": self.result_bytes,
            "collective_bytes_per_dev": self.coll,
            "n_ops": self.n_ops,
            "peak_bytes": self.peak_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "dominant": self.dominant,
        }


def analyze(counts, n_devices: int) -> Roofline:
    """Roofline terms from one rank's ``trace_analysis.TraceCounts``."""
    return Roofline(flops=counts.dot_flops,
                    bytes_accessed=counts.bytes_accessed,
                    coll={k: int(v)
                          for k, v in counts.collective_bytes.items()},
                    n_devices=n_devices, result_bytes=counts.result_bytes,
                    n_ops=counts.n_ops, peak_bytes=counts.peak_bytes)


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs for the cell (global, not per-device):
    6·N_active·tokens for training, 2·N_active·tokens for inference."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        per_tok = 6 * n
        tokens = shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        per_tok = 2 * n
        tokens = shape.global_batch * shape.seq_len
    else:                                  # decode: one token per sequence
        per_tok = 2 * n
        tokens = shape.global_batch
    return per_tok * tokens
