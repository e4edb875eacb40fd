"""Tiny sizes of every cell, for the CPU tests: the same code paths as the
card's runs, with the kernels' plain versions (``device="cpu"``)."""
import time

import torch

from simbench import runner

TINY = {
    "kv16k.ycsb-b": {"config": {"n_key_pages": 48},
                     "traffic": {"stream_ops": 12000, "warmup_ops": 150,
                                 "readback_keys": 48}},
    "kv16k.ycsb-e": {"config": {"n_key_pages": 48},
                     "traffic": {"stream_ops": 12000, "warmup_ops": 200,
                                 "readback_keys": 48}},
    "kv16k.ycsb-a": {"config": {"n_key_pages": 48},
                     "traffic": {"stream_ops": 12000, "warmup_ops": 80,
                                 "readback_keys": 48}},
}
CELLS = tuple(TINY)
SEED = 2**31 + 9


def run(cell: str, *, seconds: float = 0.6, trace: bool = False,
        seed: int = SEED):
    """One run of ``cell`` at its tiny size on the CPU: (line, numbers)."""
    return runner.run_cell(runner.load_benchmark(), cell, seed, seconds,
                           trace, torch.device("cpu"),
                           started=time.perf_counter(), overrides=TINY[cell])
