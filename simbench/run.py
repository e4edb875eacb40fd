"""Run one cell of the benchmark and print its result as the last line.

    python3 simbench/run.py --workload kv16k.ycsb-b --seed 7 --seconds 30 --trace 0

From the root of a checkout on a machine with a CUDA card.  See
``simbench/runner.py`` for what a run does and prints.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_age() -> float:
    """Seconds the process had run when this file began (10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE = process_age()
ROOT = Path(__file__).resolve().parents[1]
# Caches of what the program builds stay at fixed paths in the checkout;
# host threads are kept to one a pool, so that runs are steady.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "simbench_cache" / sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "simbench"]

from simbench.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0, AGE))
