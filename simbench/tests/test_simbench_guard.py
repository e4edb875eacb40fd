"""The check a run makes before it prints: no module of JAX or of the JAX
package is loaded, compared by whole top-level names."""
import os
import subprocess
import sys
from pathlib import Path

from simbench import guard

ROOT = Path(guard.__file__).resolve().parents[1]


def test_top_level_names_are_compared_whole():
    port = ["repro_torch", "repro_torch.backend.batched", "torch", "numpy"]
    assert guard.forbidden_modules(port) == []
    assert guard.forbidden_modules(port + ["repro.core.engine"]) == ["repro"]
    assert guard.forbidden_modules(["jaxlib.xla_client", "jax",
                                    "flax.linen"]) == ["flax", "jax",
                                                       "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys, torch, time\n"
            "from simbench.tests.sizes import run\n"
            "from simbench import guard\n"
            "line, _ = run('kv16k.ycsb-b', seconds=0.3, trace=True)\n"
            "line2, _ = run('kv16k.ycsb-e', seconds=0.3)\n"
            "assert line['correct'] and line2['correct']\n"
            "print(guard.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run([sys.executable, "simbench/run.py", "--workload",
                          "kv16k.ycsb-b", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
