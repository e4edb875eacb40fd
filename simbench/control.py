"""The controls: the plain reference put in the program's place with one of
the configuration's guarantees broken, judged by the same comparison as a
run.  The benchmark's runs never run this; it shows that the comparison
fails what it must fail.

Each system's reference names its controls (``CONTROLS``); those of
``kv``: a store that acknowledges updates and loses them
(``lost_writes``), and scans that count the keys of their first page only
(``first_page_scans``, in cells whose traffic scans).

    python3 simbench/control.py --workload kv16k.ycsb-e --ops 95000 --seeds 1 2 3

``--ops`` is the number of window ops a run of the cell executes (its
``ops_per_s`` times ``run_seconds``), so that the control is judged at the
cell's own size.  Prints each control's compared numbers on each seed
and whether it came out correct (none may).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def control_runs(bench: dict, cell_name: str, seed: int, ops: int,
                 overrides: dict | None = None) -> dict:
    """``{control: (correct, numbers)}`` on the cell's inputs, with ``ops``
    window ops executed after the warm-up, for each control of the cell's
    system that the run has answers for."""
    from simbench.runner import cell_inputs
    from simbench.yardstick import traffic as traffic_gen
    _, config, traffic = cell_inputs(bench, cell_name, overrides)
    reference = importlib.import_module(
        f"simbench.reference.{config['system']}")
    inputs = traffic_gen.make(config, traffic, seed)
    tail = getattr(inputs, "readback", np.zeros(0, np.int64))
    executed = {"warmup": np.arange(inputs.warmup),
                "window": np.arange(inputs.warmup,
                                    min(inputs.warmup + ops,
                                        inputs.n_stream)),
                "tail": np.asarray(tail, np.int64)}
    out = {}
    for name, (answers, applies) in reference.CONTROLS.items():
        if not applies(inputs, executed):
            continue
        got = answers(config, inputs, executed)
        numbers, _, _ = reference.check(config, inputs, executed, got)
        out[name] = (all(v <= lim for v, lim in numbers.values()), numbers)
    return out


def main(argv: list[str]) -> int:
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "simbench"]
    from simbench.runner import load_benchmark
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--ops", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    failed_all = True
    for seed in args.seeds:
        runs = control_runs(bench, args.workload, seed, args.ops)
        for name, (correct, numbers) in runs.items():
            failed_all &= not correct
            print(json.dumps({"workload": args.workload, "control": name,
                              "seed": seed, "ops": args.ops,
                              "correct": correct,
                              "numbers": {k: {"value": v, "limit": lim}
                                          for k, (v, lim)
                                          in numbers.items()}}),
                  flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
