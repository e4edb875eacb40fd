"""Readings behind the ``lm`` cell's correctness limits
(``simbench/reference/lm.py``), on the card.

    python3 scripts/lm_check_readings.py --seed 7 --seconds 20
    python3 scripts/lm_check_readings.py --seed 7 --seconds 20 --control global-ring

Without ``--control``: one run of ``hymba-1.5b-base.chat-long`` as the
benchmark makes it (set-up, a window of ``--seconds``), then for every
served sequence the reference's float32 logits and its witness runs, and

* the check's own numbers and how long the check took;
* each step's distance from the float32 reference and the witness spread
  (quantiles), and the steps beyond the limit with every witness run and
  with the first two only;
* the same limits applied to the reference computed with float8 (e4m3)
  products, a precision below the configuration's bf16: the reading that
  must fail.

``--control global-ring``: the same with the global layers' caches on
rings of the window's slots (the paper-table layout), which the check
must refuse.  Prints a JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from simbench import runner  # noqa: E402
from simbench.reference import lm as reference  # noqa: E402
from simbench.window import Window, sync  # noqa: E402
from simbench.yardstick import traffic as traffic_gen  # noqa: E402

CELL = "hymba-1.5b-base.chat-long"


def quantiles(xs):
    q = statistics.quantiles(xs, n=20) if len(xs) > 1 else xs * 19
    return {"min": min(xs), "p25": q[4], "median": statistics.median(xs),
            "p75": q[14], "p95": q[18], "max": max(xs)}


def readings(seed: int, seconds: float, device=None,
             overrides: dict | None = None) -> dict:
    bench = runner.load_benchmark()
    _, config, mix = runner.cell_inputs(bench, CELL, overrides)
    system = runner.importlib.import_module("simbench.systems.lm")
    dev = torch.device("cuda", 0) if device is None else device
    inputs = traffic_gen.make(config, mix, seed)
    sut = system.System(config, inputs, dev)
    sut.warm_up()
    win = Window(seconds, dev)
    n_ops, _ = sut.window(win)
    executed, got = sut.results()
    del sut
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, failed, compared = reference.check(config, inputs, executed,
                                                got)
    check_s = time.perf_counter() - t

    weights = inputs.weights
    rel, rel8, spread, spread3, per_seq = [], [], [], [], []
    for seq, logits in zip(executed["sequences"], got["logits"]):
        n = len(seq["served"])
        if not n:
            continue
        feed = list(seq["prompt"]) + list(seq["served"][:-1])
        runs = reference.Witness(weights["embed"])
        t0 = time.perf_counter()
        refs = reference.forward_runs(config, weights, feed, n, runs)
        sync(dev)
        t1 = time.perf_counter()
        low = reference.forward(config, weights, feed, n,
                                products=reference._float8)
        sync(dev)
        t2 = time.perf_counter()
        r = reference._rel(logits.to(refs.device), refs[0]).tolist()
        r8 = reference._rel(low, refs[0]).tolist()
        pairs = [(ai, bi, reference._rel(refs[ai], refs[bi]).tolist())
                 for ai in range(runs.n) for bi in range(ai + 1, runs.n)]
        sp = [max(p[i] for _, _, p in pairs) for i in range(n)]
        rel, rel8, spread = rel + r, rel8 + r8, spread + sp
        spread3 += [max(p[i] for a, b, p in pairs if b < 3)
                    for i in range(n)]
        def excess(xs):         # the check's per-step statistic
            return reference._median(
                [0.0 if x <= reference.STEP_TOL else x / s
                 for x, s in zip(xs, sp)])

        per_seq.append({
            "prompt": len(seq["prompt"]), "steps": n,
            "rel_median": statistics.median(r),
            "excess_median": excess(r), "float8_excess_median": excess(r8),
            "runs_s": t1 - t0, "float8_s": t2 - t1})

    def beyond(xs, sp):
        return sum(x > reference.STEP_TOL and x > reference.WITNESS_FACTOR * s
                   for x, s in zip(xs, sp))

    return {"seed": seed, "window_ops": n_ops, "check_s": check_s,
            "numbers": numbers, "failed": failed, "compared": compared,
            "rel": quantiles(rel), "spread": quantiles(spread),
            "ratio": quantiles([x / s for x, s in zip(rel, spread)]),
            "beyond_all_witnesses": beyond(rel, spread),
            "beyond_two_witnesses": beyond(rel, spread3),
            "float8": {"rel": quantiles(rel8),
                       "beyond": beyond(rel8, spread),
                       "steps": len(rel8)},
            "sequences": per_seq}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", choices=("none", "global-ring"),
                    default="none")
    args = ap.parse_args(argv)
    if args.control == "global-ring":
        from repro_torch.models import hymba
        hymba.RING_KINDS = ("window", "global")
    out = readings(args.seed, args.seconds)
    print(json.dumps(dict(out, control=args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
