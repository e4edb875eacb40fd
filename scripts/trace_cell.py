"""Trace one benchmark cell with the program's own spans on.

    python3 scripts/trace_cell.py --workload kv16k.ycsb-b --seed 7 --seconds 51

Runs the cell as ``simbench/run.py --trace 1`` does (``simbench.runner.
run_cell``, the same tracer and profiler), and besides switches on the
program's spans (``repro_torch.spans``) when the tracer installs: their
aggregates over the ops before the profiler starts, full records while it
runs.  Prints, as the last line, JSON with the run's result line and:

* ``per_op``: each span's total and self time per op (us), and the readings
  a benchmark reader would take from them (``readings``);
* ``copies``: ``kernels/layout.COPIES`` over those ops, per op;
* ``row_passes``: ``core/ecc.ROW_PASSES`` over those ops, per op (the
  branch each row CRC pass took);
* ``launches``: ``kernels/native.LAUNCHES`` over those ops, per op (in an
  LM cell per token: the mamba kernels' beside the attention kernel's);
* ``inside_outside``: the top-level backend spans' time (``backend.flush``,
  ``backend.tail``, ``backend.program``) over the benchmark's own backend
  time from its wrappers;
* ``clock``: the span clock mapped onto the trace's host clock, calibrated
  from CUPTI's ``cudaLaunchKernel`` calls inside the ``kernel.launch``
  spans where the trace has them (else the tracer's ``time_ns``/
  ``perf_counter`` pair), and the trace's device clock onto its host
  clock (``spans.device_drift``); checked: SiM kernels that start before
  the launch span that issued them, with and without the device clock's
  correction and under the tracer's pair, and the median lag from a
  launch span's start to its kernel's;
* ``idle_gaps``: the profiled window's device idle gaps divided among the
  innermost program spans over them (``client``: in none).

``--alternate N`` measures what the spans cost instead: after one set-up,
2N untraced windows of ``--seconds`` each over the same ops, spans off and
on in turns (off, on, on, off, ...) after one more that is not counted,
and the rate of each.  ``--tiny`` runs the cell at the CPU tests' size on the CPU (a
rehearsal: no device numbers).  Each run also writes its JSON under
``chiprun_out/trace_cell/``.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import ecc  # noqa: E402
from repro_torch.kernels import layout, native  # noqa: E402
from simbench import runner  # noqa: E402
from simbench.tracer import Tracer  # noqa: E402
from simbench.window import Window  # noqa: E402

TOP_BACKEND = ("backend.flush", "backend.tail", "backend.program")


class SpanWindow(Window):
    last = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        SpanWindow.last = self


class SpanTracer(Tracer):
    """The benchmark's tracer, with the program's spans switched on at
    ``install``, snapshotted at ``begin_profile`` and off at
    ``uninstall``; keeps the idle gaps it labels."""
    last = None

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        SpanTracer.last = self
        self.gaps = []
        self.before = {}
        self.copies = {}
        self.row_passes = {}
        self.kernel_launches = {}

    def install(self, backend) -> None:
        super().install(backend)
        spans.reset()
        self.copies0 = dict(layout.COPIES)
        self.passes0 = dict(ecc.ROW_PASSES)
        self.launches0 = dict(native.LAUNCHES)
        spans.enable()

    def begin_profile(self) -> None:
        self.before = spans.totals()
        self.copies = {k: v - self.copies0[k]
                       for k, v in layout.COPIES.items()}
        self.row_passes = {k: v - self.passes0[k]
                           for k, v in ecc.ROW_PASSES.items()}
        self.kernel_launches = {k: v - self.launches0[k]
                                for k, v in native.LAUNCHES.items()}
        super().begin_profile()
        spans.mark()

    def uninstall(self) -> None:
        spans.disable()
        super().uninstall()

    def _label_gaps(self, gaps, w0_ns):
        self.gaps = [(g0, g1) for g0, g1 in gaps if g1 > g0]
        return super()._label_gaps(gaps, w0_ns)


def analyse(tracer: SpanTracer, win: Window) -> dict:
    ops = max(win.span_ops or 0, 1)
    before = tracer.before
    per_op = {k: {"total_us": v[1] / ops * 1e-3, "self_us": v[2] / ops * 1e-3,
                  "count": v[0]} for k, v in sorted(before.items())}

    def total(name):
        return before.get(name, (0, 0, 0))[1]
    wait = before.get(spans.RESULT_WAIT)
    readings = {
        "frontend.self_us_per_op": sum(
            v[2] for k, v in before.items() if k.startswith("frontend."))
        / ops * 1e-3,
        "backend.stage_us_per_op": total("backend.flush.stage") / ops * 1e-3,
        "backend.tail_us_per_op": total("backend.tail") / ops * 1e-3,
        "backend.result_wait_us": (wait[1] / wait[0] * 1e-3 if wait and wait[0]
                                   else None),
        "chip.program_us_per_op": total("chip.program") / ops * 1e-3,
        "backend.copies_per_op": (tracer.copies["h2d"] + tracer.copies["d2h"])
        / ops,
    }
    inside = sum(total(n) for n in TOP_BACKEND) * 1e-9
    out = {"span_ops": win.span_ops, "span_s": win.span_s,
           "readings": readings, "per_op": per_op,
           "copies": {k: v / ops for k, v in tracer.copies.items()},
           "row_passes": {k: v / ops for k, v in tracer.row_passes.items()},
           "launches": {k: v / ops
                        for k, v in tracer.kernel_launches.items()},
           "inside_outside": (inside / tracer.backend_s
                              if tracer.backend_s else None),
           "backend_s": tracer.backend_s, "inside_s": inside}
    if tracer.prof is None:
        return out
    recs = spans.records()
    kernels, runtime = spans.trace_launches(
        tracer.prof.profiler.kineto_results.events())
    pairs = spans.launch_pairs(recs, kernels, native.TRACE_NAMES)
    pair_off = tracer._wall0 - round(tracer._perf0 * 1e9)
    clock = {"records": len(recs), "runtime_launches": len(runtime),
             "launch_spans": sum(r.name == "kernel.launch" for r in recs),
             "sim_kernels": sum(spans.named(k[0], native.TRACE_NAMES)
                                for k in kernels),
             "pair_offset_ns": pair_off}
    offset, drift = pair_off, None
    if pairs is not None:
        cal = spans.clock_offset(pairs, runtime)
        if cal is not None:
            offset = cal[0]
            clock.update(calibrated_offset_ns=cal[0], bounds_width_ns=cal[1],
                         pair_vs_calibrated_us=(pair_off - cal[0]) * 1e-3)
        drift = spans.device_drift(pairs, runtime)
        if drift is not None:
            clock.update(device_ahead_us=drift[1] * 1e-3,
                         device_drift_ppm=drift[2] * 1e6)
        v_pair, _ = spans.check_launches(pairs, pair_off)
        v_raw, lag_raw = spans.check_launches(pairs, offset)
        v, lag = spans.check_launches(pairs, offset, drift)
        clock.update(violations=v, violations_uncorrected=v_raw,
                     violations_time_ns_pair=v_pair,
                     median_launch_to_start_us=(None if lag is None
                                                else lag * 1e-3),
                     median_launch_to_start_uncorrected_us=(
                         None if lag_raw is None else lag_raw * 1e-3))
        # On the trace's own clock: the kernel's start less its launch
        # call's, over the window in fifths (a device clock that drifts
        # from the host's shows here).
        skew = [(k[1] - runtime[k[2]][0]) * 1e-3 for _, k in pairs
                if k[2] in runtime]
        if skew:
            q = statistics.quantiles(skew, n=10) if len(skew) > 1 else skew
            fifth = max(len(skew) // 5, 1)
            clock.update(
                call_to_start_us={"min": min(skew), "p10": q[0],
                                  "median": statistics.median(skew),
                                  "p90": q[-1], "max": max(skew),
                                  "negative": sum(x < 0 for x in skew)},
                call_to_start_by_fifth_us=[
                    statistics.median(skew[i:i + fifth])
                    for i in range(0, len(skew), fifth)][:5])
    out["clock"] = clock
    pieces = spans.innermost(recs)
    by = spans.split([(spans.on_host(g0, drift) - offset,
                       spans.on_host(g1, drift) - offset)
                      for g0, g1 in tracer.gaps], pieces)
    out["idle_gaps"] = [[k, v * 1e-9] for k, v in by.most_common()]
    out["idle_gaps_s"] = sum(g1 - g0 for g0, g1 in tracer.gaps) * 1e-9
    out["records_by_name"] = dict(collections.Counter(r.name for r in recs))
    return out


def alternate(args, device, overrides) -> int:
    """Rates of untraced windows over the same ops, spans off and on in
    turns."""
    import importlib
    from simbench.yardstick import traffic
    _, config, mix = runner.cell_inputs(runner.load_benchmark(),
                                        args.workload, overrides)
    system = importlib.import_module(f"simbench.systems.{config['system']}")
    sut = system.System(config, traffic.make(config, mix, args.seed), device)
    sut.warm_up()
    sut.window(Window(args.seconds, device))     # settles; not counted
    rates = {False: [], True: []}
    for i in range(2 * args.alternate):
        on = i % 4 in (1, 2)
        spans.reset()
        if on:
            spans.enable()
        win = Window(args.seconds, device)
        n, _ = sut.window(win)
        spans.disable()
        rates[on].append(n / win.seconds_open)
        print(f"window {i} spans {'on' if on else 'off'}: "
              f"{rates[on][-1]:.2f} ops/s", file=sys.stderr, flush=True)
    pairs = [1 - a / b for a, b in zip(rates[True], rates[False])]
    result = {"workload": args.workload, "seed": args.seed,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "rates_off": rates[False], "rates_on": rates[True],
              "on_cost_by_pair": pairs,
              "on_cost": 1 - sum(rates[True]) / sum(rates[False])}
    out = ROOT / "chiprun_out" / "trace_cell"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{args.workload}.{args.seed}.alternate.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--alternate", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    overrides = None
    if args.tiny:
        from simbench.tests.sizes import TINY
        overrides, device = TINY[args.workload], torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("no CUDA device (use --tiny for a CPU rehearsal)",
              file=sys.stderr)
        return 2
    if args.alternate:
        return alternate(args, device, overrides)
    runner.Tracer, runner.Window = SpanTracer, SpanWindow
    line, _ = runner.run_cell(runner.load_benchmark(), args.workload,
                              args.seed, args.seconds, True, device,
                              started=T0, overrides=overrides)
    result = {"workload": args.workload, "seed": args.seed, "line": line,
              **analyse(SpanTracer.last, SpanWindow.last)}
    out = ROOT / "chiprun_out" / "trace_cell"
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{args.workload}.{args.seed}.json", "w") as f:
        json.dump(result, f, indent=1, default=str)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
