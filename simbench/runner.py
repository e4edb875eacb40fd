"""One run of one cell.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name in BENCHMARK.json:

* the configuration: its file (``configs/<name>.json``), whose ``system``
  names the driver of the program (``systems/<system>.py``) and the plain
  reference (``reference/<system>.py``);
* the traffic mix: ``traffic/<name>.json``, read by the one generator
  (``yardstick/traffic.py``, which finds the draw of the mix's ``kind``
  in ``yardstick/kinds/<kind>.py``);
* each metric: its reader, ``metrics/<name>.py``; a roofline's reader also
  names its kernel (``KERNEL``), which a traced run then records.

A run: draw the inputs from the seed, build the system (the bulk load),
make its pages resident, warm up on the stream's first ops (set-up, timed
from the process's start), measure for ``seconds``, read the device's peak
memory, collect the answers, free the program's state, check the answers
against the reference, and print the result as the last line of standard
output, with each compared number beside its limit as the last lines of
standard error.  With ``trace``, spans and launch records are taken around
the program's calls and the profiler runs over the window's last part; the
metrics are then the cell's per-layer ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from simbench import guard
from simbench.tracer import Tracer
from simbench.window import Window, host_probe_ms, sync
from simbench.yardstick import traffic as traffic_gen

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# The profiler's share of a traced window: its last quarter, at most 5 s.
PROFILE_SHARE, PROFILE_MAX_S = 0.25, 5.0


@dataclasses.dataclass
class Record:
    """What the metric readers read."""
    host_layer: str
    ops: int
    window_s: float
    latencies_s: np.ndarray
    setup_s: float
    span_ops: int = 0
    span_s: float = 0.0
    backend_s: float | None = None
    launches: dict | None = None
    profile: dict | None = None


def log(msg: str) -> None:
    print(f"[simbench] {msg}", file=sys.stderr, flush=True)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_module(name: str):
    """The reader of metric ``name``, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"simbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_specs(bench: dict, cell_name: str) -> list:
    """The kernels that the cell's per-layer metrics read launches of."""
    specs = (getattr(metric_module(m["name"]), "KERNEL", None)
             for m in bench["per_layer"] if applies(m, cell_name))
    return [k for k in specs if k is not None]


def cell_inputs(bench: dict, cell_name: str, overrides: dict | None = None):
    """The cell's entry, configuration and traffic mix, with ``overrides``
    (``{"config": {...}, "traffic": {...}}``) applied, as tests shrink them."""
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise SystemExit(f"unknown workload {cell_name!r}")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return cell, config, traffic


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, *, started: float,
             overrides: dict | None = None) -> tuple[dict, dict]:
    """Run the cell; return the result line and the compared numbers
    ``{name: (value, limit)}``.  ``started`` is the process's start on the
    ``time.perf_counter`` clock."""
    cell, config, traffic = cell_inputs(bench, cell_name, overrides)
    system = importlib.import_module(f"simbench.systems.{config['system']}")
    reference = importlib.import_module(
        f"simbench.reference.{config['system']}")
    t = time.perf_counter()
    inputs = traffic_gen.make(config, traffic, seed)
    stages = {"inputs_s": time.perf_counter() - t}
    t = time.perf_counter()
    sut = system.System(config, inputs, device)
    sync(device)
    stages["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sut.warm_up()
    stages["warmup_s"] = time.perf_counter() - t
    tracer = (Tracer(device, sut.host_layer, kernel_specs(bench, cell_name))
              if trace else None)
    sync(device)
    probe_ms = [host_probe_ms()]
    setup_s = time.perf_counter() - started
    log(f"{cell_name} seed {seed}: set-up {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + ")")

    from repro_torch.kernels import native
    launches0 = dict(native.LAUNCHES)
    win = Window(seconds, device, tracer,
                 min(PROFILE_MAX_S, seconds * PROFILE_SHARE))
    error = None
    if tracer is not None:
        tracer.install(sut.backend)
    try:
        n_ops, lat = sut.window(win)
    except Exception:                       # the program failed in the window
        error = traceback.format_exc()
        n_ops, lat = 0, np.zeros(0)
    finally:
        if tracer is not None:
            tracer.end_profile()
            tracer.uninstall()
    launches = {k: native.LAUNCHES[k] - launches0.get(k, 0)
                for k in native.LAUNCHES}
    probe_ms.append(host_probe_ms())
    log(f"host probe (a fixed pure-Python loop, ms): {probe_ms[0]:.3f} "
        f"before the window, {probe_ms[1]:.3f} after it")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    record = Record(host_layer=sut.host_layer, ops=n_ops,
                    window_s=win.seconds_open, latencies_s=lat,
                    setup_s=setup_s, launches=launches)
    if tracer is not None:
        record.span_ops, record.span_s = win.span_ops or 0, win.span_s
        record.backend_s = tracer.backend_s
        record.profile = tracer.summary()
    counters = sut.counters

    numbers, failed, compared = {}, n_ops, {}
    if error is None:
        try:
            executed, got = sut.results()
            del sut
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            numbers, failed, compared = reference.check(config, inputs,
                                                        executed, got)
        except Exception:                   # the answers could not be read
            error = traceback.format_exc()
    if error is not None:
        log(f"the run failed:\n{error}")
    correct = (error is None and bool(numbers)
               and all(v <= lim for v, lim in numbers.values()))

    _report(record, counters, tracer, compared, n_ops, win.cpu_s)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[group]:
        if applies(m, cell_name):
            value = metric_module(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": n_ops,
            "failed": int(failed) if error is None else max(n_ops, 1),
            "metrics": metrics, "device": dev}
    if record.profile is not None:
        dev["busy_s"] = record.profile["busy_s"]
        dev["window_s"] = record.profile["window_s"]
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in record.profile["device_ops"]],
            "idle_gaps": [[n, s] for n, s in record.profile["idle_gaps"]]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()}
    _keep(cell_name, trace, line, counters, compared, probe_ms)
    return line, numbers


def _report(record: Record, counters: dict, tracer, compared: dict,
            n_ops: int, cpu_s: float) -> None:
    """The earlier lines: what the window did, per op, and what was traced."""
    per = max(n_ops, 1)
    log(f"window: {n_ops} ops in {record.window_s:.6f} s; launches "
        f"{record.launches}")
    log(f"the process used {cpu_s:.3f} CPU s in the window")
    log("counters over the window: " + ", ".join(
        f"{k} {v}" for k, v in counters.items() if v))
    for k in ("staged_bytes", "result_bytes"):
        if k in counters:
            log(f"{k} per op {counters[k] / per:.3f}")
    log(f"compared: {compared}")
    if tracer is not None:
        log(f"spans: {record.span_ops} ops in {record.span_s:.6f} s before "
            f"the profiler; backend {record.backend_s:.6f} s; by call "
            + ", ".join(f"{k} {tracer.calls[k]} calls {v:.6f} s"
                        for k, v in tracer.call_s.most_common()))
        if record.profile is not None:
            p = record.profile
            traced = n_ops - record.span_ops
            log(f"profiled {p['window_s']:.6f} s, {traced} ops "
                f"({traced / max(p['window_s'], 1e-9):.1f} ops/s; before it "
                f"{record.span_ops / max(record.span_s, 1e-9):.1f}), device "
                f"busy {p['busy_s']:.6f} s; kernels {p['kernels']}; bounds "
                f"{p['bounds']}; device events {tracer.device_kinds}, first "
                f"and last against the window's edges (us) {tracer.edges_us}")


def _keep(cell: str, trace: bool, line: dict, counters: dict,
          compared: dict, probe_ms: list) -> None:
    """The run's numbers, also in a small file in the checkout."""
    out = ROOT / "build" / "simbench"
    try:
        out.mkdir(parents=True, exist_ok=True)
        with open(out / f"{cell}.trace{int(trace)}.json", "w") as f:
            json.dump({"line": line, "counters": counters,
                       "compared": compared, "host_probe_ms": probe_ms}, f,
                      indent=1, default=str)
    except OSError as e:
        log(f"could not keep the run's numbers: {e}")


def main(argv: list[str], started: float, age: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell, _, _ = cell_inputs(bench, args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and does not "
            "fall back to the CPU")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{cell['name']} asks for {cell['chips']} cards; "
            f"{torch.cuda.device_count()} present")
        return 2
    line, numbers = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             started=started - age)
    found = guard.forbidden_modules()
    if found:
        log(f"the run loaded {found}: nothing it runs may import JAX or the "
            "JAX package")
        return 3
    for name, (value, limit) in numbers.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
