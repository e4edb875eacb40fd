"""Each cell end to end at a tiny size on the CPU, against the reference."""
import json

import pytest

from simbench import runner
from simbench.tests.sizes import CELLS, run

BENCH = runner.load_benchmark()


def metrics_of(cell: str, group: str) -> set:
    return {m["name"] for m in BENCH[group] if runner.applies(m, cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_is_correct_and_reports_end_to_end(cell):
    line, numbers = run(cell)
    assert line["correct"], line
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == metrics_of(cell, "end_to_end")
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert list(line)[-1] == "checks"
    assert {k: (v["value"], v["limit"]) for k, v in
            line["checks"].items()} == numbers
    assert all(v == 0 and lim == 0 for v, lim in numbers.values())
    assert line["device"]["platform"] == "cpu"
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_host_layers(cell):
    line, _ = run(cell, seconds=1.0, trace=True)
    assert line["correct"], line
    host = {"client.ops_per_s", "frontend.host_us_per_op",
            "backend.host_us_per_op", "backend.launches_per_op"}
    want = metrics_of(cell, "per_layer") & host
    assert set(line["metrics"]) == want
    assert line["metrics"]["backend.host_us_per_op"]["value"] > 0
    # No card: no device metric is written from a CPU run.
    assert not any(k.endswith("_roofline") or k.startswith("device.")
                   for k in line["metrics"])
    assert line["device"]["window_s"] > 0
    assert "breakdown" in line and list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_seed_gives_the_same_answers(cell):
    from simbench.runner import cell_inputs
    from simbench.tests.sizes import TINY
    from simbench.yardstick import traffic
    _, config, mix = cell_inputs(BENCH, cell, TINY[cell])
    a, b = (traffic.make(config, mix, 2**31 + 77) for _ in range(2))
    c = traffic.make(config, mix, 2**31 + 78)
    for name in ("ops", "keys"):
        assert (getattr(a, name) == getattr(b, name)).all()
        assert not (getattr(a, name) == getattr(c, name)).all()


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_records_the_kernels_its_rooflines_read(cell):
    specs = runner.kernel_specs(BENCH, cell)
    rooflines = {m["name"] for m in BENCH["per_layer"]
                 if runner.applies(m, cell) and m["name"].endswith(
                     "_roofline")}
    assert {f"{k.name}_roofline" for k in specs} == rooflines
