"""BENCHMARK.json and the harness's files keep to the benchmark's contract:
names, units, sizes, the files each entry names, and that a cell, a mix
or a metric is found by name."""
import ast
import json
import re
from pathlib import Path

import pytest

from simbench import runner

ROOT = Path(runner.__file__).resolve().parents[1]
BENCH = runner.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves"}}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["simbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    need = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("simbench/") and c["file"] not in files
        files.add(c["file"])
        config = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(config["reduced"])
        assert (ROOT / "simbench/systems" / f"{config['system']}.py").exists()
        assert (ROOT / "simbench/reference"
                / f"{config['system']}.py").exists()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in cells}
    assert len(pairs) == len(cells)
    configs = {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"]) and one_line(w["why"])
        assert (ROOT / "simbench/traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH[group]) <= (16 if group == "end_to_end" else 128)
    for m in BENCH[group]:
        assert set(m) - {"workloads"} == METRIC_KEYS[group]
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        assert (ROOT / "simbench/metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert one_line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert "setup_s" in e2e


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in BENCH["end_to_end"]
               if runner.applies(m, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in BENCH["per_layer"]
                  if runner.applies(m, w["name"])]
        assert layers and all(runner.applies(
            next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"]),
            w["name"]) for m in layers)


def test_files_are_named_from_name_characters():
    for p in (ROOT / "simbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_harness_file_imports_jax_or_the_jax_package():
    for p in (ROOT / "simbench").rglob("*.py"):
        if "tests" in p.relative_to(ROOT / "simbench").parts:
            continue
        assert not _imports(p) & {"jax", "jaxlib", "flax", "repro"}, p
        assert "benchmarks/" not in p.read_text(), p


def test_references_import_nothing_of_the_program():
    for p in (ROOT / "simbench/reference").glob("*.py"):
        assert not _imports(p) & {"repro_torch", "repro", "torch"}, p
