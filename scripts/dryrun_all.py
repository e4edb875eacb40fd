"""The dry run of every (arch x shape x mesh) cell, in parallel processes,
and its table.

    PYTHONPATH=src python3 scripts/dryrun_all.py [--jobs 8] [--limit 1800] [--shape train_4k]
    PYTHONPATH=src python3 scripts/dryrun_all.py --cell hymba-1.5b:train_4k

Each cell is one ``python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M`` process, at most ``--jobs`` at once, the longest traces first
(the recurrent families' Python loops over the sequence); a cell that has
not finished in ``--limit`` seconds is killed and listed as not traced.
Reports land in ``experiments/dryrun_torch/``; the table (markdown, one
line an arch x shape, the single-pod mesh's value before the multi-pod
one's) goes to standard output; ``--table-only`` prints it from the
reports already there; ``--shape`` (repeatable) keeps those shapes' cells
and rows only, and ``--cell ARCH:SHAPE`` (repeatable) adds one arch's
cell of another shape (both meshes).  The numbers are computed from the
traced program with the H100's peaks (``repro_torch.launch.roofline``),
not measured.  Needs
no card; a full-size training trace holds its whole autograd graph in
host memory, so run it where the host has room.
"""
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch.dryrun import OUT_DIR  # noqa: E402

# The cells whose traces run longest: every step of a Python recurrence.
SLOW = ("xlstm-350m", "hymba-1.5b")


def run(cell, limit: float) -> None:
    """Trace one cell in a process of its own; a cell killed at ``limit``
    gets a report saying so."""
    arch, shape, mesh = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=limit)
    except subprocess.TimeoutExpired:
        (OUT_DIR / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(
            {"arch": arch, "shape": shape, "mesh": mesh,
             "status": f"not traced in {limit:.0f} s"}))


def _pair(reps, fn) -> str:
    return "; ".join(fn(r) for r in reps)


def row(arch: str, shape: str, reps: list) -> str:
    """One arch x shape line, the single-pod mesh's value first."""
    head = f"| {arch} | {shape} |"
    if any(r is None for r in reps):
        return head + " no report |" + " |" * 7
    if any(r.get("status") != "ok" for r in reps):
        return head + " " + _pair(reps, lambda r: r["status"]) + " |" \
            + " |" * 7
    rl = [r["roofline"] for r in reps]
    return head + " " + " | ".join([
        _pair(rl, lambda x: f"{x['flops_per_dev']:.3g}"),
        _pair(rl, lambda x: f"{x['bytes_per_dev']:.3g}"),
        _pair(rl, lambda x: f"{sum(x['collective_bytes_per_dev'].values()):.3g}"),
        _pair(rl, lambda x: x["dominant"]),
        _pair(rl, lambda x: f"{x['bound_s']:.4g}"),
        _pair(reps, lambda r: f"{r['memory_analysis']['peak_bytes'] / 1e9:.4g}"
              + ("" if r["memory_analysis"]["fits"] else " (no)")),
        _pair(reps, lambda r: f"{r['roofline_fraction']:.3g}"),
    ]) + " |"


def table(pairs) -> list:
    """The table's rows, one an (arch, shape) of ``pairs``, in order."""
    lines = ["| arch | shape | FLOPs/dev | bytes/dev | collective B/dev | "
             "dominant | bound s | traced peak GB (fits 80 GB?) | roofline "
             "fraction |", "| --- " * 9 + "|"]
    skipped = []
    for arch, shape in pairs:
        paths = [OUT_DIR / f"{arch}__{shape}__{m}.json"
                 for m in ("single", "multi")]
        reps = [json.loads(p.read_text()) if p.exists() else None
                for p in paths]
        if all(r is not None and "skipped" in r for r in reps):
            skipped.append(arch)
            continue
        lines.append(row(arch, shape, reps))
    if skipped:
        lines.append(f"\nlong_500k skipped (full attention): "
                     f"{', '.join(skipped)}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    ap.add_argument("--limit", type=float, default=1800.0)
    ap.add_argument("--table-only", action="store_true",
                    help="print the table of the reports already written")
    ap.add_argument("--shape", action="append", choices=list(SHAPES),
                    help="only this shape's cells (repeatable)")
    ap.add_argument("--cell", action="append", default=[],
                    help="ARCH:SHAPE, one more arch's cell (repeatable)")
    args = ap.parse_args()
    shapes = tuple(args.shape or ([] if args.cell else SHAPES))
    pairs = [(a, s) for a in sorted(ARCHS) for s in shapes]
    for cell in args.cell:
        arch, shape = cell.split(":")
        if arch not in ARCHS or shape not in SHAPES:
            ap.error(f"--cell {cell}: unknown arch or shape")
        if (arch, shape) not in pairs:
            pairs.append((arch, shape))
    if not args.table_only:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        cells = [(a, s, m) for m in ("single", "multi") for a, s in pairs]
        cells.sort(key=lambda c: (c[0] not in SLOW,
                                  c[1] not in ("prefill_32k", "train_4k")))
        with ThreadPoolExecutor(args.jobs) as pool:
            list(pool.map(lambda c: run(c, args.limit), cells))
    lines = table(pairs)
    print("\n".join(lines))
    return sum("not traced" in ln or "no report" in ln or "error" in ln
               for ln in lines)


if __name__ == "__main__":
    raise SystemExit(main())
