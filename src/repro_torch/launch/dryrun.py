"""Dry run: trace every (arch x shape x mesh) cell of the card's program.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell's step for a TPU pod and reads the compiled module.
Here each cell's step is the one the card runs (``make_train_step``,
``models.model.prefill``, ``serve_decode_step``), traced once on meta
tensors: nothing is allocated, nothing is launched, and no card is
needed.  The attention wrapper sends a meta tensor down the kernel's route
(its checks, then the kernel's op, whose fake implementation gives the
shape), so the trace is the CUDA program, whatever the host has; it is not
a CPU fallback and does not go through ``resolve_device``.
``launch/trace_analysis.py`` counts the ops, and ``launch/roofline.py``
turns the counts into the H100's terms.  Meta tensors rather than fake
CUDA tensors (``FakeTensorMode``): a build of PyTorch without CUDA refuses
a fake CUDA tensor wherever the device is guarded (autograd's input
metadata, ``Tensor.copy_``, indexed assignment), while the ops dispatched
are the same; ``chip_smoke.py`` holds a meta trace equal, op for op, to
the same step run on the card.

A mesh is a ``DeviceMesh`` over the ``fake`` process group at the
production world size (256 single, 512 multi pod); its collectives return
at once and are counted.  Rank 0's trace is the per-device count, as the
JAX package's partitioned module is.  A ``train`` cell traces the port's
sharded training step (``train/train_step.py``), the JAX package's GSPMD
program: parameters and moments are DTensors placed by the JAX rules, each
layer's weights are all-gathered over the data axes just before use and
keep their split over ``model``, so rank 0 computes its own heads, MLP
columns, experts, mamba channels, xLSTM heads and columns and vocabulary
rows of its batch shard, with the model-axis all-reduces and the FSDP
reduce-scatters of the gradients.  Prefill and decode cells trace the
port's sharded serve steps (``serve/serve_step.py``), the JAX package's
``serve_prefill`` and ``serve_decode_step`` under the same parameter
placements, with the caches DTensors placed by ``specs.cache_shardings``
(``CACHE_AXES``): rank 0 holds its batch rows of its slice of every k/v
cache's slots, and of the recurrent states its channels or heads.  A
prefill cell fills the rank's slots; a decode step writes position
``seq_len - 1``, a full cache, and attends to the rank's slice, merging
the partial softmaxes over ``model``.  That slot belongs to the last
model-axis rank, but every rank dispatches the same ops for the write
(``models/layers._write_token``), so rank 0's counts are any rank's.

Each cell's report lands in ``experiments/dryrun_torch/<arch>__<shape>__
<mesh>[__variant].json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import (ARCHS, SERVE_ONLY, SHAPES, get_config,
                                 shape_cells)
from repro_torch.convert import param_tree
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.launch.roofline import HBM_BYTES, analyze, model_flops
from repro_torch.launch.trace_analysis import count
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.model import LM, make_caches
from repro_torch.parallel.sharding import shard_model
from repro_torch.serve.serve_step import (serve_decode_step, serve_prefill,
                                          sharded_caches)
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
WORLD = {"single": 256, "multi": 512}
META = torch.device("meta")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` ranks on the ``fake`` backend,
    this process rank 0, destroyed on exit.  Refuses to replace a group
    that is already running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool) -> DeviceMesh:
    """The production mesh over the running (fake) process group.  Its
    device type is the card's; meta shards stay meta under any mesh."""
    shape, axes = production_mesh_spec(multi_pod=multi_pod)
    return DeviceMesh("cuda", torch.arange(math.prod(shape)).view(shape),
                      mesh_dim_names=axes)


@dataclasses.dataclass
class CellStep:
    """One cell's step: ``step(*inputs)`` takes it once; ``inputs`` (the
    model first, then the optimizer state and batch, the tokens, or the
    caches) live before it."""
    step: object
    inputs: tuple
    replicated: list

    def run(self):
        return self.step(*self.inputs)


def _local_rows(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    """The rank's batch rows: the global batch over the data product, or
    all of it where that does not divide (replicated)."""
    if mesh is None:
        return shape.global_batch
    sh = S.batch_shardings(cfg, shape, mesh)["tokens"]
    n = 1
    for size, pl in zip(mesh.shape, sh):
        n *= size if pl.is_shard() else 1
    return shape.global_batch // n


def build_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
               device=META, opt_cfg: AdamWConfig | None = None,
               attention=flash_attention) -> CellStep:
    """The cell's model, inputs and step on ``device`` (meta for a trace);
    with a mesh, the parameters (and moments) are
    DTensors placed by the JAX rules and the batch and caches the rank's
    shard.  The model's weights are left as allocated: a run on real
    tensors draws them first (``LM.reset_parameters``).  ``attention``: the
    train step's attention core (the kernel's wrapper)."""
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=cfg.optimizer_dtype)
    model = LM(cfg, device)
    replicated: list = []
    if mesh is not None:
        params, axes = S.param_specs(cfg)
        S.param_shardings(cfg, mesh, axes, params, report=replicated)
        shard_model(model, mesh, fsdp=cfg.fsdp)
    b = _local_rows(cfg, shape, mesh)
    s = shape.seq_len
    dt = next(model.parameters())
    dt = (dt.to_local() if isinstance(dt, DTensor) else dt).dtype
    frontend = None
    if cfg.frontend is not None:
        n_fe = cfg.frontend_tokens if cfg.frontend == "vision_stub" \
            else cfg.encoder_seq
        frontend = torch.zeros((b, n_fe, cfg.d_model), dtype=dt,
                               device=device)

    if shape.mode == "train":
        opt_state = init_opt_state(param_tree(model), opt_cfg)
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                       device=device),
                 "labels": torch.zeros((b, s), dtype=torch.int32,
                                       device=device)}
        if frontend is not None:
            batch["frontend"] = frontend
        if mesh is not None:
            bsh = S.batch_shardings(cfg, shape, mesh)["tokens"]
            batch = {k: DTensor.from_local(v, mesh, bsh, run_check=False)
                     for k, v in batch.items()}
        return CellStep(make_train_step(cfg, opt_cfg, attention=attention),
                        (model, opt_state, batch), replicated)

    def rows(t):
        """The rank's batch rows as a DTensor over the data axes."""
        if mesh is None or t is None:
            return t
        return DTensor.from_local(t, mesh, S.batch_shardings(
            cfg, shape, mesh)["tokens"], run_check=False)

    if mesh is not None:        # the cache dimensions the mesh leaves whole
        S.cache_shardings(cfg, shape, mesh, S.cache_specs(cfg, shape),
                          report=replicated)
    caches = None if mesh is None else \
        sharded_caches(model, mesh, shape.global_batch, s, device)
    if shape.mode == "prefill":
        tokens = torch.zeros((b, s), dtype=torch.int32, device=device)
        return CellStep(
            lambda model, tokens, frontend, caches: serve_prefill(
                model, tokens, s, frontend_embeds=frontend, caches=caches),
            (model, rows(tokens), rows(frontend), caches), replicated)

    if mesh is None:
        caches = make_caches(cfg, b, s, device)
    token = torch.zeros((b, 1), dtype=torch.int32, device=device)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = torch.zeros((b, cfg.encoder_seq, cfg.d_model), dtype=dt,
                              device=device)
    return CellStep(
        lambda model, caches, token, enc_out: serve_decode_step(
            model, token, caches, s - 1, enc_out=enc_out),
        (model, caches, rows(token), rows(enc_out)), replicated)


def lower_cell(cfg: ModelConfig, shape: InputShape, mesh=None,
               opt_cfg: AdamWConfig | None = None,
               variant_tag: str = "baseline"):
    """Trace one cell's step on meta tensors; return (counts, report
    dict).  ``mesh=None`` is one card's step."""
    t0 = time.time()
    cell = build_step(cfg, shape, mesh, opt_cfg=opt_cfg)
    _, counts = count(cell.step, *cell.inputs, device_type="meta")
    trace_s = time.time() - t0

    n_dev = 1 if mesh is None else mesh.size()
    rl = analyze(counts, n_dev)
    mflops = model_flops(cfg, shape)
    mflops_dev = mflops / n_dev
    report = {
        "arch": cfg.name, "shape": shape.name, "mode": shape.mode,
        "mesh": "1" if mesh is None else "x".join(map(str, mesh.shape)),
        "n_devices": n_dev,
        "variant": variant_tag,
        "trace_s": round(trace_s, 1),
        "memory_analysis": {"peak_bytes": counts.peak_bytes,
                            "start_bytes": counts.start_bytes,
                            "device_bytes": HBM_BYTES,
                            "fits": counts.peak_bytes <= HBM_BYTES},
        "roofline": rl.to_dict(),
        "model_flops_global": mflops,
        "model_flops_per_dev": mflops_dev,
        "useful_flops_ratio": (mflops_dev / rl.flops) if rl.flops else 0.0,
        "roofline_fraction": rl.roofline_fraction(mflops_dev),
        "replicated_dims": [
            {"logical": l, "size": s, "axis": str(a)}
            for l, s, a in cell.replicated],
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    return counts, report


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             variant: str = "baseline", out_dir: Path | None = None) -> dict:
    """Trace one production cell over a fake world of the mesh's size and
    write its report to ``out_dir`` (``OUT_DIR`` by default).  A config
    the port serves on one device only (``configs.SERVE_ONLY``) is
    refused."""
    if arch in SERVE_ONLY:
        raise ValueError(f"{arch}: served on one device only "
                         "(models/hymba.py); the dry run traces the sharded "
                         f"production cells of {sorted(ARCHS)}")
    cfg = apply_variant(get_config(arch), variant)
    cell = shape_cells(cfg)[shape_name]
    out_dir = Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}" + (
        "" if variant == "baseline" else f"__{variant}")
    path = out_dir / f"{tag}.json"
    if cell is None:
        report = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "variant": variant, "skipped":
                  "full-attention arch at 500k context (DESIGN.md §4)"}
        path.write_text(json.dumps(report, indent=2))
        print(f"[dryrun] SKIP {tag}")
        return report
    try:
        with fake_world(WORLD[mesh_kind]):
            mesh = production_mesh(multi_pod=mesh_kind == "multi")
            _, report = lower_cell(cfg, cell, mesh, variant_tag=variant)
        report["status"] = "ok"
    except Exception as e:
        report = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "variant": variant, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    path.write_text(json.dumps(report, indent=2))
    status = report.get("status")
    extra = "" if status != "ok" else (
        f" dominant={report['roofline']['dominant']}"
        f" frac={report['roofline_fraction']:.3f}"
        f" trace={report['trace_s']}s")
    print(f"[dryrun] {status.upper()} {tag}{extra}", flush=True)
    return report


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    """Named perf variants, joined by ``+``: ``noremat``, ``fullremat``,
    ``nofsdp``."""
    if variant == "baseline":
        return cfg
    mods = {}
    for piece in variant.split("+"):
        if piece == "noremat":
            mods["remat"] = "none"
        elif piece == "fullremat":
            mods["remat"] = "full"
        elif piece == "nofsdp":
            mods["fsdp"] = False
        else:
            raise ValueError(f"unknown variant piece {piece!r}")
    return dataclasses.replace(cfg, **mods)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", type=str, default="baseline")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = sorted(ARCHS) if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                rep = run_cell(arch, shape_name, mesh_kind, args.variant)
                if rep.get("status") == "error":
                    failures += 1
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
