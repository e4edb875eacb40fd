"""Checkpointing with bitwise resume, in the JAX package's on-disk schema.

Format: ``params.npz`` and ``opt_state.npz``, every leaf keyed by its
``"/"``-joined tree path (``blocks/attn/wq``, ``m/embed``, ``step``),
bfloat16 widened to float32 (npz cannot hold bf16; the widening is
lossless), and a JSON manifest (step, config name, extra).  A checkpoint
written by either package loads in the other.  A sharded (DTensor) leaf is
gathered to its full value to save (every rank takes part; rank 0 writes)
and each rank keeps its own shard of the value it loads.

Atomicity: writes go to ``<dir>.tmp`` then ``os.replace`` — a crash
mid-save leaves the previous checkpoint intact (exercised by the
failure-injection test).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.convert import tree_items


def _flatten_with_paths(tree: dict) -> dict:
    out = {}
    for path, leaf in tree_items(tree):
        t = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:        # npz cannot round-trip bf16
            t = t.float()                    # widening cast is lossless
        out["/".join(path)] = t.numpy()
    return out


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(ckpt_dir: str | Path, step: int, params: dict,
                    opt_state: dict, *, config_name: str = "",
                    extra: dict | None = None) -> None:
    """Save the parameter tree (``convert.param_tree``) and the AdamW state
    under ``ckpt_dir``."""
    ckpt_dir = Path(ckpt_dir)
    flat_params = _flatten_with_paths(params)
    flat_opt = _flatten_with_paths(opt_state)
    if not _writer():
        return
    tmp = ckpt_dir.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "params.npz", **flat_params)
    np.savez(tmp / "opt_state.npz", **flat_opt)
    manifest = {"step": int(step), "config": config_name,
                "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    os.replace(tmp, ckpt_dir)


@torch.no_grad()
def _load_into(template: dict, flat: dict) -> None:
    for path, leaf in tree_items(template):
        key = "/".join(path)
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint {arr.shape}, template "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(np.array(arr, order="C"))   # keeps 0-d shape
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            t = DTensor.from_local(
                t.to(leaf.to_local().device), mesh,
                [Replicate()] * mesh.ndim, run_check=False).redistribute(
                    mesh, leaf.placements)
            leaf.to_local().copy_(t.to_local())
        else:
            leaf.copy_(t)


def load_checkpoint(ckpt_dir: str | Path, params_template: dict,
                    opt_template: dict):
    """Restore ``(step, params, opt_state)``: every leaf of the templates
    (the live parameter tree and AdamW state) is overwritten in place with
    the saved value, cast to the leaf's dtype, and the templates returned.
    A template built for another mesh than the one that saved is the
    elastic-rescale path: each rank takes its shard of the saved value."""
    ckpt_dir = Path(ckpt_dir)
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    with np.load(ckpt_dir / "params.npz") as z:
        _load_into(params_template, dict(z))
    with np.load(ckpt_dir / "opt_state.npz") as z:
        _load_into(opt_template, dict(z))
    return manifest["step"], params_template, opt_template


def latest_step(root: str | Path) -> Path | None:
    root = Path(root)
    if not root.exists():
        return None
    steps = sorted((int(p.name.split("_")[-1]), p)
                   for p in root.glob("step_*") if p.is_dir())
    return steps[-1][1] if steps else None
