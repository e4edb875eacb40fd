"""Meta-tensor stand-ins and placement trees for every dry-run cell.

The counterpart of the JAX package's ``launch/specs.py``.  Nothing is
allocated: parameters, optimizer state, batches and caches come from the
real constructors (``models.model.LM``, ``train.optimizer.init_opt_state``,
``models.model.make_caches``) on the ``meta`` device, in place of
``jax.eval_shape``, so the specs can never drift from the code that builds
the live objects.  Shardings are tuples of DTensor placements, one per
mesh dimension, from ``parallel.sharding.spec_for`` (the JAX rules).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.convert import param_tree
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.layers import pdtype
from repro_torch.models.model import LM, logical_axes, make_caches
from repro_torch.parallel.sharding import (batch_sharding, data_axes,
                                           replicated, shardings_for_tree,
                                           spec_for)
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

META = torch.device("meta")


# ---------------------------------------------------------------- params

def param_specs(cfg: ModelConfig):
    """(parameter tree of meta tensors, logical axes tree)."""
    return param_tree(LM(cfg, META)), logical_axes(cfg)


def param_shardings(cfg: ModelConfig, mesh: DeviceMesh, axes, params,
                    report=None):
    return shardings_for_tree(params, axes, mesh, fsdp=cfg.fsdp,
                              report=report)


def opt_specs(cfg: ModelConfig, params, opt_cfg: AdamWConfig):
    return init_opt_state(params, opt_cfg)


def opt_shardings(param_shards, opt_state, mesh: DeviceMesh):
    return {"m": param_shards, "v": param_shards, "step": replicated(mesh)}


# ---------------------------------------------------------------- batches

def batch_specs(cfg: ModelConfig, shape: InputShape):
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META),
             "labels": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.frontend == "vision_stub":
        specs["frontend"] = torch.empty((b, cfg.frontend_tokens, cfg.d_model),
                                        dtype=pdtype(cfg), device=META)
    elif cfg.frontend == "audio_stub":
        specs["frontend"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                        dtype=pdtype(cfg), device=META)
    return specs


def _data_size(mesh: DeviceMesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def batch_shardings(cfg: ModelConfig, shape: InputShape, mesh: DeviceMesh):
    """The batch split over (pod, data), replicated when the global batch
    does not divide that product (long_500k's batch of 1)."""
    bsh = batch_sharding(mesh)
    if shape.global_batch % _data_size(mesh):
        bsh = replicated(mesh)
    out = {"tokens": bsh, "labels": bsh}
    if cfg.frontend is not None:
        out["frontend"] = bsh
    return out


# ----------------------------------------------------------------- caches

CACHE_AXES = {
    "kv": (("layers", "batch", "kv_seq", "kv_heads", "head_dim"),) * 2,
    "mamba": (("layers", "batch", "mlp", None),
              ("layers", "batch", None, "mlp")),
    # xlstm recurrent states: (m_state C/n/m, s_state c/n/h/m)
    "states": (
        ((None, None, "batch", "heads", None, None),
         (None, None, "batch", "heads", None),
         (None, None, "batch", "heads")),
        ((None, "batch", "mlp"), (None, "batch", "mlp"),
         (None, "batch", "mlp"), (None, "batch", "mlp")),
    ),
}


def cache_specs(cfg: ModelConfig, shape: InputShape):
    return make_caches(cfg, shape.global_batch, shape.seq_len, device=META)


def cache_shardings(cfg: ModelConfig, shape: InputShape, mesh: DeviceMesh,
                    caches: dict, report: list | None = None) -> dict:
    """Placements of every cache leaf, in the caches' nesting; ``batch`` is
    dropped where the global batch does not divide the data product.  The
    dimensions a mesh axis does not divide are appended to ``report``."""
    batch_ok = shape.global_batch % _data_size(mesh) == 0

    def one(leaf, ax):
        if isinstance(leaf, tuple):
            return tuple(one(t, a) for t, a in zip(leaf, ax))
        ax = tuple(a if batch_ok or a != "batch" else None for a in ax)
        return spec_for(tuple(leaf.shape), ax, mesh, fsdp=cfg.fsdp,
                        report=report)

    return {key: one(leaf, CACHE_AXES[key]) for key, leaf in caches.items()}


def act_sharding(cfg: ModelConfig, shape: InputShape, mesh: DeviceMesh):
    """(B, S, D) activation placements: batch over (pod, data), D unsharded
    (tensor axes live in heads/mlp dims); replicated when the cell's batch
    does not divide the data product (long_500k's B=1)."""
    if shape.global_batch % _data_size(mesh):
        return replicated(mesh)
    return tuple(Shard(0) if name in data_axes(mesh) else Replicate()
                 for name in mesh.mesh_dim_names)


def enc_out_spec(cfg: ModelConfig, shape: InputShape):
    if not cfg.encoder_layers:
        return None
    return torch.empty((shape.global_batch, cfg.encoder_seq, cfg.d_model),
                       dtype=pdtype(cfg), device=META)
