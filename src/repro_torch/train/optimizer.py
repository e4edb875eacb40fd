"""AdamW with dtype-configurable moments and decoupled weight decay.

The state mirrors the parameter tree (``repro_torch.convert.param_tree``):
``{"m": tree, "v": tree, "step": int32 tensor}``, the JAX package's
layout, so a state crosses between the packages by
``convert.opt_state_to_numpy`` / ``opt_state_from_numpy`` and a checkpoint
of either loads in the other.  A moment of a sharded (DTensor) parameter
has the parameter's placements, so FSDP shards moments exactly like
weights.

The update runs under ``no_grad`` in float32 and writes the parameters and
moments in place (the JAX package returns new trees); each leaf is cast
back to its own dtype.  The warmup and the bias corrections ``b ** step``
are float32 tensor arithmetic, as ``jnp`` computes them, not Python
float64.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.convert import tree_items, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor): a linear warmup."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt).detach()
    device = next(_local(p) for _, p in tree_items(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (the tensor itself under no_grad, so
    writes go through), or a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaves in the
    JAX tree order; a sharded leaf's sum is reduced over the mesh."""
    total = 0
    for _, x in tree_items(tree):
        sq = torch.sum(torch.square(x.float()))
        total = total + (sq.full_tensor() if isinstance(sq, DTensor) else sq)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, cfg: AdamWConfig):
    """One AdamW step from ``grads`` (a tree keyed as ``params``).

    Writes ``params`` and the moments in place; returns ``(params,
    new_state, {"grad_norm", "lr"})``, ``new_state`` holding the same
    moment trees and the incremented step."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, device=stepf.device) ** stepf
    bc2 = 1 - torch.tensor(cfg.b2, device=stepf.device) ** stepf
    for path, p in tree_items(params):
        g, m, v = (_local(_at(t, path)) for t in (grads, state["m"],
                                                  state["v"]))
        p = _local(p)
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def _at(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree
