"""Mixture-of-Experts block: group-limited token-choice routing with
capacity (mixtral: 8 experts top-2; kimi-k2: 384 top-8 and a shared
expert).

The counterpart of the JAX package's ``models/moe.py``.  Routing stays
within each sequence: every token picks its top-k experts, then every
expert takes its top-C tokens by gate weight (capacity C = int(cf * k * S
/ E) + 1, at most S), Switch/GShard dropping semantics.

Two choices keep the port equal to the JAX package and its gradient free
of atomics on the card:
- Top-k and top-C pick by a stable descending sort, so ties go to the
  lower index as ``jax.lax.top_k``'s do (an expert that fewer than C
  tokens route to ties at exact zeros); the values picked are one-hot
  contractions of the scores.
- Dispatch and combine are one-hot contractions over the sequence,
  (B, E, C, S) against (B, S, D), exact in the forward since each one-hot
  row holds one 1; a gather's backward would scatter-add.

Under the sharded training step (``tp``, the mesh's model axis) the
router's expert columns are split over the axis and its scores gathered
whole before the stable top-k, so every rank routes alike.  The experts
then run in one of the two modes of the JAX ``_moe_axes``: with
``moe_tp`` every rank holds every expert's slice of the hidden columns;
without it, a rank holds whole experts and computes their slots of the
dispatch and combine.  Either way the combined output is a partial sum,
all-reduced over the axis once with the shared experts' (column- and
row-parallel like the MLP).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel.tensor_parallel import (Axis, copy_to,
                                                  gather_from, reduce_from,
                                                  scatter_to, split_axis)
from .config import ModelConfig
from .layers import _dense_init, _param


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * seq_len / cfg.n_experts) + 1
    return max(1, min(c, seq_len))


class Moe(nn.Module):
    """router (L, d, E) float32; w_gate, w_up (L, E, d, f) and w_down
    (L, E, f, d); with shared experts shared_gate, shared_up (L, d, fs) and
    shared_down (L, fs, d), fs = f * n_shared_experts."""

    def __init__(self, cfg: ModelConfig, n_layers: int, device=None):
        super().__init__()
        self.cfg = cfg
        L, d, e, f = (n_layers,), cfg.d_model, cfg.n_experts, cfg.expert_d_ff
        self.router = _param(L + (d, e), cfg, device, torch.float32)
        self.w_gate = _param(L + (e, d, f), cfg, device)
        self.w_up = _param(L + (e, d, f), cfg, device)
        self.w_down = _param(L + (e, f, d), cfg, device)
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.shared_gate = _param(L + (d, fs), cfg, device)
            self.shared_up = _param(L + (d, fs), cfg, device)
            self.shared_down = _param(L + (fs, d), cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        d, f = cfg.d_model, cfg.expert_d_ff
        for w, fan_in in ((self.router, d), (self.w_gate, d), (self.w_up, d),
                          (self.w_down, f)):
            _dense_init(w, fan_in, gen)
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            for w, fan_in in ((self.shared_gate, d), (self.shared_up, d),
                              (self.shared_down, fs)):
                _dense_init(w, fan_in, gen)


def top_k_one_hot(scores, k: int):
    """The k largest entries along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order): (values, indices, one-hot (..., k, n)).
    The values are the one-hot rows' contractions with ``scores``, so their
    gradient is a product, not a scatter."""
    idx = torch.sort(scores.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    one_hot = (idx[..., None] == torch.arange(
        scores.shape[-1], device=scores.device)).to(scores.dtype)
    return torch.einsum("...kn,...n->...k", one_hot, scores), idx, one_hot


def apply_moe(p: dict, x, cfg: ModelConfig, tp: Axis | None = None):
    """x (B, S, d) -> ((B, S, d), aux); routing per sequence.  ``tp``: the
    model axis; ``p`` then holds this rank's router columns, experts or
    expert columns, as its shapes say."""
    s = x.shape[1]
    c = capacity(cfg, s)
    e, f = cfg.n_experts, cfg.expert_d_ff
    rt = split_axis(tp, p["router"].shape[-1], e)    # router columns
    et = split_axis(tp, p["w_gate"].shape[0], e)     # whole experts
    ft = split_axis(tp, p["w_gate"].shape[-1], f)    # expert hidden columns

    logits = torch.einsum("bsd,de->bse", copy_to(x.float(), rt), p["router"])
    logits = gather_from(logits, rt, -1)
    probs = torch.softmax(logits, dim=-1)                   # (B, S, E) f32
    gate_vals, _, gate_one_hot = top_k_one_hot(probs, cfg.top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # token -> expert weights, then every expert's top-C tokens
    weights = (gate_vals[..., None] * gate_one_hot).sum(dim=2)   # (B, S, E)
    top_c_w, _, dispatch = top_k_one_hot(weights.transpose(1, 2), c)
    dispatch = dispatch.to(x.dtype)                          # (B, E, C, S)
    if et is not None:                   # this rank's experts' slots
        n = p["w_gate"].shape[0]
        dispatch = dispatch[:, et.offset(n):et.offset(n) + n]
        top_c_w = scatter_to(top_c_w, et, 1)
    part = et or ft
    if et is None:
        top_c_w = copy_to(top_c_w, ft)

    xg = torch.einsum("becs,bsd->becd", dispatch, copy_to(x, part))
    gate = torch.einsum("becd,edf->becf", xg, p["w_gate"])
    up = torch.einsum("becd,edf->becf", xg, p["w_up"])
    # SiLU in the parameter dtype, as the JAX package's experts
    h = nn.functional.silu(gate) * up
    y = torch.einsum("becf,efd->becd", h, p["w_down"])
    y = y * top_c_w[..., None].to(y.dtype)                  # combine gates
    out = torch.einsum("becs,becd->bsd", dispatch, y)

    if cfg.n_shared_experts:
        st = split_axis(tp, p["shared_gate"].shape[-1],
                        f * cfg.n_shared_experts)
        xs = copy_to(x, st)
        sg = torch.einsum("bsd,df->bsf", xs, p["shared_gate"])
        su = torch.einsum("bsd,df->bsf", xs, p["shared_up"])
        sh = nn.functional.silu(sg.float()).to(x.dtype) * su
        shared = torch.einsum("bsf,fd->bsd", sh, p["shared_down"])
        if st is part:                # one all-reduce of both partial sums
            out = out + shared
        else:
            out, shared = reduce_from(out, part), reduce_from(shared, st)
            out, part = out + shared, None
    return reduce_from(out, part), router_aux_loss(probs, gate_one_hot, cfg)


def router_aux_loss(probs, gate_one_hot, cfg: ModelConfig):
    """Switch-style load-balancing loss, the mean over sequences; probs
    (B, S, E), gate_one_hot (B, S, K, E)."""
    frac_tokens = gate_one_hot.sum(dim=2).mean(dim=1)       # (B, E)
    frac_probs = probs.mean(dim=1)                          # (B, E)
    return (cfg.n_experts * (frac_tokens * frac_probs).sum(dim=-1)).mean()
