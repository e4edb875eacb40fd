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
"""
from __future__ import annotations

import torch
from torch import nn

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


def apply_moe(p: dict, x, cfg: ModelConfig):
    """x (B, S, d) -> ((B, S, d), aux); routing per sequence."""
    s = x.shape[1]
    c = capacity(cfg, s)

    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)                   # (B, S, E) f32
    gate_vals, _, gate_one_hot = top_k_one_hot(probs, cfg.top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # token -> expert weights, then every expert's top-C tokens
    weights = (gate_vals[..., None] * gate_one_hot).sum(dim=2)   # (B, S, E)
    top_c_w, _, dispatch = top_k_one_hot(weights.transpose(1, 2), c)
    dispatch = dispatch.to(x.dtype)                          # (B, E, C, S)

    xg = torch.einsum("becs,bsd->becd", dispatch, x)
    gate = torch.einsum("becd,edf->becf", xg, p["w_gate"])
    up = torch.einsum("becd,edf->becf", xg, p["w_up"])
    # SiLU in the parameter dtype, as the JAX package's experts
    h = nn.functional.silu(gate) * up
    y = torch.einsum("becf,efd->becd", h, p["w_down"])
    y = y * top_c_w[..., None].to(y.dtype)                  # combine gates
    out = torch.einsum("becs,becd->bsd", dispatch, y)

    if cfg.n_shared_experts:
        sg = torch.einsum("bsd,df->bsf", x, p["shared_gate"])
        su = torch.einsum("bsd,df->bsf", x, p["shared_up"])
        sh = nn.functional.silu(sg.float()).to(x.dtype) * su
        out = out + torch.einsum("bsf,fd->bsd", sh, p["shared_down"])
    return out, router_aux_loss(probs, gate_one_hot, cfg)


def router_aux_loss(probs, gate_one_hot, cfg: ModelConfig):
    """Switch-style load-balancing loss, the mean over sequences; probs
    (B, S, E), gate_one_hot (B, S, K, E)."""
    frac_tokens = gate_one_hot.sum(dim=2).mean(dim=1)       # (B, E)
    frac_probs = probs.mean(dim=1)                          # (B, E)
    return (cfg.n_experts * (frac_tokens * frac_probs).sum(dim=-1)).mean()
