"""Hymba at its published structure (``HymbaConfig``): prefill and decode
through caches of three kinds, on one device.

  meta_state(model)                                        -> MetaState
  make_caches(cfg, batch, cache_len, device=None)          -> caches
  prefill(model, tokens, cache_len, meta=None)             -> logits, caches
  decode_step(model, token, caches, index)                 -> logits, caches

Each block (arXiv:2411.13676 §2) runs attention heads and mamba heads side
by side on one normed input, as ``models/model.py``'s hybrid block does:
h = RMSNorm(x); x += (RMSNorm(Attn(h)) + RMSNorm(Mamba(h))) / 2; then
x += SwiGLU(RMSNorm(x)).  The config's M meta tokens sit at positions
0..M-1 before every sequence, its text position p at M + p:
- a global layer's query sees every position up to its own;
- a window layer's query at text position p sees every meta token and the
  text positions p - W + 1 .. p (W the window);
- the mamba heads scan the meta tokens first;
- a layer of a k/v group reads the k/v that the group's first layer
  projected from its own input, in prefill and in decode alike.

Caches, one k/v cache per group (or per layer outside any group):
- ``"global"``: (k, v) of (Gg, B, M + C, Hkv, hd), C = cache_len: slot
  M + p holds text position p, and a position past C raises;
- ``"window"``: (k, v) of (Gw, B, M + Cw, Hkv, hd), a ring of
  Cw = min(cache_len, W) slots: slot M + p % Cw holds text position p;
- slots 0..M-1 of both hold the meta tokens' k/v;
- ``"mamba"``: (ssm state (L, B, e, N) float32, conv tail (L, B, K - 1, e)),
  e the mamba width.
The meta tokens' k/v and mamba state depend on the weights alone:
:func:`meta_state` computes them once and every prefill copies them in.

Prefill's window layers attend in two kernel calls, over the prompt within
the window (causal, window W) and over the meta tokens (no mask), merged
by the calls' log-sum-exps: the two sets of keys are disjoint.  A decode
step attends every written slot of its cache in one call: a ring holds
the last Cw text positions, which are its window.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.parallel.tensor_parallel import split_attention_weight
from .config import HymbaConfig
from .layers import apply_mlp, block_norm, pdtype, rms_norm, rope
from .model import LM, _final_logits, embed_tokens
from .ssm import apply_mamba

KINDS = ("global", "window")
# The cache kinds held as rings of min(cache_len, window) slots.  Global
# layers hold the whole context; ("global", "window") here is the layout
# of the paper-table config, under which a global layer's decode sees only
# a window.
RING_KINDS = ("window",)


class CacheRef(NamedTuple):
    kind: str          # "global" or "window"
    index: int         # the cache among its kind's
    writes: bool       # the layer projects the k/v (its group's first)


class MetaState(NamedTuple):
    kv: dict           # kind -> (k, v), each (caches of the kind, M, Hkv, hd)
    state: torch.Tensor    # (L, e, N) float32: the mamba state after them
    conv: torch.Tensor     # (L, K - 1, e): the conv tail after them


def cache_layout(cfg: HymbaConfig) -> list[CacheRef]:
    """Each layer's k/v cache, numbered within its kind in layer order."""
    follows = {i: g[0] for g in cfg.kv_groups for i in g[1:]}
    counts = dict.fromkeys(KINDS, 0)
    out: list[CacheRef] = []
    for lid in range(cfg.n_layers):
        kind = "global" if cfg.is_global(lid) else "window"
        if lid in follows:
            out.append(out[follows[lid]]._replace(writes=False))
            continue
        out.append(CacheRef(kind, counts[kind], True))
        counts[kind] += 1
    return out


def n_caches(cfg: HymbaConfig, kind: str) -> int:
    return sum(r.writes and r.kind == kind for r in cache_layout(cfg))


def cache_slots(cfg: HymbaConfig, kind: str, cache_len: int) -> int:
    """Text slots of a cache of ``kind``: a ring of min(cache_len, window)
    for a ring kind, else ``cache_len``."""
    return min(cache_len, cfg.sliding_window) if kind in RING_KINDS \
        else cache_len


def make_caches(cfg: HymbaConfig, batch: int, cache_len: int,
                device=None) -> dict:
    """Zeroed caches (the module docstring's layout)."""
    dt, m = pdtype(cfg), cfg.meta_tokens
    caches = {}
    for kind in KINDS:
        shape = (n_caches(cfg, kind), batch,
                 m + cache_slots(cfg, kind, cache_len), cfg.n_kv_heads,
                 cfg.head_dim)
        caches[kind] = tuple(torch.zeros(shape, dtype=dt, device=device)
                             for _ in range(2))
    e, L = cfg.mamba_width, cfg.n_layers
    caches["mamba"] = (
        torch.zeros((L, batch, e, cfg.ssm_state), dtype=torch.float32,
                    device=device),
        torch.zeros((L, batch, cfg.ssm_conv - 1, e), dtype=dt, device=device))
    return caches


def _merge(parts):
    """Attention over disjoint sets of keys from each set's (output,
    log-sum-exp)."""
    lses = torch.stack([lse for _, lse in parts])
    out = sum(o.float() * split_attention_weight(lse, lses)[..., None]
              for o, lse in parts)
    return out.to(parts[0][0].dtype)


def _attend_prompt(p: dict, cfg: HymbaConfig, ref: CacheRef, positions,
                   kv, meta_kv, attention, h):
    """A layer's attention over a prompt h (B, S, d) at ``positions``: its
    own k/v when it writes, else its group's ``kv``; with ``meta_kv`` (each
    (M, Hkv, hd)) the text after the meta tokens, else the meta tokens
    themselves (causal among them).  Returns (output, the prompt's k/v)."""
    q = rope(torch.einsum("bsd,dhk->bshk", h, p["wq"]), positions,
             cfg.rope_theta)
    if ref.writes:
        k = rope(torch.einsum("bsd,dhk->bshk", h, p["wk"]), positions,
                 cfg.rope_theta)
        kv = (k, torch.einsum("bsd,dhk->bshk", h, p["wv"]))
    k, v = kv
    if meta_kv is None:
        out = attention(q, k, v, causal=True, q_offset=0)
    else:
        b, m = h.shape[0], meta_kv[0].shape[0]
        mk, mv = (t[None].expand(b, *t.shape) for t in meta_kv)
        if ref.kind == "global":
            out = attention(q, torch.cat([mk, k], 1), torch.cat([mv, v], 1),
                            causal=True, q_offset=m)
        else:
            out = _merge([attention(q, k, v, causal=True,
                                    window=cfg.sliding_window, q_offset=0,
                                    return_lse=True),
                          attention(q, mk, mv, causal=False,
                                    return_lse=True)])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), kv


def _block(bp: dict, x, cfg: HymbaConfig, lid: int, attn_fn, mamba_state):
    """One block around ``attn_fn(h) -> (output, k/v)``; returns (x, k/v,
    the new mamba state and conv tail: ``mamba_state``'s tensors, written
    in place, where it holds them)."""
    h = block_norm(x, bp["norms"], 0, cfg)
    s = spans.ON and spans.begin(
        "model.attn.global" if cfg.is_global(lid) else "model.attn.window")
    a, kv = attn_fn(h)
    if s:
        spans.end(s)
    s = spans.ON and spans.begin("model.mamba")
    m, new_mamba = apply_mamba(bp["mamba"], h, cfg, state=mamba_state[0],
                               conv_state=mamba_state[1])
    if s:
        spans.end(s)
    x = x + 0.5 * (rms_norm(a, eps=cfg.norm_eps)
                   + rms_norm(m, eps=cfg.norm_eps))
    return x + apply_mlp(bp["mlp"], block_norm(x, bp["norms"], 1, cfg)), \
        kv, new_mamba


@torch.no_grad()
def meta_state(model: LM, *, attention=flash_attention) -> MetaState:
    """The meta tokens run through every layer as a sequence of their own:
    each cache's k/v of them and each layer's mamba state after them."""
    cfg = model.cfg
    lay = cache_layout(cfg)
    x = model.meta[None]
    positions = torch.arange(x.shape[1], device=x.device)[None]
    kv = {kind: [None] * n_caches(cfg, kind) for kind in KINDS}
    states, convs = [], []
    for lid, ref in enumerate(lay):
        bp = model.blocks.layer(lid)
        x, kv_l, (st, conv) = _block(
            bp, x, cfg, lid, functools.partial(
                _attend_prompt, bp["attn"], cfg, ref, positions,
                kv[ref.kind][ref.index], None, attention), (None, None))
        kv[ref.kind][ref.index] = kv_l
        states.append(st[0])
        convs.append(conv[0])
    empty = torch.zeros((0, x.shape[1], cfg.n_kv_heads, cfg.head_dim),
                        dtype=x.dtype, device=x.device)
    return MetaState(
        kv={kind: tuple(torch.stack([t[i][0] for t in kv[kind]])
                        if kv[kind] else empty for i in range(2))
            for kind in KINDS},
        state=torch.stack(states), conv=torch.stack(convs))


def _check(model: LM, tp) -> HymbaConfig:
    cfg = model.cfg
    if tp is not None:
        raise NotImplementedError(f"{cfg.name}: the published hymba "
                                  "structure is served on one device; no "
                                  "sharded step runs it")
    return cfg


@torch.no_grad()
def prefill(model: LM, tokens, cache_len: int, *, meta: MetaState | None =
            None, attention=flash_attention, tp=None):
    """The whole prompt (B, S) after the meta tokens; returns (last-position
    logits (B, V_pad) float32, filled caches).  ``meta``: the model's
    :func:`meta_state`, computed here when None."""
    cfg = _check(model, tp)
    b, s = tokens.shape
    m = cfg.meta_tokens
    if meta is None:
        meta = meta_state(model, attention=attention)
    caches = make_caches(cfg, b, cache_len, tokens.device)
    for kind in KINDS:
        for t, mt in zip(caches[kind], meta.kv[kind]):
            t[:, :, :m] = mt[:, None]
    state, conv = caches["mamba"]
    state.copy_(meta.state[:, None].expand_as(state))
    conv.copy_(meta.conv[:, None].expand_as(conv))
    x = embed_tokens(model, tokens)
    positions = m + torch.arange(s, device=x.device)[None]
    shared: dict = {}
    for lid, ref in enumerate(cache_layout(cfg)):
        bp = model.blocks.layer(lid)
        meta_kv = tuple(t[ref.index] for t in meta.kv[ref.kind])
        x, kv, _ = _block(
            bp, x, cfg, lid, functools.partial(
                _attend_prompt, bp["attn"], cfg, ref, positions,
                shared.get(ref[:2]), meta_kv, attention),
            (state[lid], conv[lid]))
        if ref.writes:
            shared[ref[:2]] = kv
            _fill(caches[ref.kind], ref, kv, m, s)
    return _final_logits(model, x[:, -1:])[:, 0], caches


def _fill(cache, ref: CacheRef, kv, m: int, s: int) -> None:
    """Write a prompt's k/v (B, S, Hkv, hd) into cache ``ref``: text
    position p at slot m + p, or on a ring of C slots the last C positions
    at m + p % C."""
    c = cache[0].shape[2] - m
    if ref.kind not in RING_KINDS and s > c:
        raise IndexError(f"a prompt of {s} positions over a {ref.kind} "
                         f"cache of {c} slots")
    pos = torch.arange(max(s - c, 0), s, device=kv[0].device)
    for t, new in zip(cache, kv):
        t[ref.index][:, m + pos % c] = new[:, pos].to(t.dtype)


def _attend_token(p: dict, cfg: HymbaConfig, ref: CacheRef, cache,
                  index: int, positions, attention, h):
    """A layer's attention for one token h (B, 1, d) at text position
    ``index``: its k/v written to its slot when the layer writes, then every
    written slot of ``cache`` (k, v of (B, M + C, Hkv, hd)) attended."""
    ck, cv = cache
    m = cfg.meta_tokens
    c = ck.shape[1] - m
    q = rope(torch.einsum("bsd,dhk->bshk", h, p["wq"]), positions,
             cfg.rope_theta)
    if ref.writes:
        k = rope(torch.einsum("bsd,dhk->bshk", h, p["wk"]), positions,
                 cfg.rope_theta)
        v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
        ck[:, m + index % c] = k[:, 0].to(ck.dtype)
        cv[:, m + index % c] = v[:, 0].to(cv.dtype)
    out = attention(q, ck, cv, causal=True, q_offset=m + min(index, c - 1))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), None


@torch.no_grad()
def decode_step(model: LM, token, caches: dict, index: int, *,
                attention=flash_attention, tp=None):
    """One token (B, 1) at text position ``index``: its k/v go to slot
    M + index (a ring: M + index % Cw) of each cache its layers write, and
    every layer attends the written slots of its cache.  Returns (logits
    (B, V_pad) float32, caches), the caches updated in place."""
    cfg = _check(model, tp)
    m = cfg.meta_tokens
    x = embed_tokens(model, token)
    positions = torch.full((1, 1), m + index, device=x.device)
    state, conv = caches["mamba"]
    for lid, ref in enumerate(cache_layout(cfg)):
        bp = model.blocks.layer(lid)
        cache = tuple(t[ref.index] for t in caches[ref.kind])
        slots = cache[0].shape[1] - m
        if ref.kind not in RING_KINDS and index >= slots:
            raise IndexError(f"{cfg.name}: text position {index} past a "
                             f"{ref.kind} cache of {slots} slots")
        x, _, _ = _block(
            bp, x, cfg, lid, functools.partial(
                _attend_token, bp["attn"], cfg, ref, cache, index, positions,
                attention), (state[lid], conv[lid]))
    return _final_logits(model, x)[:, 0], caches
