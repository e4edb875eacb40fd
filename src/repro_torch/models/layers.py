"""Core layers: norms, RoPE, GQA attention (self and cross), SwiGLU, and
the layer stack that holds them.

Parameters live in ``nn.Module``s that hold every layer's weights stacked
on leading axes (``(L, ...)``; the xLSTM stack's ``(n_rep, rep, ...)``),
named as in the JAX package's parameter tree (``blocks.attn.wq`` is
``params["blocks"]["attn"]["wq"]``), so that ``repro_torch.convert``
carries weights across by name.  The layer functions take one layer's
weights as a dict of tensors (``Stack.layer``) and run on whatever device
the tensors are on.

dtype policy, as in the JAX package: parameters in ``cfg.dtype`` (bf16 by
default); norms, SiLU, softmax and logits in float32, cast back.  The
attention core is ``kernels.flash_attention.ops.flash_attention``: on the
card every attention runs the hand-written kernel, and under autograd its
gradient is the vector-Jacobian product of :func:`attend`, the JAX
package's ``_attend``, which is what the JAX package trains with.

Under the sharded training step the layer functions take ``tp``, the
mesh's model axis (``parallel/tensor_parallel.py``), and weights that hold
this rank's slice of it: attention is column-parallel by heads in
``wq``/``wk``/``wv`` and row-parallel in ``wo``, the MLP column-parallel
in ``wi_gate``/``wi_up`` and row-parallel in ``wo``, each followed by one
all-reduce over the axis.  A layer reads its local head and column counts
from its weights' shapes.  With ``tp`` None (one device) the same code
runs with no collective.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.parallel.tensor_parallel import (Axis, copy_to,
                                                  reduce_from, split_axis)
from .config import ModelConfig


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------- init

# Elements of the float32 temporary that _dense_init draws at a time (1 GiB):
# a full-width stacked weight (internvl2-26b's mlp.wi_gate holds 4.83e9) is
# filled chunk by chunk beside the weights themselves.
INIT_CHUNK = 1 << 28


def _dense_init(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Fill ``t`` in place: a normal truncated to +-2 sigma, drawn in float32
    from ``gen``, scaled by 1/sqrt(fan_in), cast to ``t``'s dtype.  The
    draw runs over chunks of rows of ``t`` viewed as (rows, last dim), at
    most ``INIT_CHUNK`` elements each, scaled in place."""
    flat = t.view(-1, t.shape[-1])
    step = max(1, INIT_CHUNK // flat.shape[1])
    for i in range(0, flat.shape[0], step):
        x = torch.empty(flat[i:i + step].shape, dtype=torch.float32,
                        device=t.device)
        nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0,
                              generator=gen)
        flat[i:i + step].copy_(x.mul_(fan_in ** -0.5))


def head_pad_mask(cfg: ModelConfig, device=None) -> torch.Tensor:
    """(padded_heads,) 1/0 float32 mask — real vs zero-padded q heads, laid
    out per KV group (see ModelConfig.padded_heads)."""
    h, kv, hp = cfg.n_heads, cfg.n_kv_heads, cfg.padded_heads
    g, g_pad = h // kv, hp // kv
    pos = torch.arange(hp, device=device) % g_pad
    return (pos < g).to(torch.float32)


def _param(shape, cfg: ModelConfig, device, dtype=None) -> nn.Parameter:
    """An uninitialised parameter in ``dtype``, the parameter dtype unless
    given (the router and recurrent gates are float32 in any model)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype or pdtype(cfg),
                                    device=device), requires_grad=False)


class Attention(nn.Module):
    """wq (L, d, H, hd), wk/wv (L, d, Hkv, hd), wo (L, H, hd, d), and with
    ``qk_norm`` q_norm/k_norm (L, hd); H is ``cfg.padded_heads``."""

    def __init__(self, cfg: ModelConfig, n_layers: int, device=None):
        super().__init__()
        self.cfg = cfg
        L, d, h, k, hd = (n_layers, cfg.d_model, cfg.padded_heads,
                          cfg.n_kv_heads, cfg.head_dim)
        self.wq = _param((L, d, h, hd), cfg, device)
        self.wk = _param((L, d, k, hd), cfg, device)
        self.wv = _param((L, d, k, hd), cfg, device)
        self.wo = _param((L, h, hd, d), cfg, device)
        if cfg.qk_norm:
            self.q_norm = _param((L, hd), cfg, device)
            self.k_norm = _param((L, hd), cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        mask = head_pad_mask(cfg, self.wq.device).to(self.wq.dtype)
        _dense_init(self.wq, cfg.d_model, gen)
        self.wq.mul_(mask[None, None, :, None])
        _dense_init(self.wk, cfg.d_model, gen)
        _dense_init(self.wv, cfg.d_model, gen)
        _dense_init(self.wo, cfg.n_heads * cfg.head_dim, gen)
        self.wo.mul_(mask[None, :, None, None])
        if cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


class Mlp(nn.Module):
    """SwiGLU: wi_gate, wi_up (L, d, f) and wo (L, f, d)."""

    def __init__(self, cfg: ModelConfig, n_layers: int, device=None):
        super().__init__()
        L, d, f = n_layers, cfg.d_model, cfg.d_ff
        self.wi_gate = _param((L, d, f), cfg, device)
        self.wi_up = _param((L, d, f), cfg, device)
        self.wo = _param((L, f, d), cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        d, f = self.wi_gate.shape[1:]
        _dense_init(self.wi_gate, d, gen)
        _dense_init(self.wi_up, d, gen)
        _dense_init(self.wo, f, gen)


class Norms(nn.Module):
    """norm_0 (before attention), norm_1 (before the MLP), ... each of shape
    ``lead + (d,)``, or nothing with ``nonparametric_norm``."""

    def __init__(self, cfg: ModelConfig, lead: tuple, n_norms: int = 2,
                 device=None):
        super().__init__()
        if not cfg.nonparametric_norm:
            for i in range(n_norms):
                setattr(self, f"norm_{i}",
                        _param(lead + (cfg.d_model,), cfg, device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            p.fill_(1.0)


class Stack(nn.Module):
    """Layer-stacked submodules (``blocks``, ``encoder``, ``cross``) whose
    parameters share their leading axis, the one a layer loop walks."""

    def __init__(self, **mods: nn.Module):
        super().__init__()
        for name, mod in mods.items():
            self.add_module(name, mod)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(gen)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s weights as ``{"attn": {...}, "norms": {...}, ...}``
        of views."""
        return {name: {k: p[i] for k, p in mod.named_parameters()}
                for name, mod in self.named_children()}

    def layers(self) -> list[dict]:
        """Every layer's weights as :meth:`layer` gives them, from one
        ``unbind`` of each stacked parameter: under autograd the stacked
        gradient is then one ``stack``, where ``layer(i)`` would add a
        full-size gradient for every layer."""
        per = {name: {k: p.unbind(0) for k, p in mod.named_parameters()}
               for name, mod in self.named_children()}
        depth = next(self.parameters()).shape[0]
        return [{name: {k: t[i] for k, t in d.items()}
                 for name, d in per.items()}
                for i in range(depth)]


# -------------------------------------------------------------------- norms

def rms_norm(x, weight=None, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(dt)


def layer_norm_nonparametric(x, eps: float = 1e-5):
    """olmo: LN without scale/bias parameters."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt)


def block_norm(x, norms: dict, idx: int, cfg: ModelConfig):
    if cfg.nonparametric_norm:
        return layer_norm_nonparametric(x, cfg.norm_eps)
    return rms_norm(x, norms[f"norm_{idx}"], cfg.norm_eps)


# --------------------------------------------------------------------- rope

def rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,) integer."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    # (..., S, 1, half): broadcast positions over heads and frequencies
    angles = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention

def _repeat_kv(t, group: int):
    """(B, S, Hkv, D) -> (B, S, Hkv * group, D), each kv head repeated
    ``group`` times in place (``jnp.repeat(t, group, axis=2)``).  An expand
    and a reshape: its gradient is a sum over the copies, with no
    ``repeat_interleave`` backward (a scatter on the card)."""
    b, s, h, d = t.shape
    return t[:, :, :, None, :].expand(b, s, h, group, d).reshape(
        b, s, h * group, d)


def attend(q, k, v, mask_bias, *, scale: float | None = None):
    """The JAX package's ``_attend``: q (B, Sq, H, hd); k, v (B, Sk, Hkv,
    hd); mask_bias (B|1, 1, Sq, Sk) additive float32.

    GQA by repeating the kv heads up to H; scores and softmax in float32;
    the probabilities cast to q's dtype before the product with v.  Scale
    ``hd ** -0.5`` unless given.  Differentiable by autograd: the flash
    attention kernel's gradient is this function's.
    """
    hd = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    scale = hd ** -0.5 if scale is None else scale
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v).to(q.dtype)


def causal_mask_bias(sq: int, sk: int, window: int | None, q_offset: int,
                     device=None) -> torch.Tensor:
    """(1, 1, Sq, Sk) additive float32 bias; query row i sits at absolute
    position ``q_offset + i`` and sees keys ``j <= q_offset + i`` (and
    ``j > q_offset + i - window`` with a window)."""
    row = q_offset + torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    keep = col <= row
    if window is not None:
        keep &= col > row - window
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)[None, None]


def plain_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    q_offset: int | None = None):
    """:func:`attend` behind the flash attention wrapper's signature: the
    plain attention that training compares the kernel with, and whose
    vector-Jacobian product is the kernel's gradient.  Query row i sits at
    ``q_offset + i`` (default ``Sk - Sq``)."""
    sq, sk = q.shape[1], k.shape[1]
    q_offset = sk - sq if q_offset is None else q_offset
    if causal:
        bias = causal_mask_bias(sq, sk, window, q_offset, q.device)
    elif window is None:
        bias = torch.zeros((1, 1, sq, sk), device=q.device)
    else:
        raise ValueError("attend has no window without causality")
    return attend(q, k, v, bias, scale=scale)


def _heads(p: dict, cfg: ModelConfig, tp: Axis | None):
    """The attention's model axis, or None when its q heads are whole on
    this rank (then the layer runs replicated), and ``(first q head, kv
    weights)``: ``wk``/``wv`` sliced to the kv heads this rank's q heads
    read when the kv heads are whole but the q heads split (a replicated
    tensor read locally, so through :func:`copy_to`)."""
    h = p["wq"].shape[-2]
    tp = None if tp is None else split_axis(tp, h, cfg.padded_heads)
    if tp is None:
        return None, 0, p["wk"], p["wv"]
    first = tp.offset(h)
    wk, wv = p["wk"], p["wv"]
    if split_axis(tp, wk.shape[-2], cfg.n_kv_heads) is None:
        g_pad = cfg.padded_heads // cfg.n_kv_heads
        if g_pad % h:
            raise NotImplementedError(
                f"{cfg.name}: {h} q heads a rank over kv groups of {g_pad}"
                " do not share one kv head; the local attention needs a "
                "whole kv group or whole kv heads")
        lo = first // g_pad
        wk, wv = (copy_to(w, tp)[:, lo:lo + 1] for w in (wk, wv))
    return tp, first, wk, wv


def apply_attention(p: dict, x, cfg: ModelConfig, *, positions,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, kv_cache=None,
                    cache_index=None, attention=flash_attention,
                    tp: Axis | None = None):
    """One self-attention layer; ``p`` holds the layer's weights.

    The caller picks the mask: query row i sits at absolute position
    ``q_offset + i`` and, when ``causal``, sees keys ``j <= q_offset + i``
    (and ``j > q_offset + i - window`` with a window); without causality it
    sees every key.  q and k are roped at ``positions``.  Without a cache,
    x (B, S, d) attends to itself.  With a cache ``(k_cache, v_cache)``,
    each (B, C, Hkv, hd), the new tokens' k/v are written in
    place at slot ``cache_index`` and x attends to the whole cache.
    ``attention`` is the attention core: the kernel's wrapper, or its plain
    version to check it.  ``tp``: the model axis; ``p`` then holds this
    rank's heads and the output is summed over the axis.
    """
    tp, first, wk, wv = _heads(p, cfg, tp)
    x = copy_to(x, tp)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    if cfg.qk_norm:
        q = rms_norm(q, copy_to(p["q_norm"], tp), cfg.norm_eps)
        k = rms_norm(k, copy_to(p["k_norm"], tp), cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache
        s = x.shape[1]
        if not 0 <= cache_index <= ck.shape[1] - s:
            raise IndexError(f"cache slots [{cache_index}, {cache_index + s})"
                             f" outside a cache of {ck.shape[1]}")
        ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
        k, v = ck, cv
    out = attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if cfg.padded_heads != cfg.n_heads:
        # zero the padded heads' outputs so they contribute nothing
        mask = head_pad_mask(cfg, out.device)[first:first + q.shape[2]]
        out = out * mask.to(out.dtype)[None, None, :, None]
    return reduce_from(torch.einsum("bshk,hkd->bsd", out, p["wo"]), tp)


def apply_cross_attention(p: dict, x, enc_out, *, attention=flash_attention,
                          cfg: ModelConfig | None = None,
                          tp: Axis | None = None):
    """whisper's decoder cross-attention: q from x (B, S, d), k and v
    projected from the encoder output (B, F, d); no rope, no mask, no
    head-pad mask (the JAX package's ``_dense_block`` cross branch).
    ``tp`` (with ``cfg``): the model axis, as for :func:`apply_attention`."""
    tp, _, wk, wv = _heads(p, cfg, tp)
    x, enc_out = copy_to(x, tp), copy_to(enc_out, tp)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", enc_out, wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, wv)
    out = attention(q, k, v, causal=False)
    return reduce_from(torch.einsum("bshk,hkd->bsd", out, p["wo"]), tp)


# -------------------------------------------------------------------- mlp

def apply_mlp(p: dict, x, tp: Axis | None = None):
    """SwiGLU; ``tp``: the model axis that ``p``'s hidden columns are split
    over (the caller's to decide), the output summed over it."""
    x = copy_to(x, tp)
    gate = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    up = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    h = nn.functional.silu(gate.float()).to(x.dtype) * up
    return reduce_from(torch.einsum("bsf,fd->bsd", h, p["wo"]), tp)
