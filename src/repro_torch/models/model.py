"""Model assembly for the dense family: init, training forward, prefill
and decode.

  init_model(cfg, seed=0, device=None)            -> DenseLM
  train_logits(model, tokens, remat=None)         -> logits (B,S,V), aux
  prefill(model, tokens, cache_len)               -> logits_last, caches
  decode_step(model, token, caches, index)        -> logits, caches

The counterpart of the JAX package's ``models/model.py`` for the dense
family (granite, qwen3, olmo, starcoder2): one Python loop over the
layer-stacked weights takes the place of ``jax.lax.scan``, and
``torch.utils.checkpoint`` around each block takes the place of
``jax.checkpoint``.  Caches are ``{"kv": (k, v)}`` of (L, B, C, Hkv, hd)
tensors that prefill fills and decode steps update in place (the JAX
package returns new arrays).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from .config import ModelConfig
from .layers import (Blocks, _dense_init, _param, apply_attention, apply_mlp,
                     block_norm, layer_norm_nonparametric, pdtype, rms_norm,
                     rope)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (slice 10 "
            "of the port: the non-dense families and ring caches)")


class DenseLM(nn.Module):
    """embed (V_pad, d); head (d, V_pad) unless tied; final_norm (d,) unless
    non-parametric; and the decoder ``blocks``.  Shapes and names follow the
    JAX package's parameter tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.embed = _param((cfg.padded_vocab, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.d_model, cfg.padded_vocab), cfg, device)
        if not cfg.nonparametric_norm:
            self.final_norm = _param((cfg.d_model,), cfg, device)
        self.blocks = Blocks(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        _dense_init(self.embed, self.cfg.d_model, gen)
        if not self.cfg.tie_embeddings:
            _dense_init(self.head, self.cfg.d_model, gen)
        if not self.cfg.nonparametric_norm:
            self.final_norm.fill_(1.0)
        for mod in self.blocks.children():
            mod.reset_parameters(gen)


def logical_axes(cfg: ModelConfig) -> dict:
    """The logical axis names of every parameter, keyed as the parameter
    tree (``repro_torch.convert.param_tree``): the JAX ``init_model``'s
    ``axes`` for the dense family, which ``parallel/sharding.py`` maps onto
    a mesh."""
    _require_dense(cfg)
    attn = {"wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed")}
    if cfg.qk_norm:
        attn["q_norm"] = attn["k_norm"] = ("layers", "head_dim")
    norms = {} if cfg.nonparametric_norm else {
        f"norm_{i}": ("layers", "embed") for i in range(2)}
    axes = {"embed": ("vocab", "embed"),
            "blocks": {"attn": attn, "norms": norms,
                       "mlp": {"wi_gate": ("layers", "embed", "mlp"),
                               "wi_up": ("layers", "embed", "mlp"),
                               "wo": ("layers", "mlp", "embed")}}}
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    if not cfg.nonparametric_norm:
        axes["final_norm"] = ("embed",)
    return axes


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None) -> DenseLM:
    """A randomly initialised model on ``device`` (the card by default), its
    weights drawn there from a ``torch.Generator`` seeded with ``seed``.
    The draws differ from the JAX package's ``jax.random`` ones: to run
    both packages on the same weights, carry them across with
    ``repro_torch.convert.params_from_numpy``."""
    device = resolve_device(device)
    model = DenseLM(cfg, device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


# ============================================================ body helpers

def _dense_block(bp: dict, x, cfg: ModelConfig, *, positions, q_offset=0,
                 kv_cache=None, cache_index=None, attention=flash_attention):
    """One decoder block: attention and SwiGLU, each behind a norm."""
    h = block_norm(x, bp["norms"], 0, cfg)
    x = x + apply_attention(bp["attn"], h, cfg, positions=positions,
                            q_offset=q_offset, kv_cache=kv_cache,
                            cache_index=cache_index, attention=attention)
    h = block_norm(x, bp["norms"], 1, cfg)
    return x + apply_mlp(bp["mlp"], h)


class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]``, whose gradient is the product of the tokens'
    one-hot rows with the output gradient.  Indexing's own backward
    accumulates repeated tokens with atomics on the card (and in parallel
    on the CPU), so two runs of one step could round differently; a matrix
    product sums in a fixed order, which a bitwise resume needs."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=tokens.device)
        one_hot = (tokens.reshape(-1, 1) == rows).to(grad.dtype)
        return one_hot.T @ grad.reshape(-1, grad.shape[-1]), None


def embed_tokens(model: DenseLM, tokens):
    x = _EmbedLookup.apply(model.embed, tokens)       # (B, S, d) gather
    return x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype)


def _final_logits(model: DenseLM, x):
    cfg = model.cfg
    if cfg.nonparametric_norm:
        x = layer_norm_nonparametric(x, cfg.norm_eps)
    else:
        x = rms_norm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.head
    logits = torch.einsum("bsd,dv->bsv", x, head).float()
    if cfg.padded_vocab != cfg.vocab_size:            # mask pad columns
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


# ============================================================== train mode

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of matrix
    products without batch dimensions (the projections; ``einsum`` lowers
    them to a ``bmm`` over a batch of one) and recompute the rest."""
    if op in _MATMULS or (op is torch.ops.aten.bmm.default
                          and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """``fn`` under activation checkpointing: ``"full"`` saves only the
    inputs and recomputes the block in the backward pass, ``"block"`` also
    saves the projections' outputs, ``"none"`` returns ``fn``."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "block":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {remat!r}: one of none, block, full")


def train_logits(model: DenseLM, tokens, *, remat: str | None = None,
                 attention=flash_attention):
    """tokens (B, S) -> (logits (B, S, V_pad) float32, aux).

    Every block runs under ``remat`` (``cfg.remat`` unless given); pad
    vocabulary columns are -1e30; ``aux`` is 0.0, the dense family having
    no auxiliary loss.  ``attention`` is the attention core: the kernel's
    wrapper, whose gradient is the plain ``attend``'s, or
    ``layers.plain_attention`` to check it."""
    cfg = model.cfg
    s = tokens.shape[1]
    x = embed_tokens(model, tokens)
    positions = torch.arange(s, device=x.device)[None, :]
    block = _maybe_remat(functools.partial(
        _dense_block, cfg=cfg, positions=positions, attention=attention),
        cfg.remat if remat is None else remat)
    for bp in model.blocks.layers():
        x = block(bp, x)
    return _final_logits(model, x), torch.zeros((), device=x.device)


# ======================================================== prefill / decode

def make_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device=None) -> dict:
    """Zeroed decode caches for the whole stack: (k, v) of
    (L, B, C, Hkv, hd) in the parameter dtype."""
    _require_dense(cfg)
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window ring caches are not ported yet "
            "(slice 10 of the port: the non-dense families and ring caches)")
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": tuple(torch.zeros(shape, dtype=pdtype(cfg), device=device)
                        for _ in range(2))}


@torch.no_grad()
def prefill(model: DenseLM, tokens, cache_len: int, *,
            attention=flash_attention):
    """Run the whole prompt (B, S); return (last-position logits (B, V_pad)
    float32, filled caches).  Each layer first fills its cache from the
    block input — its own K/V projection, k_norm and rope of the normed
    input — and then runs the block with attention over the prompt alone,
    the order of operations of the JAX package.  ``attention`` is the
    attention core: the kernel's wrapper, or its plain version to check
    the kernel against."""
    cfg = model.cfg
    b, s = tokens.shape
    x = embed_tokens(model, tokens)
    caches = make_caches(cfg, b, cache_len, x.device)
    ck, cv = caches["kv"]
    c = ck.shape[2]
    positions = torch.arange(s, device=x.device)[None, :]
    tail = slice(s - c, s) if s >= c else slice(0, s)
    for i in range(cfg.n_layers):
        bp = model.blocks.layer(i)
        h_in = block_norm(x, bp["norms"], 0, cfg)[:, tail]
        kh = torch.einsum("bsd,dhk->bshk", h_in, bp["attn"]["wk"])
        vh = torch.einsum("bsd,dhk->bshk", h_in, bp["attn"]["wv"])
        if cfg.qk_norm:
            kh = rms_norm(kh, bp["attn"]["k_norm"], cfg.norm_eps)
        kh = rope(kh, positions[:, tail], cfg.rope_theta)
        ck[i, :, :kh.shape[1]] = kh.to(ck.dtype)
        cv[i, :, :vh.shape[1]] = vh.to(cv.dtype)
        x = _dense_block(bp, x, cfg, positions=positions, q_offset=0,
                         attention=attention)
    return _final_logits(model, x[:, -1:])[:, 0], caches


@torch.no_grad()
def decode_step(model: DenseLM, token, caches: dict, index: int):
    """One decode step: token (B, 1) at absolute position ``index``, which
    is also its cache slot.  Attends to cache slots 0..index.  Returns
    (logits (B, V_pad) float32, caches), the caches updated in place."""
    cfg = model.cfg
    x = embed_tokens(model, token)
    positions = torch.full((1, 1), index, device=x.device)
    ck, cv = caches["kv"]
    for i in range(cfg.n_layers):
        x = _dense_block(model.blocks.layer(i), x, cfg, positions=positions,
                         q_offset=index, kv_cache=(ck[i], cv[i]),
                         cache_index=index)
    return _final_logits(model, x)[:, 0], caches
