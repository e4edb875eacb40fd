"""Model assembly for every family: init, training forward, prefill and
decode.

  init_model(cfg, seed=0, device=None)                      -> LM
  train_logits(model, tokens, frontend_embeds=None, tp=None) -> logits, aux
  prefill(model, tokens, cache_len, frontend_embeds=None, tp=None)
                                                            -> logits, caches
  decode_step(model, token, caches, index, enc_out=None, tp=None)
                                                            -> logits, caches

The counterpart of the JAX package's ``models/model.py``: dense (granite,
qwen3, olmo, starcoder2), moe (mixtral, kimi-k2), hybrid (hymba: attention
and mamba heads side by side), ssm (xlstm: mLSTM and sLSTM blocks, no
attention), vlm (internvl2: stub patch embeddings prepended to the text)
and audio (whisper: a non-causal encoder over stub frames, a decoder with
cross-attention).  One Python loop over the layer-stacked weights takes
the place of ``jax.lax.scan``, and ``torch.utils.checkpoint`` around each
block takes the place of ``jax.checkpoint``.

Masks follow the JAX package layer by layer: in train and prefill a
sliding-window config attends within its window, except on its global
layers (``lid % global_attn_every == 0``); a decode step against a ring
cache sees every written slot, with no window, global layers included.

Under the sharded steps ``train_logits``, ``prefill`` and ``decode_step``
take ``tp``, one rank's plan of the mesh (``parallel/tensor_parallel.py``),
and the model's parameters hold the rank's local shards.  Each layer's
weights are all-gathered over the data axes just before use (in training
inside the remat, so the recompute gathers again), keeping their split
over the ``model`` axis: the attention, MLP and experts compute their own
heads, columns and experts, hymba's mamba heads their own channels, the
xLSTM blocks their own heads and columns (``models/ssm.py``), the
embedding and the logits their own vocabulary rows.  The (B, S, d)
activations between blocks are the rank's batch rows, whole along d and
the same on every rank of the model axis (the JAX ``act_spec``).  Under
``tp`` the caches are the rank's shards in the JAX cache layout
(``launch/specs.CACHE_AXES``): k/v split along their slots (``kv_seq``),
the mamba state and conv tail along d, the mLSTM states by heads and the
sLSTM states along d, wherever the model axis divides them.  Prefill fills
the rank's slots from k/v of every kv head at those slots' positions;
decode attends by slices of the cache (``models/layers.py``).

Caches, which prefill fills and decode steps update in place (the JAX
package returns new arrays):
- ``"kv"``: (k, v) of (L, B, C, Hkv, hd); with a sliding window a ring of
  C = min(cache_len, window) slots, position p in slot p % C;
- ``"mamba"`` (hybrid): (ssm state (L, B, d, N) float32, conv tail
  (L, B, K - 1, d));
- ``"enc_out"`` (audio, after prefill): the encoder output (B, F, d);
- ``"states"`` (ssm, in place of all of these): the mLSTM (C, n, m) of
  (n_rep, rep - 1, B, ...) and the sLSTM (c, n, h, m) of (n_rep, B, d).

A ``HymbaConfig`` (hymba at its published structure: global layers by id,
meta tokens, k/v shared between layers) has caches of its own kinds:
``prefill``, ``decode_step`` and ``make_caches`` hand it to
``models/hymba.py``, on one device; ``train_logits`` refuses it.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.parallel.tensor_parallel import (Axis, TensorParallel,
                                                  copy_to, gather_from,
                                                  model_axis, reduce_from,
                                                  split_axis)
from .config import HymbaConfig, ModelConfig
from .layers import (Attention, Mlp, Norms, Stack, _dense_init, _param,
                     apply_attention, apply_cross_attention, apply_mlp,
                     block_norm, layer_norm_nonparametric, pdtype, rms_norm,
                     rope)
from .moe import Moe, apply_moe
from .ssm import (Mamba, Mlstm, Slstm, apply_mamba, apply_mlstm,
                  apply_slstm, mlstm_state, slstm_state)


def _xlstm_pattern(cfg: ModelConfig) -> tuple[int, int]:
    """(rep, n_rep): each of n_rep repetitions is rep - 1 mLSTM blocks and
    one sLSTM block."""
    rep = cfg.slstm_every or cfg.n_layers
    if cfg.n_layers % rep:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"whole number of {rep}-block repetitions")
    return rep, cfg.n_layers // rep


class LM(nn.Module):
    """embed (V_pad, d); head (d, V_pad) unless tied; final_norm (d,) unless
    non-parametric; the decoder ``blocks``; with an encoder the ``encoder``
    and ``cross`` stacks; with a frontend ``frontend_proj`` (d, d); with a
    ``HymbaConfig`` its meta tokens ``meta`` (M, d).  Shapes, dtypes and
    names follow the JAX package's parameter tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, L = cfg.d_model, cfg.n_layers
        self.embed = _param((cfg.padded_vocab, d), cfg, device)
        if not cfg.tie_embeddings:
            self.head = _param((d, cfg.padded_vocab), cfg, device)
        if not cfg.nonparametric_norm:
            self.final_norm = _param((d,), cfg, device)
        if cfg.family == "ssm":
            rep, n_rep = _xlstm_pattern(cfg)
            self.blocks = Stack(
                mlstm=Mlstm(cfg, (n_rep, rep - 1), device) if rep > 1
                else Stack(),
                slstm=Slstm(cfg, (n_rep,), device),
                norms=Norms(cfg, (n_rep, rep), device=device))
        else:
            mods = dict(attn=Attention(cfg, L, device),
                        norms=Norms(cfg, (L,), device=device))
            if cfg.family == "hybrid":
                mods["mamba"] = Mamba(cfg, L, device)
            if cfg.is_moe:
                mods["moe"] = Moe(cfg, L, device)
            else:
                mods["mlp"] = Mlp(cfg, L, device)
            self.blocks = Stack(**mods)
        if cfg.encoder_layers:
            e = cfg.encoder_layers
            self.encoder = Stack(attn=Attention(cfg, e, device),
                                 mlp=Mlp(cfg, e, device),
                                 norms=Norms(cfg, (e,), device=device))
            self.cross = Stack(attn=Attention(cfg, L, device),
                               norms=Norms(cfg, (L,), 1, device=device))
        if cfg.frontend is not None:
            self.frontend_proj = _param((d, d), cfg, device)
        if isinstance(cfg, HymbaConfig):
            self.meta = _param((cfg.meta_tokens, d), cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        d = self.cfg.d_model
        _dense_init(self.embed, d, gen)
        if not self.cfg.tie_embeddings:
            _dense_init(self.head, d, gen)
        if not self.cfg.nonparametric_norm:
            self.final_norm.fill_(1.0)
        for mod in self.children():
            mod.reset_parameters(gen)
        if self.cfg.frontend is not None:
            _dense_init(self.frontend_proj, d, gen)
        if isinstance(self.cfg, HymbaConfig):   # unit scale, as the
            _dense_init(self.meta, 1, gen)      # scaled token embeddings


def _attn_axes(cfg: ModelConfig) -> dict:
    axes = {"wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed")}
    if cfg.qk_norm:
        axes["q_norm"] = axes["k_norm"] = ("layers", "head_dim")
    return axes


def _norm_axes(cfg: ModelConfig, n_norms: int = 2) -> dict:
    return {} if cfg.nonparametric_norm else {
        f"norm_{i}": ("layers", "embed") for i in range(n_norms)}


MLP_AXES = {"wi_gate": ("layers", "embed", "mlp"),
            "wi_up": ("layers", "embed", "mlp"),
            "wo": ("layers", "mlp", "embed")}
MAMBA_AXES = {"in_proj": ("layers", "embed", "mlp"),
              "conv_w": ("layers", None, "mlp"),
              "x_proj": ("layers", "embed", None),
              "a_log": ("layers", "mlp", None),
              "d_skip": ("layers", "mlp"),
              "out_proj": ("layers", "mlp", "embed")}


def _moe_axes(cfg: ModelConfig) -> dict:
    emlp = "mlp" if cfg.moe_tp else "expert_mlp"
    eax = None if cfg.moe_tp else "expert"
    axes = {"router": ("layers", "embed", "expert"),
            "w_gate": ("layers", eax, "embed", emlp),
            "w_up": ("layers", eax, "embed", emlp),
            "w_down": ("layers", eax, emlp, "embed")}
    if cfg.n_shared_experts:
        axes.update(shared_gate=("layers", "embed", "mlp"),
                    shared_up=("layers", "embed", "mlp"),
                    shared_down=("layers", "mlp", "embed"))
    return axes


def logical_axes(cfg: ModelConfig) -> dict:
    """The logical axis names of every parameter, keyed as the parameter
    tree (``repro_torch.convert.param_tree``): the JAX ``init_model``'s
    ``axes``, which ``parallel/sharding.py`` maps onto a mesh."""
    axes: dict = {"embed": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    if not cfg.nonparametric_norm:
        axes["final_norm"] = ("embed",)
    if cfg.family == "ssm":
        rep, _ = _xlstm_pattern(cfg)
        mlstm = {} if rep == 1 else {
            "wqkv": ("repeat", "layers", "embed", None, "heads", "head_dim"),
            "wgates": ("repeat", "layers", "embed", None, "heads"),
            "wo": ("repeat", "layers", "heads", "head_dim", "embed")}
        axes["blocks"] = {
            "mlstm": mlstm,
            "slstm": {"wx": ("repeat", "embed", None, "mlp"),
                      "wr": ("repeat", "embed", None, "mlp")},
            "norms": {k: ("repeat",) + v
                      for k, v in _norm_axes(cfg).items()}}
        return axes
    blocks = {"attn": _attn_axes(cfg), "norms": _norm_axes(cfg)}
    if cfg.family == "hybrid":
        blocks["mamba"] = dict(MAMBA_AXES)
    if cfg.is_moe:
        blocks["moe"] = _moe_axes(cfg)
    else:
        blocks["mlp"] = dict(MLP_AXES)
    axes["blocks"] = blocks
    if cfg.encoder_layers:
        axes["encoder"] = {"attn": _attn_axes(cfg), "mlp": dict(MLP_AXES),
                           "norms": _norm_axes(cfg)}
        axes["cross"] = {"attn": _attn_axes(cfg),
                         "norms": _norm_axes(cfg, 1)}
    if cfg.frontend is not None:
        axes["frontend_proj"] = ("embed", "embed")
    if isinstance(cfg, HymbaConfig):
        axes["meta"] = (None, "embed")
    return axes


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None) -> LM:
    """A randomly initialised model on ``device`` (the card by default), its
    weights drawn there from a ``torch.Generator`` seeded with ``seed``.
    The draws differ from the JAX package's ``jax.random`` ones: to run
    both packages on the same weights, carry them across with
    ``repro_torch.convert.params_from_numpy``."""
    device = resolve_device(device)
    model = LM(cfg, device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


# ============================================================ body helpers

def _layer_window(cfg: ModelConfig, lid: int) -> int | None:
    """Layer ``lid``'s window in train and prefill: the config's, except on
    a global layer of a windowed config with ``global_attn_every``."""
    if cfg.sliding_window and cfg.global_attn_every \
            and lid % cfg.global_attn_every == 0:
        return None
    return cfg.sliding_window


def _dense_block(bp: dict, x, cfg: ModelConfig, *, positions, window=None,
                 q_offset=0, kv_cache=None, cache_index=None,
                 mamba_state=None, enc_out=None,
                 cross_p=None, attention=flash_attention,
                 tp: Axis | None = None, seq: Axis | None = None):
    """One decoder block: attention (with hymba's mamba heads beside it),
    whisper's cross-attention, then the MLP or the MoE, each behind a norm.
    Returns (x, aux: the MoE's float32 router loss, else 0.0); a
    ``mamba_state`` handed in is written in place without autograd.
    ``tp``: the model axis that ``bp``'s weights are split over; ``seq``:
    the axis the kv cache's slots are split over."""
    aux = 0.0
    h = block_norm(x, bp["norms"], 0, cfg)
    attn_out = apply_attention(bp["attn"], h, cfg, positions=positions,
                               window=window, q_offset=q_offset,
                               kv_cache=kv_cache, cache_index=cache_index,
                               attention=attention, tp=tp, seq=seq)
    if cfg.family == "hybrid":
        state, conv_state = mamba_state if mamba_state is not None \
            else (None, None)
        m_out, _ = apply_mamba(bp["mamba"], h, cfg, state=state,
                               conv_state=conv_state, tp=tp)
        # hymba: parallel attention and mamba heads, averaged after each
        # branch's normalization
        attn_out = 0.5 * (rms_norm(attn_out, eps=cfg.norm_eps)
                          + rms_norm(m_out, eps=cfg.norm_eps))
    x = x + attn_out
    if cross_p is not None:
        if enc_out is None:
            raise ValueError(f"{cfg.name}: cross-attention needs the "
                             "encoder output (enc_out)")
        h = block_norm(x, cross_p["norms"], 0, cfg)
        x = x + apply_cross_attention(cross_p["attn"], h, enc_out,
                                      attention=attention, cfg=cfg, tp=tp)
    h = block_norm(x, bp["norms"], 1, cfg)
    if cfg.is_moe:
        ff, aux = apply_moe(bp["moe"], h, cfg, tp=tp)   # (B, S, d), aux
    else:
        ff = apply_mlp(bp["mlp"], h,
                       split_axis(tp, bp["mlp"]["wo"].shape[0], cfg.d_ff))
    return x + ff, aux


class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]``, whose gradient is the product of the tokens'
    one-hot rows with the output gradient.  Indexing's own backward
    accumulates repeated tokens with atomics on the card (and in parallel
    on the CPU), so two runs of one step could round differently; a matrix
    product sums in a fixed order, which a bitwise resume needs.

    With ``first`` (not None) the table holds the vocabulary rows
    ``first, first + 1, ...`` only: a token outside them looks up zeros
    and has no one-hot row."""

    @staticmethod
    def forward(ctx, table, tokens, first):
        rows = table.shape[0]
        ctx.rows = rows
        if first is None:
            ctx.save_for_backward(tokens)
            return table[tokens]
        idx = tokens - first
        ctx.save_for_backward(idx)
        inside = (idx >= 0) & (idx < rows)
        return torch.where(inside[..., None],
                           table[idx.clamp(0, rows - 1)], 0)

    @staticmethod
    def backward(ctx, grad):
        tokens, = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=tokens.device)
        one_hot = (tokens.reshape(-1, 1) == rows).to(grad.dtype)
        return one_hot.T @ grad.reshape(-1, grad.shape[-1]), None, None


def embed_tokens(model: LM, tokens, *, table=None, tp: Axis | None = None):
    """The scaled embeddings (B, S, d) of ``tokens``; ``table`` (the model's
    unless given) may hold this rank's vocabulary rows of ``tp``, whose
    lookups are then summed over it."""
    table = model.embed if table is None else table
    vt = split_axis(tp, table.shape[0], model.cfg.padded_vocab)
    first = None if vt is None else vt.offset(table.shape[0])
    x = reduce_from(_EmbedLookup.apply(table, tokens, first), vt)
    return x * torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype)


def _prepend_frontend(x, frontend_embeds, proj):
    """vlm: project the stub patch embeddings (B, F, d) by ``proj`` and put
    them before the text, dropping the last F text positions so that S
    stays."""
    fe = torch.einsum("bsd,de->bse", frontend_embeds.to(x.dtype), proj)
    return torch.cat([fe, x[:, :x.shape[1] - fe.shape[1]]], dim=1)


def _final_logits(model: LM, x, tp: TensorParallel | None = None,
                  table=None):
    """Logits (..., V_pad) float32, pad columns -1e30.  Under ``tp`` the
    rank's vocabulary columns only, from the gathered ``table`` (the
    embedding, gathered once by the caller) or head."""
    cfg = model.cfg
    if cfg.nonparametric_norm:
        x = layer_norm_nonparametric(x, cfg.norm_eps)
    else:
        x = rms_norm(x, _weight(model, "final_norm", tp), cfg.norm_eps)
    if cfg.tie_embeddings:
        head = (model.embed if table is None else table).T
    else:
        head = _weight(model, "head", tp)
    vt = split_axis(model_axis(tp), head.shape[1], cfg.padded_vocab)
    logits = torch.einsum("bsd,dv->bsv", copy_to(x, vt), head).float()
    if cfg.padded_vocab != cfg.vocab_size:            # mask pad columns
        first = 0 if vt is None else vt.offset(head.shape[1])
        col = torch.arange(first, first + head.shape[1],
                           device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


def _weight(model: LM, name: str, tp: TensorParallel | None):
    """Top-level parameter ``name`` in its compute form: under ``tp``
    gathered over the data axes from the rank's shard."""
    t = getattr(model, name)
    return t if tp is None else tp.weight(name, t)


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


def _train_block(bp, cp, x, *, cfg, positions, window, enc_out, attention,
                 tp=None):
    if tp is not None:      # the layer's FSDP gathers, inside the remat
        bp = tp.weights(bp, "blocks")
        cp = None if cp is None else tp.weights(cp, "cross")
    return _dense_block(bp, x, cfg, positions=positions, window=window,
                        enc_out=enc_out, cross_p=cp, attention=attention,
                        tp=model_axis(tp))


def _encoder_layer(bp, x, *, cfg, positions, attention, tp=None):
    if tp is not None:
        bp = tp.weights(bp, "encoder")
    ax = model_axis(tp)
    # The JAX encoder calls apply_attention with its default causal=True,
    # which ropes q and k, and an all-zero mask: rope without causality.
    h = block_norm(x, bp["norms"], 0, cfg)
    x = x + apply_attention(bp["attn"], h, cfg, positions=positions,
                            causal=False, attention=attention, tp=ax)
    h = block_norm(x, bp["norms"], 1, cfg)
    return x + apply_mlp(bp["mlp"], h,
                         split_axis(ax, bp["mlp"]["wo"].shape[0], cfg.d_ff))


def _run_encoder(model: LM, frontend_embeds, *, remat: str = "none",
                 attention=flash_attention, tp: TensorParallel | None = None):
    """whisper's encoder: non-causal self-attention over the stub frame
    embeddings (B, F, d), projected by ``frontend_proj``."""
    cfg = model.cfg
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name}: the encoder needs frontend "
                         "embeddings (B, frames, d_model)")
    x = frontend_embeds.to(pdtype(cfg))
    if cfg.frontend is not None:
        x = torch.einsum("bsd,de->bse", x,
                         _weight(model, "frontend_proj", tp))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    layer = _maybe_remat(functools.partial(
        _encoder_layer, cfg=cfg, positions=positions, attention=attention,
        tp=tp), remat)
    for bp in model.encoder.layers():
        x = layer(bp, x)
    return x


def _xlstm_states(cfg: ModelConfig, batch: int, device=None, model=None):
    """Zeroed states of the xLSTM stack; with ``model``, of the widths its
    parameters hold (a rank's local heads and columns under ``tp``)."""
    rep, n_rep = _xlstm_pattern(cfg)
    heads = width = None
    if model is not None:
        width = model.blocks.slstm.wx.shape[-1]
        if rep > 1:
            heads = model.blocks.mlstm.wqkv.shape[-2]
    return (mlstm_state((n_rep, rep - 1), batch, cfg, device, heads=heads),
            slstm_state((n_rep,), batch, cfg, device, width=width))


def _xlstm_rep(bp, x, mst, sst, *, cfg, tp=None):
    """One repetition: rep - 1 mLSTM blocks then one sLSTM block, each a
    residual behind its norm (xLSTM blocks carry no separate FFN)."""
    if tp is not None:      # the layer's FSDP gathers
        bp = tp.weights(bp, "blocks")
    ax = model_axis(tp)
    rep, _ = _xlstm_pattern(cfg)
    norm = bp["norms"]["norm_0"]
    new = []
    for i in range(rep - 1):
        h = rms_norm(x, norm[i], cfg.norm_eps)
        out, st = apply_mlstm({k: w[i] for k, w in bp["mlstm"].items()}, h,
                              cfg, state=tuple(t[i] for t in mst), tp=ax)
        x = x + out
        new.append(st)
    h = rms_norm(x, norm[rep - 1], cfg.norm_eps)
    out, sst = apply_slstm(bp["slstm"], h, cfg, state=sst, tp=ax)
    mst = tuple(torch.stack(z) for z in zip(*new)) if new else mst
    return x + out, mst, sst


def _run_xlstm(model: LM, x, states=None, *, remat: str = "none",
               tp: TensorParallel | None = None):
    """The xLSTM stack over x (B, S, d) from ``states`` (zeros if None);
    returns (x, new states) in the layout of ``make_caches``."""
    cfg = model.cfg
    if states is None:
        states = _xlstm_states(cfg, x.shape[0], x.device, model)
    m_state, s_state = states
    body = _maybe_remat(functools.partial(_xlstm_rep, cfg=cfg, tp=tp), remat)
    new_m, new_s = [], []
    for r, bp in enumerate(model.blocks.layers()):
        x, mst, sst = body(bp, x, tuple(t[r] for t in m_state),
                           tuple(t[r] for t in s_state))
        new_m.append(mst)
        new_s.append(sst)
    return x, tuple(tuple(torch.stack(z) for z in zip(*per))
                    for per in (new_m, new_s))


def train_logits(model: LM, tokens, *, frontend_embeds=None,
                 remat: str | None = None, attention=flash_attention,
                 tp: TensorParallel | None = None):
    """tokens (B, S) -> (logits (B, S, V_pad) float32, aux float32).

    ``frontend_embeds`` (B, F, d): the VLM's patch embeddings, prepended
    in place of the last F text positions, or the audio encoder's frames.
    Every block runs under ``remat`` (``cfg.remat`` unless given); pad
    vocabulary columns are -1e30; ``aux`` is the MoE router loss summed
    over layers (0 for the other families).  ``attention`` is the
    attention core: the kernel's wrapper, whose gradient is the plain
    ``attend``'s, or ``layers.plain_attention`` to check it.

    ``tp``: the sharded step's plan, the model's parameters then the
    rank's local shards and ``tokens`` its batch rows; the logits are the
    rank's vocabulary columns (B, S, V_pad / model) where the vocabulary
    is split over the model axis."""
    cfg = model.cfg
    if isinstance(cfg, HymbaConfig):
        raise NotImplementedError(f"{cfg.name}: the published hymba "
                                  "structure is served only "
                                  "(models/hymba.py)")
    s = tokens.shape[1]
    remat = cfg.remat if remat is None else remat
    table = _weight(model, "embed", tp)
    x = embed_tokens(model, tokens, table=table, tp=model_axis(tp))
    if cfg.family == "vlm" and frontend_embeds is not None:
        x = _prepend_frontend(x, frontend_embeds,
                              _weight(model, "frontend_proj", tp))
    aux = torch.zeros((), device=x.device)
    if cfg.family == "ssm":
        x = _run_xlstm(model, x, remat=remat, tp=tp)[0]
        return _final_logits(model, x, tp, table), aux
    enc_out = _run_encoder(model, frontend_embeds, remat=remat,
                           attention=attention, tp=tp) \
        if cfg.encoder_layers else None
    positions = torch.arange(s, device=x.device)[None, :]
    block = _maybe_remat(functools.partial(
        _train_block, cfg=cfg, positions=positions, enc_out=enc_out,
        attention=attention, tp=tp), remat)
    cross = model.cross.layers() if cfg.encoder_layers \
        else [None] * cfg.n_layers
    for lid, (bp, cp) in enumerate(zip(model.blocks.layers(), cross)):
        x, a = block(bp, cp, x, window=_layer_window(cfg, lid))
        aux = aux + a
    return _final_logits(model, x, tp, table), aux


# ======================================================== prefill / decode

def _cache_slots(cfg: ModelConfig, cache_len: int) -> int:
    """Slots of the whole k/v cache: ``cache_len``, or a ring of
    min(cache_len, window) with a sliding window."""
    return cache_len if cfg.sliding_window is None \
        else min(cache_len, cfg.sliding_window)


def make_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device=None) -> dict:
    """Zeroed decode caches for the whole stack (the module docstring's
    layout); a sliding-window config gets a ring of min(cache_len, window)
    slots.  A ``HymbaConfig``'s are ``models/hymba.py``'s."""
    if isinstance(cfg, HymbaConfig):
        from . import hymba
        return hymba.make_caches(cfg, batch, cache_len, device)
    if cfg.family == "ssm":
        return {"states": _xlstm_states(cfg, batch, device)}
    dt = pdtype(cfg)
    shape = (cfg.n_layers, batch, _cache_slots(cfg, cache_len),
             cfg.n_kv_heads, cfg.head_dim)
    caches = {"kv": tuple(torch.zeros(shape, dtype=dt, device=device)
                          for _ in range(2))}
    if cfg.family == "hybrid":
        caches["mamba"] = (
            torch.zeros((cfg.n_layers, batch, cfg.d_model, cfg.ssm_state),
                        dtype=torch.float32, device=device),
            torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_model),
                        dtype=dt, device=device))
    return caches


def _slot_axis(tp: TensorParallel | None) -> Axis | None:
    """The axis the k/v caches' slots are split over, if any."""
    return tp.model if tp is not None and tp.kv_slots else None


def _serve_layer(model: LM, i: int, tp: TensorParallel | None):
    """Layer ``i``'s block and cross-attention weights (None without an
    encoder) in their compute form: under ``tp`` gathered over the data
    axes."""
    bp = model.blocks.layer(i)
    cp = model.cross.layer(i) if model.cfg.encoder_layers else None
    if tp is not None:
        bp = tp.weights(bp, "blocks")
        cp = None if cp is None else tp.weights(cp, "cross")
    return bp, cp


@torch.no_grad()
def prefill(model: LM, tokens, cache_len: int, *, frontend_embeds=None,
            attention=flash_attention, tp: TensorParallel | None = None,
            caches: dict | None = None):
    """Run the whole prompt (B, S); return (last-position logits (B, V_pad)
    float32, filled caches).  Each layer first fills its cache from the
    block input — its own K/V projection, k_norm and rope of the normed
    input, the last C positions, rolled on a ring so that position p lands
    in slot p % C — and then runs the block over the prompt alone with the
    layer's mask, the order of operations of the JAX package.
    ``frontend_embeds`` as for :func:`train_logits`; the audio encoder's
    output is kept as ``caches["enc_out"]``.  ``attention`` is the
    attention core: the kernel's wrapper, or its plain version to check the
    kernel against.

    ``tp``: the sharded serve step's plan (``serve/serve_step.py``), the
    parameters the rank's shards and ``tokens`` its batch rows; the logits
    are then the rank's vocabulary columns.  Where the caches' slots are
    split over the model axis (the JAX layout), the rank fills its own
    slots (after the roll on a ring) with k/v of every kv head, from the
    replicated normed input; where they are split by kv heads, its heads'
    k/v at every slot.  ``caches``: the zeroed caches to fill (under ``tp``
    the rank's shards, which the serve step makes from their placements);
    made here when None.  A ``HymbaConfig`` runs ``models/hymba.py``'s
    prefill."""
    cfg = model.cfg
    if isinstance(cfg, HymbaConfig):
        from . import hymba
        return hymba.prefill(model, tokens, cache_len, attention=attention,
                             tp=tp)
    b, s = tokens.shape
    ax = model_axis(tp)
    table = _weight(model, "embed", tp)
    x = embed_tokens(model, tokens, table=table, tp=ax)
    if cfg.family == "vlm" and frontend_embeds is not None:
        x = _prepend_frontend(x, frontend_embeds,
                              _weight(model, "frontend_proj", tp))
    if cfg.family == "ssm":
        x, states = _run_xlstm(model, x, tp=tp)
        return _final_logits(model, x[:, -1:], tp, table)[:, 0], {
            "states": states}
    enc_out = _run_encoder(model, frontend_embeds, attention=attention,
                           tp=tp) if cfg.encoder_layers else None
    if caches is None:
        caches = make_caches(cfg, b, cache_len, x.device)
    ck, cv = caches["kv"]
    mamba = caches.get("mamba")
    c = _cache_slots(cfg, cache_len)
    seq = _slot_axis(tp)
    mine = ck.shape[2]                      # the rank's slots
    first = 0 if seq is None else seq.offset(mine)
    every = ck.shape[3] == cfg.n_kv_heads   # ... of every kv head
    if mine * (1 if seq is None else seq.size) != c:
        raise ValueError(f"a cache of {mine} slots here for {c} in all")
    positions = torch.arange(s, device=x.device)[None, :]
    tail = slice(s - c, s) if s >= c else slice(0, s)
    shift = (s - c) % c if cfg.sliding_window is not None and s >= c else 0
    for i in range(cfg.n_layers):
        bp, cp = _serve_layer(model, i, tp)
        h_in = block_norm(x, bp["norms"], 0, cfg)[:, tail]
        pos = positions[:, tail]
        if shift:
            h_in, pos = torch.roll(h_in, shift, 1), torch.roll(pos, shift, 1)
        h_in, pos = h_in[:, first:first + mine], pos[:, first:first + mine]
        kv_ax = split_axis(ax, bp["attn"]["wk"].shape[-2], cfg.n_kv_heads) \
            if every else None
        wk, wv = (gather_from(bp["attn"][w], kv_ax, -2) for w in ("wk", "wv"))
        kh = torch.einsum("bsd,dhk->bshk", h_in, wk)
        vh = torch.einsum("bsd,dhk->bshk", h_in, wv)
        if cfg.qk_norm:
            kh = rms_norm(kh, bp["attn"]["k_norm"], cfg.norm_eps)
        kh = rope(kh, pos, cfg.rope_theta)
        ck[i, :, :kh.shape[1]] = kh.to(ck.dtype)
        cv[i, :, :vh.shape[1]] = vh.to(cv.dtype)
        # the mamba state and conv tail are written in place
        x, _ = _dense_block(
            bp, x, cfg, positions=positions, window=_layer_window(cfg, i),
            mamba_state=None if mamba is None else (mamba[0][i],
                                                    mamba[1][i]),
            enc_out=enc_out, cross_p=cp, attention=attention, tp=ax)
    if enc_out is not None:
        caches["enc_out"] = enc_out
    return _final_logits(model, x[:, -1:], tp, table)[:, 0], caches


@torch.no_grad()
def decode_step(model: LM, token, caches: dict, index: int, *,
                enc_out=None, attention=flash_attention,
                tp: TensorParallel | None = None):
    """One decode step: token (B, 1) at absolute position ``index``.  Its
    k/v go to slot ``index`` (on a ring, ``index % C``) and it attends to
    the slots written so far, 0..index (on a ring, 0..min(index, C - 1):
    every slot once the ring has wrapped), with no window.  ``enc_out``:
    the audio encoder's output (``caches["enc_out"]`` after prefill).
    Returns (logits (B, V_pad) float32, caches), the caches updated in
    place (an ssm config's states are new tensors).  ``tp``: as for
    :func:`prefill`, the caches the rank's shards (split along their slots,
    they are attended by slices); ``index`` is a position in the whole
    cache.  A ``HymbaConfig`` runs ``models/hymba.py``'s decode step."""
    cfg = model.cfg
    if isinstance(cfg, HymbaConfig):
        from . import hymba
        return hymba.decode_step(model, token, caches, index,
                                 attention=attention, tp=tp)
    ax = model_axis(tp)
    table = _weight(model, "embed", tp)
    x = embed_tokens(model, token, table=table, tp=ax)
    if cfg.family == "ssm":
        x, states = _run_xlstm(model, x, caches["states"], tp=tp)
        return _final_logits(model, x, tp, table)[:, 0], {"states": states}
    positions = torch.full((1, 1), index, device=x.device)
    ck, cv = caches["kv"]
    mamba = caches.get("mamba")
    seq = _slot_axis(tp)
    c = ck.shape[2] * (1 if seq is None else seq.size)
    slot, q_offset = (index, index) if cfg.sliding_window is None \
        else (index % c, min(index, c - 1))
    for i in range(cfg.n_layers):
        bp, cp = _serve_layer(model, i, tp)
        # the mamba state and conv tail are written in place
        x, _ = _dense_block(
            bp, x, cfg, positions=positions, q_offset=q_offset,
            kv_cache=(ck[i], cv[i]), cache_index=slot,
            mamba_state=None if mamba is None else (mamba[0][i],
                                                    mamba[1][i]),
            enc_out=enc_out, cross_p=cp, attention=attention, tp=ax, seq=seq)
    return _final_logits(model, x, tp, table)[:, 0], caches
