"""Serving steps: prefill and one greedy decode step against a resident
cache, on one device or sharded over a mesh.

On one device ``serve_prefill`` is ``models.model.prefill`` and
``serve_decode_step`` adds the greedy sample.  When the model's parameters
are DTensors (``parallel.sharding.shard_model``) both run the JAX
package's sharded serve program (its ``serve_prefill`` and
``serve_decode_step`` jitted with the TP + FSDP placements and the caches
placed by ``CACHE_AXES``), computed on each rank's local shards:

- the tokens (and frontend embeddings, and whisper's ``enc_out``) are the
  rank's batch rows, replicated over ``model``;
- each layer's weights are all-gathered over the data axes just before use
  and keep their split over ``model`` (``models/model.py``);
- the caches are DTensors placed by ``launch.specs.cache_shardings``
  (k/v split along their slots, the recurrent states by channels or
  heads), computed on their local shards; decode attends by slices of the
  cache and merges the ranks' partial softmaxes (``models/layers.py``);
- the logits are the rank's vocabulary columns, and the greedy token is
  combined over ``model`` (``argmax_split``).

The outputs are DTensors: the logits placed over (batch, vocab), the
tokens over batch, the caches in their placements.

A ``HymbaConfig`` (hymba at its published structure) is served on one
device only: the sharded steps refuse it.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.specs import cache_shardings
from repro_torch.models.config import HymbaConfig, InputShape
from repro_torch.models.model import LM, decode_step, make_caches, prefill
from repro_torch.models.ssm import NEG_INF
from repro_torch.parallel.tensor_parallel import (TensorParallel,
                                                  argmax_split, model_axis,
                                                  split_axis)
from repro_torch.train.train_step import local_parameters


def _mesh(model: LM):
    p = model.embed
    if isinstance(p, DTensor) and isinstance(model.cfg, HymbaConfig):
        raise NotImplementedError(
            f"{model.cfg.name}: the published hymba structure is served on "
            "one device; the sharded serve step does not run it")
    return p.device_mesh if isinstance(p, DTensor) else None


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _tree(fn, *trees):
    """``fn`` over the leaves of the caches' nested dicts and tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        return tuple(_tree(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def sharded_caches(model: LM, mesh, global_batch: int, cache_len: int,
                   device=None) -> dict:
    """Zeroed caches for a batch of ``global_batch`` rows as DTensors placed
    by ``launch.specs.cache_shardings`` (the JAX cache layout): each rank
    allocates only its own shard."""
    cfg = model.cfg
    if isinstance(cfg, HymbaConfig):
        raise NotImplementedError(
            f"{cfg.name}: the published hymba structure is served on one "
            "device; it has no sharded caches")
    whole = make_caches(cfg, global_batch, cache_len, device="meta")
    placements = cache_shardings(cfg, InputShape(
        "serve", "decode", cache_len, global_batch), mesh, whole)

    def one(meta, pl):
        shape = list(meta.shape)
        for size, p in zip(mesh.shape, pl):
            if isinstance(p, Shard):
                shape[p.dim] //= size
        local = torch.zeros(shape, dtype=meta.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False)

    caches = _tree(one, whole, placements)
    for part in caches.get("states", ()):   # the stabilisers m start at
        part[-1].to_local().fill_(NEG_INF)  # NEG_INF, as mlstm_state's
    return caches


def _plan(model: LM, mesh, caches) -> TensorParallel:
    return TensorParallel.of(
        mesh, {n: p.placements for n, p in model.named_parameters()},
        {k: _tree(lambda t: t.placements, v) for k, v in caches.items()
         if k != "enc_out"})


def _as_placed(mesh, local, like):
    """The local shards ``local`` as DTensors placed as the tree ``like``
    (an ssm config's new states)."""
    return _tree(lambda t, d: DTensor.from_local(t, mesh, d.placements,
                                                 run_check=False),
                 local, like)


def _wrap(mesh, local, rows: DTensor, vocab_split: bool) -> DTensor:
    """A rank's output whose first dimension is the batch of ``rows`` as a
    DTensor: ``rows``' data-axis placements, and over ``model`` its last
    dimension split (``vocab_split``) or replicated."""
    pl = tuple((Shard(local.ndim - 1) if vocab_split else Replicate())
               if name == "model" else p
               for name, p in zip(mesh.mesh_dim_names, rows.placements))
    return DTensor.from_local(local, mesh, pl, run_check=False)


def _rows(t, name: str):
    """A batch input of the sharded steps: a DTensor placed over the data
    axes (``launch.specs.batch_shardings``), or None."""
    if t is not None and not isinstance(t, DTensor):
        raise TypeError(f"{name}: a sharded model's serve step takes a "
                        "DTensor placed over the batch")
    return t


def serve_prefill(model: LM, tokens, cache_len: int, *,
                  frontend_embeds=None, attention=flash_attention,
                  caches: dict | None = None):
    """``models.model.prefill``; on a sharded model the sharded prefill
    (module docstring) from ``tokens`` (a DTensor over the batch) into
    ``caches``, zeroed caches (on a sharded model from
    :func:`sharded_caches`; made here when None: the dry run makes them
    before its trace, whose meta tensors would count the global shapes
    :func:`sharded_caches` works out the placements on).  Returns
    (logits, caches)."""
    mesh = _mesh(model)
    if mesh is None:
        return prefill(model, tokens, cache_len,
                       frontend_embeds=frontend_embeds, attention=attention,
                       caches=caches)
    tokens = _rows(tokens, "tokens")
    fe = _rows(frontend_embeds, "frontend_embeds")
    if caches is None:
        caches = sharded_caches(model, mesh, tokens.shape[0], cache_len,
                                device=_local(tokens).device)
    tp = _plan(model, mesh, caches)
    with local_parameters(model):
        logits, local = prefill(
            model, tokens.to_local(), cache_len,
            frontend_embeds=None if fe is None else fe.to_local(),
            attention=attention, tp=tp,
            caches=_tree(_local, {k: v for k, v in caches.items()
                                  if k != "states"}))
    if "states" in local:
        caches["states"] = _as_placed(mesh, local["states"],
                                      caches["states"])
    if "enc_out" in local:
        caches["enc_out"] = _wrap(mesh, local["enc_out"], tokens, False)
    vocab = split_axis(tp.model, logits.shape[-1], model.cfg.padded_vocab)
    return _wrap(mesh, logits, tokens, vocab is not None), caches


def serve_decode_step(model: LM, token, caches: dict, index: int, *,
                      enc_out=None, attention=flash_attention,
                      tp: TensorParallel | None = None):
    """token (B, 1) integer; index: absolute position.  Greedy-samples the
    next token so the serving loop is self-contained.  Returns
    (next_token (B, 1) int32, logits, caches).  ``enc_out``: the audio
    encoder's output, as for ``decode_step``.

    ``tp``: a rank's plan, the parameters, token and caches its local
    shards; the logits are then its vocabulary columns and the token the
    argmax over all of them.  On a sharded model (DTensor parameters,
    caches from :func:`serve_prefill` or :func:`sharded_caches`) the plan
    is made here and the outputs are DTensors."""
    mesh = _mesh(model)
    if mesh is not None and tp is None:
        token = _rows(token, "token")
        enc = _rows(enc_out, "enc_out")
        tp = _plan(model, mesh, caches)
        local = _tree(_local, caches)
        with local_parameters(model):
            nxt, logits, local = serve_decode_step(
                model, token.to_local(), local, index,
                enc_out=None if enc is None else enc.to_local(),
                attention=attention, tp=tp)
        if "states" in local:       # new tensors, not updated in place
            caches = dict(caches, states=_as_placed(
                mesh, local["states"], caches["states"]))
        vocab = split_axis(tp.model, logits.shape[-1],
                           model.cfg.padded_vocab)
        return (_wrap(mesh, nxt, token, False),
                _wrap(mesh, logits, token, vocab is not None), caches)
    logits, caches = decode_step(model, token, caches, index,
                                 enc_out=enc_out, attention=attention, tp=tp)
    vocab = split_axis(model_axis(tp), logits.shape[-1],
                       model.cfg.padded_vocab)
    next_token = argmax_split(logits, vocab).to(torch.int32)[:, None]
    return next_token, logits, caches
