"""Training step: causal LM loss + AdamW, with optional microbatch gradient
accumulation and a gradient hook (the cross-pod int8 compression of
``parallel/compression.py`` plugs in there).

The step is ``(model, opt_state, batch) -> (model, opt_state, metrics)``;
it updates the model's parameters in place.  On one device the gradient
is autograd's over the model's parameters.  When the parameters are
DTensors (``parallel.sharding.shard_model``), the step is the JAX
package's sharded program (its GSPMD step under
``block_compute_shardings``), computed on each rank's local shards:

- the batch is split over the ``pod``/``data`` axes and the same on every
  rank of the ``model`` axis;
- each layer's weights are all-gathered over the data axes just before
  use (FSDP) and keep their split over ``model``, so every model-axis rank
  computes its own heads, MLP columns, experts, mamba channels, xLSTM
  heads and columns and vocabulary rows, with one all-reduce over
  ``model`` after each row-parallel product (``parallel/tensor_parallel.py``,
  ``models/ssm.py``);
- the loss is a vocabulary-parallel cross entropy: each rank's
  log-sum-exp and the label's logit combined over ``model`` as (B, S)
  tensors, the full logits never gathered;
- each rank's loss is weighted by its share of the global batch's
  labelled tokens, so the FSDP gathers' reduce-scatters sum the gradient
  of the whole batch's loss; a parameter kept whole on a data axis has
  its gradient all-reduced there.

Every gradient lands as a DTensor with its parameter's placements, and the
update runs on each rank's shards.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.convert import nest, param_tree
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import train_logits
from repro_torch.parallel.tensor_parallel import (Axis, TensorParallel,
                                                  all_reduce, split_axis)
from .optimizer import AdamWConfig, adamw_update

AUX_WEIGHT = 0.01
IGNORE = -1


class _TokenNll(torch.autograd.Function):
    """-log softmax(logits)[label] at every position, with its gradient
    softmax - onehot(label) written in one expression (Megatron-LM's
    vocabulary-parallel cross entropy).  ``logits`` (..., V) float32 are
    this rank's columns of a vocabulary split over ``vocab``, or all of
    them when ``vocab`` is None.  Each rank's log-sum-exp is combined over
    the split from (...)-shaped tensors only, and so is the label's logit,
    which only the rank holding it picks.  The label's logit is gathered
    and its one-hot row subtracted in the backward by an indexed put that
    touches one element a row: no scatter of a gathered gradient, which
    accumulates with atomics on the card."""

    @staticmethod
    def forward(ctx, logits, labels, vocab):
        v = logits.shape[-1]
        lse = torch.logsumexp(logits, dim=-1)
        col = labels.clamp(min=0).long()
        if vocab is not None:
            m = all_reduce(lse, vocab, "max")
            lse = torch.log(all_reduce(torch.exp(lse - m), vocab)) + m
            col = col - vocab.offset(v)
        mine = (col >= 0) & (col < v)
        col = col.clamp(0, v - 1)
        picked = torch.where(mine, logits.gather(-1, col[..., None])[..., 0],
                             0.0)
        if vocab is not None:
            picked = all_reduce(picked, vocab)
        ctx.save_for_backward(logits, lse, col, mine)
        return lse - picked

    @staticmethod
    def backward(ctx, grad):
        logits, lse, col, mine = ctx.saved_tensors
        out = torch.sub(logits, lse[..., None]).exp_()
        rows = out.view(-1, out.shape[-1])
        rows.index_put_((torch.arange(rows.shape[0], device=rows.device),
                         col.reshape(-1)), -mine.reshape(-1).to(out.dtype),
                        accumulate=True)
        return out.mul_(grad[..., None]), None, None


def token_nll(logits, labels, vocab: Axis | None = None):
    """-log softmax(logits)[label] at every position (:class:`_TokenNll`):
    ``logits`` (..., V) float32, or this rank's columns of a vocabulary
    split over ``vocab``."""
    return _TokenNll.apply(logits, labels, vocab)


def lm_loss(model, tokens, labels, *, frontend_embeds=None,
            remat: str | None = None, attention=flash_attention,
            tp: TensorParallel | None = None):
    """Next-token cross entropy; positions with label == IGNORE are masked.
    Returns ``(loss + AUX_WEIGHT * aux, (loss, aux))``, ``aux`` the MoE
    router loss (0 for the other families).  ``frontend_embeds``: the
    VLM's patch embeddings or the audio encoder's frames.  ``tp``: the
    sharded step's plan (``train_logits``)."""
    logits, aux = train_logits(model, tokens,
                               frontend_embeds=frontend_embeds, remat=remat,
                               attention=attention, tp=tp)
    vocab = split_axis(None if tp is None else tp.model, logits.shape[-1],
                       model.cfg.padded_vocab)
    nll = token_nll(logits.float(), labels, vocab)
    mask = (labels != IGNORE).float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + AUX_WEIGHT * aux, (loss, aux)


def unread_parameters(cfg: ModelConfig) -> frozenset:
    """Parameters the loss never reads, which get a zero gradient as under
    ``jax.grad``: the xLSTM stack keeps the JAX tree's ``norm_1``, but its
    blocks carry no separate FFN to put behind it."""
    return frozenset({"blocks.norms.norm_1"} if cfg.family == "ssm"
                     else ())


def value_and_grad(model, tokens, labels, *, frontend_embeds=None,
                   microbatches: int = 1, remat: str | None = None,
                   attention=flash_attention,
                   tp: TensorParallel | None = None, weight=None):
    """``((loss, aux), grads)``: :func:`lm_loss` and its gradient with
    respect to every parameter, keyed by parameter name (autograd's, the
    parameters' own dtype).  With ``microbatches`` > 1 the batch (and
    ``frontend_embeds``) is split along its first axis, the gradients
    summed in float32 and everything averaged, as the JAX step's
    ``fori_loop``.  ``tp``: the sharded step's plan, the parameters then
    the rank's shards; ``weight`` (a float32 scalar) scales the gradient,
    not the returned loss."""
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    unread = unread_parameters(model.cfg)
    read = [p for n, p in zip(names, params) if n not in unread]

    def one(tok, lab, fe):
        total, (loss, aux) = lm_loss(model, tok, lab, frontend_embeds=fe,
                                     remat=remat, attention=attention, tp=tp)
        # every parameter the config reads must reach the loss: autograd
        # raises for one that dropped out of the graph
        grads = iter(torch.autograd.grad(total, read, grad_outputs=weight))
        return loss.detach(), aux.detach(), [
            torch.zeros_like(p) if n in unread else next(grads)
            for n, p in zip(names, params)]

    if microbatches == 1:
        loss, aux, grads = one(tokens, labels, frontend_embeds)
        return (loss, aux), dict(zip(names, grads))
    b = tokens.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches}")
    mb = b // microbatches
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    loss = aux = torch.zeros((), device=tokens.device)
    for i in range(microbatches):
        sl = slice(i * mb, (i + 1) * mb)
        l, a, g = one(tokens[sl], labels[sl], None if frontend_embeds is None
                      else frontend_embeds[sl])
        acc = [x + y for x, y in zip(acc, g)]
        loss, aux = loss + l, aux + a
    grads = {n: g / microbatches for n, g in zip(names, acc)}
    return (loss / microbatches, aux / microbatches), grads


def _mesh(model):
    p = model.embed
    return p.device_mesh if isinstance(p, DTensor) else None


BATCH_AXES = ("pod", "data")


def _sum_over_data(t, mesh, axes=BATCH_AXES) -> None:
    for axis in axes:
        if axis in mesh.mesh_dim_names:
            dist.all_reduce(t, group=mesh.get_group(axis))


@contextlib.contextmanager
def local_parameters(model):
    """Within the block, every DTensor parameter of ``model`` is replaced
    by a plain parameter on its local shard (the same storage, so nothing
    is copied); the DTensors are put back on exit."""
    swapped = []
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        swapped.append((mod, attr, p))
        mod._parameters[attr] = nn.Parameter(p.to_local().detach(),
                                             requires_grad=False)
    try:
        yield model
    finally:
        for mod, attr, p in swapped:
            mod._parameters[attr] = p


def _sharded_grads(model, batch, mesh, microbatches, attention,
                   mean_axes=BATCH_AXES):
    """The gradient of the batch's loss with respect to the DTensor
    parameters of ``model``, each a DTensor with its parameter's
    placements, from the tensor-parallel program on this rank's shards
    (the module docstring).  ``mean_axes``: the data axes the loss's mean
    spans, by default the whole batch's; the compressed step passes
    ``("data",)``, which gives each pod the mean over its own rows and
    leaves the gradient unsummed over ``pod``."""
    params = dict(model.named_parameters())
    tp = TensorParallel.of(mesh, {n: p.placements for n, p in params.items()},
                           mean_axes=mean_axes)
    tokens, labels, fe = (
        batch[k].to_local() if isinstance(batch.get(k), DTensor)
        else batch.get(k) for k in ("tokens", "labels", "frontend"))
    count = (labels != IGNORE).sum().float()
    total = count.clone()
    _sum_over_data(total, mesh, mean_axes)
    share = count / torch.clamp(total, min=1.0)
    with local_parameters(model):
        (loss, aux), grads = value_and_grad(
            model, tokens, labels, frontend_embeds=fe,
            microbatches=microbatches, attention=attention, tp=tp,
            weight=share)
    out = {}
    for name, g in grads.items():
        for axis in tp.unsplit[name]:
            g = all_reduce(g, axis)
        out[name] = DTensor.from_local(g, mesh, params[name].placements,
                                       run_check=False)
    loss, aux = loss * share, aux * share
    _sum_over_data(loss, mesh, mean_axes)
    _sum_over_data(aux, mesh, mean_axes)
    return (loss, aux), out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, grad_transform=None,
                    attention=flash_attention):
    """Build the train step ``(model, opt_state, batch) -> (model,
    opt_state, metrics)``; ``metrics`` holds ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr`` as tensors.

    ``grad_transform(grads) -> grads`` hook (a tree keyed as the parameter
    tree): the compression stage (or any distributed-optimization trick)
    plugs in here.  ``batch`` is ``{"tokens", "labels"}`` and, for the VLM
    and audio families, ``"frontend"`` (B, F, d) embeddings; DTensors
    sharded by ``parallel.sharding.batch_sharding`` when the model is
    sharded.  ``attention``: the attention core (the kernel's wrapper, or
    ``models.layers.plain_attention`` to check it).
    """

    def train_step(model, opt_state, batch):
        mesh = _mesh(model)
        if mesh is None:
            (loss, aux), grads = value_and_grad(
                model, batch["tokens"], batch["labels"],
                frontend_embeds=batch.get("frontend"),
                microbatches=microbatches, attention=attention)
        else:
            (loss, aux), grads = _sharded_grads(model, batch, mesh,
                                                microbatches, attention)
        grads = nest(grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                 param_tree(model), opt_cfg)
        metrics = {"loss": loss, "aux_loss": aux, **opt_metrics}
        return model, opt_state, metrics

    return train_step
