"""Training step: causal LM loss + AdamW, with optional microbatch gradient
accumulation and a gradient hook (the cross-pod int8 compression of
``parallel/compression.py`` plugs in there).

The step is ``(model, opt_state, batch) -> (model, opt_state, metrics)``;
it updates the model's parameters in place.  On one device the gradient
is autograd's over the model's parameters.  When the parameters are
DTensors (``parallel.sharding.shard_model``), the step is data parallel
over the mesh's ``pod``/``data`` axes: each rank gathers the full weights
into a local copy of the model, takes the gradient of its shard of the
batch, and the ranks all-reduce the gradients, each weighted by its share
of the global batch's labelled tokens, so the loss and gradient are those
of the whole batch; the update then runs on each rank's shards.  The
model axis holds weight shards only: its ranks compute the same
activations (tensor-parallel compute is not ported).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.convert import nest, param_tree
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, train_logits
from .optimizer import AdamWConfig, adamw_update

AUX_WEIGHT = 0.01
IGNORE = -1


def lm_loss(model, tokens, labels, *, frontend_embeds=None,
            remat: str | None = None, attention=flash_attention):
    """Next-token cross entropy; positions with label == IGNORE are masked.
    Returns ``(loss + AUX_WEIGHT * aux, (loss, aux))``, ``aux`` the MoE
    router loss (0 for the other families).  ``frontend_embeds``: the
    VLM's patch embeddings or the audio encoder's frames.  The label's
    log-probability is picked by a one-hot mask, not a gather, whose
    backward scatters with atomics on the card."""
    logits, aux = train_logits(model, tokens,
                               frontend_embeds=frontend_embeds, remat=remat,
                               attention=attention)
    lp = torch.log_softmax(logits.float(), dim=-1)
    safe = labels.clamp(min=0).long()
    pick = safe[..., None] == torch.arange(lp.shape[-1], device=lp.device)
    nll = -torch.where(pick, lp, 0.0).sum(dim=-1)
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
                   attention=flash_attention):
    """``((loss, aux), grads)``: :func:`lm_loss` and its gradient with
    respect to every parameter, keyed by parameter name (autograd's, the
    parameters' own dtype).  With ``microbatches`` > 1 the batch (and
    ``frontend_embeds``) is split along its first axis, the gradients
    summed in float32 and everything averaged, as the JAX step's
    ``fori_loop``."""
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    unread = unread_parameters(model.cfg)
    read = [p for n, p in zip(names, params) if n not in unread]

    def one(tok, lab, fe):
        total, (loss, aux) = lm_loss(model, tok, lab, frontend_embeds=fe,
                                     remat=remat, attention=attention)
        # every parameter the config reads must reach the loss: autograd
        # raises for one that dropped out of the graph
        grads = iter(torch.autograd.grad(total, read))
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


def _sum_over_data(t, mesh) -> None:
    for axis in ("pod", "data"):
        if axis in mesh.mesh_dim_names:
            dist.all_reduce(t, group=mesh.get_group(axis))


def _data_parallel_grads(model, compute, batch, mesh, microbatches):
    """The gradient of the global batch's loss with respect to the DTensor
    parameters of ``model``: full weights gathered into ``compute`` (a
    plain model), each rank's batch shard differentiated there, and the
    gradients summed over the data axes with weights of labelled-token
    shares; each returned as a DTensor with its parameter's placements."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, q in compute.named_parameters():
            q.copy_(params[name].full_tensor())
    tokens, labels, fe = (
        batch[k].to_local() if isinstance(batch.get(k), DTensor)
        else batch.get(k) for k in ("tokens", "labels", "frontend"))
    (loss, aux), grads = value_and_grad(compute, tokens, labels,
                                        frontend_embeds=fe,
                                        microbatches=microbatches)
    count = (labels != IGNORE).sum().float()
    total = count.clone()
    _sum_over_data(total, mesh)
    share = count / torch.clamp(total, min=1.0)
    out = {}
    for name, g in grads.items():
        g = g * share.to(g.dtype)
        _sum_over_data(g, mesh)
        p = params[name]
        out[name] = DTensor.from_local(
            g, mesh, [Replicate()] * mesh.ndim,
            run_check=False).redistribute(mesh, p.placements)
    loss, aux = loss * share, aux * share
    _sum_over_data(loss, mesh)
    _sum_over_data(aux, mesh)
    return (loss, aux), out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, grad_transform=None):
    """Build the train step ``(model, opt_state, batch) -> (model,
    opt_state, metrics)``; ``metrics`` holds ``loss``, ``aux_loss``,
    ``grad_norm`` and ``lr`` as tensors.

    ``grad_transform(grads) -> grads`` hook (a tree keyed as the parameter
    tree): the compression stage (or any distributed-optimization trick)
    plugs in here.  ``batch`` is ``{"tokens", "labels"}`` and, for the VLM
    and audio families, ``"frontend"`` (B, F, d) embeddings; DTensors
    sharded by ``parallel.sharding.batch_sharding`` when the model is
    sharded.
    """
    compute: dict = {}      # sharded model -> its local full-weight copy

    def train_step(model, opt_state, batch):
        mesh = _mesh(model)
        if mesh is None:
            (loss, aux), grads = value_and_grad(
                model, batch["tokens"], batch["labels"],
                frontend_embeds=batch.get("frontend"),
                microbatches=microbatches)
        else:
            if id(model) not in compute:
                compute.clear()
                compute[id(model)] = LM(
                    cfg, model.embed.to_local().device)
            (loss, aux), grads = _data_parallel_grads(
                model, compute[id(model)], batch, mesh, microbatches)
        grads = nest(grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                 param_tree(model), opt_cfg)
        metrics = {"loss": loss, "aux_loss": aux, **opt_metrics}
        return model, opt_state, metrics

    return train_step
