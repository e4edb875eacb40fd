"""Tensor-parallel and FSDP collectives of the sharded training step: the
port's counterpart of what GSPMD inserts into the JAX package's step under
``block_compute_shardings``.

The step computes on local tensors, never on DTensor ops.  Every
activation of a model-axis rank is one of two kinds:

- *replicated*: the same value on every rank of the model axis (the
  residual stream, the norms, the router's scores), whose gradient must
  arrive whole and the same on every rank;
- *local*: this rank's slice (its q heads, MLP columns, experts or
  vocabulary rows) or its partial sum of a replicated value.

Four autograd functions pass between the two, Megatron-LM's conjugate
pairs over the ``model`` group:

==================  =====================  =====================
function            forward                backward
==================  =====================  =====================
:func:`copy_to`     identity               all-reduce (sum)
:func:`reduce_from` all-reduce (sum)       identity
:func:`gather_from` all-gather along dim   this rank's slice
:func:`scatter_to`  this rank's slice      all-gather along dim
==================  =====================  =====================

A replicated tensor that a local computation reads goes through
``copy_to`` (its gradient is a partial sum on each rank); a partial sum
becomes replicated through ``reduce_from``.  A weight that the model axis
keeps whole (``qk_norm``'s, the kv projections that a split of the q heads
shares) is such a replicated tensor too.

:func:`fsdp_gather` all-gathers a weight's FSDP split over one data axis
just before use; its backward reduce-scatters the weight's gradient there,
which sums it over the data-parallel ranks.  :func:`gather_shared` is the
same pair over the model axis, for a split weight of which each rank reads
columns that other ranks store (mamba's ``in_proj``).

The serve step adds two forward-only combinations:
:func:`merge_split_attention` merges the ranks' partial attentions over
their slices of a cache split along the sequence, by the kernel's
log-sum-exps, and :func:`argmax_split` takes a greedy token over a
vocabulary split over the model axis.  Every function is the identity (or
the plain op) when its axis is ``None``: the one-device step runs the same
code.  The collectives are the functional ones
(``torch.ops._c10d_functional``), the same calls on gloo, NCCL and the
``fake`` process group, each followed by its ``wait_tensor``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

_C10D = torch.ops._c10d_functional


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group's name, the
    rank's coordinate along it, and its size."""
    group: str
    rank: int
    size: int

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        group = mesh.get_group(name)
        return cls(group.group_name, mesh.get_local_rank(name),
                   dist.get_world_size(group))

    def splits(self, local: int, full: int) -> bool:
        """Whether a dimension of ``full`` that this rank holds ``local`` of
        is split over the axis.  ``spec_for`` splits a dimension exactly
        when the axis size divides it, and every size divides over an axis
        of one, so this is the placement's ``Shard`` on the axis."""
        return self.size == 1 or local != full

    def offset(self, local: int) -> int:
        """The first index of this rank's slice of a split dimension."""
        return self.rank * local


def split_axis(axis: Axis | None, local: int, full: int) -> Axis | None:
    """``axis`` if a dimension of ``full`` that this rank holds ``local``
    of is split over it, else None (the dimension is whole here)."""
    return axis if axis is not None and axis.splits(local, full) else None


def _wait(t: torch.Tensor) -> torch.Tensor:
    return _C10D.wait_tensor(t)


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum"):
    return _wait(_C10D.all_reduce(x.contiguous(), op, axis.group))


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in coordinate order,
    contiguous (a product then reads it as it would the whole tensor)."""
    dim %= x.ndim
    y = x.movedim(dim, 0).contiguous()
    out = _wait(_C10D.all_gather_into_tensor(y, axis.size, axis.group))
    return out.view((axis.size * y.shape[0],) + y.shape[1:]).movedim(
        0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's slice along ``dim``."""
    dim %= x.ndim
    y = x.movedim(dim, 0).contiguous()
    out = _wait(_C10D.reduce_scatter_tensor(y, "sum", axis.size, axis.group))
    return out.movedim(0, dim)


def local_slice(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.axis, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return local_slice(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.axis, ctx.dim), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.axis, ctx.dim), None, None


def copy_to(x, axis: Axis | None):
    """A replicated ``x`` read by a local computation: identity forward,
    the gradient all-reduced over ``axis``."""
    return x if axis is None else _CopyTo.apply(x, axis)


def reduce_from(x, axis: Axis | None):
    """The sum over ``axis`` of partial sums ``x``: all-reduced forward,
    the (replicated) gradient passed through."""
    return x if axis is None else _ReduceFrom.apply(x, axis)


def gather_from(x, axis: Axis | None, dim: int):
    """Local slices ``x`` concatenated along ``dim`` into the replicated
    whole; the backward keeps this rank's slice of the gradient."""
    return x if axis is None else _GatherFrom.apply(x, axis, dim)


def scatter_to(x, axis: Axis | None, dim: int):
    """This rank's slice along ``dim`` of a replicated ``x``; the backward
    all-gathers the slices' gradients."""
    return x if axis is None else _ScatterTo.apply(x, axis, dim)


def fsdp_gather(x, axis: Axis, dim: int):
    """A weight's FSDP split along ``dim`` all-gathered over data axis
    ``axis``; the backward reduce-scatters the gradient (sums it over the
    axis' ranks and keeps this rank's slice)."""
    return _GatherSummed.apply(x, axis, dim)


def gather_shared(x, axis: Axis | None, dim: int):
    """A weight split along ``dim`` over the model axis ``axis``, of which
    this rank reads slices other ranks store, all-gathered whole; the
    backward sums the gradient over the axis and keeps this rank's stored
    slice (a reduce-scatter), since other ranks' partials reach the stored
    columns.  (:func:`gather_from`'s backward would keep only this rank's
    own partial.)"""
    return x if axis is None else _GatherSummed.apply(x, axis, dim)


def split_attention_weight(lse, lses):
    """The weight of a partial attention whose rows' log-sum-exps are
    ``lse`` (B, Sq, H) among all the partials' ``lses`` (M, B, Sq, H) over
    disjoint slices of the keys: exp(lse - M) / sum_r exp(lses_r - M), M
    the largest of ``lses``.  The weighted partial outputs sum to the
    attention over all the keys; a slice that shows a row no key
    (``NEG_INF``) weighs 0 there."""
    top = lses.amax(0)
    return torch.exp(lse - top) / torch.exp(lses - top).sum(0)


def merge_split_attention(out, lse, seq: Axis | None,
                          heads: Axis | None = None):
    """Attention over keys split along ``seq``, merged from each rank's
    partial: ``out`` (B, Sq, H, hd) this rank's attention of every q head
    to its slice of the keys (0 for a row that sees none of them), ``lse``
    (B, Sq, H) float32 the rows' log-sum-exps there (``NEG_INF`` for such
    a row).  Each rank's output is weighted by exp(lse_r - M) over the sum
    of those weights (M the largest lse_r) and summed over ``seq``:
    reduce-scattered to this rank's q heads of ``heads`` (the heads split
    over the same axis), or all-reduced where the heads are whole
    (``heads`` None).  The identity when ``seq`` is None."""
    if seq is None:
        return out
    w = split_attention_weight(lse, all_gather(lse[None], seq, 0))
    part = out.float() * w[..., None]
    part = all_reduce(part, seq) if heads is None \
        else reduce_scatter(part, heads, 2)
    return part.to(out.dtype)


def argmax_split(logits, axis: Axis | None):
    """The index along the last dimension of the largest entry of logits
    whose columns are split over ``axis`` (this rank holds its own, the
    first at ``axis.offset``): each rank's (max, index) combined over the
    axis, ties to the lower index as ``torch.argmax`` and ``jnp.argmax``.
    The same on every rank of the axis; ``torch.argmax`` when ``axis`` is
    None."""
    idx = torch.argmax(logits, dim=-1)
    if axis is None:
        return idx
    val = logits.gather(-1, idx[..., None])[..., 0]
    vals = all_gather(val[None], axis, 0)
    idxs = all_gather((idx + axis.offset(logits.shape[-1]))[None], axis, 0)
    return torch.where(vals == vals.amax(0), idxs,
                       torch.iinfo(idxs.dtype).max).amin(0)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's plan of the sharded step over a ``(pod,) data, model``
    mesh: the model axis that the layers split over, per parameter (keyed
    by its dotted name) the gathers that give its compute form, and for the
    serve step whether the k/v caches' slots are split over the model axis.

    ``gathers[name]`` is a tuple of ``(axis, dim)``: the data axes whose
    FSDP split of the parameter is all-gathered before use (the inner axis
    first, so ``(pod, data)`` splits gather data then pod).  Every model
    split stays: each layer computes on its own slice.  ``unsplit[name]``
    lists the data axes a parameter is whole on, whose gradient is summed
    over them after the backward (an FSDP split's is summed by its
    reduce-scatter).  ``kv_slots``: the (L, B, C, Hkv, hd) caches are split
    along C (``kv_seq``, the JAX layout wherever the axis divides C); else
    they are split by kv heads or whole."""
    model: Axis
    gathers: dict
    unsplit: dict
    kv_slots: bool = False

    @classmethod
    def of(cls, mesh, placements: dict, caches: dict | None = None,
           mean_axes=("pod", "data")) -> "TensorParallel":
        """The plan from ``placements`` (dotted name -> a DTensor's
        placements) and, for the serve step, the caches' placements tree
        (``launch.specs.cache_shardings``).  ``unsplit`` names only the
        data axes among ``mean_axes``, those the loss's mean spans."""
        names = mesh.mesh_dim_names
        data = tuple(a for a in ("pod", "data") if a in names)
        axes = {a: Axis.of(mesh, a) for a in data + ("model",)}
        gathers, unsplit = {}, {}
        for name, pl in placements.items():
            on = dict(zip(names, pl))
            gathers[name] = tuple((axes[a], on[a].dim) for a in reversed(data)
                                  if isinstance(on[a], Shard))
            unsplit[name] = tuple(axes[a] for a in data if a in mean_axes
                                  and not isinstance(on[a], Shard))
        kv = (caches or {}).get("kv")
        kv_slots = kv is not None and \
            dict(zip(names, kv[0]))["model"] == Shard(2)
        return cls(axes["model"], gathers, unsplit, kv_slots)

    def weight(self, name: str, t, lead: int = 0):
        """Parameter ``name``'s compute form from its local shard ``t``
        (with ``lead`` leading stacking dimensions already indexed away)."""
        for axis, dim in self.gathers[name]:
            t = fsdp_gather(t, axis, dim - lead)
        return t

    def weights(self, tree: dict, prefix: str, lead: int = 1) -> dict:
        """:meth:`weight` over a nested dict of one layer's shards, its
        leaves named ``prefix.key.key``."""
        return {k: self.weights(v, f"{prefix}.{k}", lead)
                if isinstance(v, dict) else
                self.weight(f"{prefix}.{k}", v, lead)
                for k, v in tree.items()}


def model_axis(tp: TensorParallel | None) -> Axis | None:
    return None if tp is None else tp.model
