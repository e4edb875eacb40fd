"""Logical-axis sharding rules -> DTensor placements (DP/TP/FSDP + pod).

Every parameter carries a tuple of logical axis names
(``models.model.logical_axes``).  Rules map logical names to mesh axes; a
dimension that does not divide the mesh axis size is replicated instead
(recorded in ``report``, e.g. hymba's 25 heads on a 16-way model axis),
and a mesh axis shards at most one dimension of a tensor.

Mesh contract (launch/mesh.py): axes ``(data, model)`` single-pod or
``(pod, data, model)`` multi-pod.  ``batch`` shards over (pod, data);
``fsdp``-tagged weight dims shard over the same product when cfg.fsdp.

The JAX package's ``PartitionSpec`` names, per tensor dimension, the mesh
axes it is split over; a DTensor's placements name, per mesh dimension,
the tensor dimension it splits (``Shard(d)``) or ``Replicate()``.  A
dimension split over (pod, data) is ``Shard(d)`` on both, pod the outer
split, which is the order of the JAX tuple.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.convert import param_tree, tree_items, tree_map
from repro_torch.models.model import logical_axes


def _mesh_axes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


LOGICAL_TO_MESH = {
    "batch": "DATA",          # resolved to (pod, data)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "expert_mlp": None,
    "embed": "FSDP",          # resolved to (pod, data) when cfg.fsdp
    "kv_seq": "model",
    "head_dim": None,
    "layers": None,
    "repeat": None,
}


def resolve_axis(logical: str | None, mesh: DeviceMesh, *, fsdp: bool):
    """The mesh axis (a name, a tuple of names, or None) for a logical
    axis."""
    if logical is None:
        return None
    kind = LOGICAL_TO_MESH.get(logical)
    if kind == "DATA" or (kind == "FSDP" and fsdp):
        axes = data_axes(mesh)
        return axes if len(axes) > 1 else axes[0]
    if kind == "FSDP":
        return None
    return kind


def _flat(resolved) -> tuple[str, ...]:
    if resolved is None:
        return ()
    return tuple(resolved) if isinstance(resolved, tuple) else (resolved,)


def _placements(parts, mesh: DeviceMesh) -> tuple[Placement, ...]:
    """Per-dimension mesh axes (the PartitionSpec entries) -> placements."""
    out: list[Placement] = [Replicate()] * mesh.ndim
    for dim, resolved in enumerate(parts):
        for axis in _flat(resolved):
            out[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return tuple(out)


def _spec_parts(dim_sizes, logical_axes, mesh, *, fsdp, report):
    sizes = _mesh_axes(mesh)
    parts = []
    used: set[str] = set()
    for size, logical in zip(dim_sizes, logical_axes):
        resolved = resolve_axis(logical, mesh, fsdp=fsdp)
        flat = _flat(resolved)
        if resolved is None or used & set(flat):
            parts.append(None)
            continue
        n = 1
        for a in flat:
            n *= sizes[a]
        if size % n != 0:
            if report is not None:
                report.append((logical, size, resolved))
            parts.append(None)
            continue
        used.update(flat)
        parts.append(resolved)
    return parts


def spec_for(dim_sizes: tuple[int, ...], logical_axes: tuple,
             mesh: DeviceMesh, *, fsdp: bool = True,
             report: list | None = None) -> tuple[Placement, ...]:
    """The placements of a tensor of ``dim_sizes`` whose dimensions carry
    ``logical_axes``; axes that don't divide evenly are replicated."""
    return _placements(_spec_parts(dim_sizes, logical_axes, mesh, fsdp=fsdp,
                                   report=report), mesh)


def shardings_for_tree(params: dict, axes_tree: dict, mesh: DeviceMesh, *,
                       fsdp: bool = True, report: list | None = None) -> dict:
    """A placements tree matching ``params`` (tensors, or anything with a
    ``shape``); ``axes_tree`` mirrors it with logical-axis tuples."""
    return tree_map(lambda p, ax: spec_for(tuple(p.shape), tuple(ax), mesh,
                                           fsdp=fsdp, report=report),
                    params, axes_tree)


def batch_sharding(mesh: DeviceMesh) -> tuple[Placement, ...]:
    return _placements([resolve_axis("batch", mesh, fsdp=True)], mesh)


def replicated(mesh: DeviceMesh) -> tuple[Placement, ...]:
    return (Replicate(),) * mesh.ndim


def block_compute_shardings(blocks: dict, blocks_axes: dict,
                            mesh: DeviceMesh) -> dict:
    """Per-layer *compute* placements for the stacked block parameters: the
    leading ``layers`` axis is dropped (one layer's slice) and fsdp axes
    are gathered (replicated), keeping only the model-axis splits — the
    FSDP pattern of all-gathering a layer's weights over the data axes."""
    return tree_map(lambda p, ax: spec_for(tuple(p.shape)[1:], tuple(ax)[1:],
                                           mesh, fsdp=False),
                    blocks, blocks_axes)


def distribute(t: torch.Tensor, mesh: DeviceMesh,
               placements) -> DTensor:
    """A DTensor of ``placements`` from a tensor every rank holds in full:
    each rank keeps a copy of its own chunk (a storage of the chunk's size,
    not a view of ``t``), with no communication.  A dimension split over
    several mesh axes is chunked by the outer axis first, DTensor's
    order."""
    local = t
    coord = mesh.get_coordinate()
    for dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            local = local.chunk(mesh.size(dim), dim=pl.dim)[coord[dim]]
    return DTensor.from_local(local.clone(
        memory_format=torch.contiguous_format), mesh, tuple(placements),
        run_check=False)


def shard_model(model: nn.Module, mesh: DeviceMesh, *,
                fsdp: bool = True) -> dict:
    """Replace every parameter of ``model`` (the same full value on every
    rank) by a DTensor parameter placed by the logical-axis rules; return
    the placements tree."""
    shardings = shardings_for_tree(param_tree(model), logical_axes(model.cfg),
                                   mesh, fsdp=fsdp)
    placements = {".".join(path): pl for path, pl in tree_items(shardings)}
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        setattr(mod, attr, nn.Parameter(
            distribute(p.detach(), mesh, placements[name]),
            requires_grad=p.requires_grad))
    return shardings


# ---- activation constraint helper --------------------------------------

def constrain(x: DTensor, mesh: DeviceMesh, *dims) -> DTensor:
    """Redistribute ``x`` to the placements of its logical dims, e.g.
    ``constrain(x, mesh, 'batch', None, 'heads')``."""
    parts = []
    used: set[str] = set()
    for d in dims:
        r = resolve_axis(d, mesh, fsdp=True)
        flat = _flat(r)
        if r is None or used & set(flat):
            parts.append(None)
        else:
            used.update(flat)
            parts.append(r)
    return x.redistribute(mesh, _placements(parts, mesh))
