"""Mesh construction: ``torch.distributed`` DeviceMeshes with named axes.

Single pod: (data=16, model=16) = 256 chips.
Multi-pod:  (pod=2, data=16, model=16) = 512 chips.

:func:`production_mesh_spec` is pure (no device or process-group state), so
shapes can be checked without a cluster.  A mesh needs a process group of
its size: start one with ``torch.distributed.init_process_group`` (its
address, world size and rank given explicitly) before :func:`make_mesh`.
A one-device run needs no mesh and no process group: ``train(mesh=None)``.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` over the process group's ranks, its
    dimensions named ``axes``."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_mesh_spec(*, multi_pod: bool = False):
    """(shape, axes) of the production mesh — pure, testable without
    devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_host_mesh() -> DeviceMesh:
    """Degenerate (1, 1) ``("data", "model")`` mesh on the CPU, for tests of
    the sharded code paths; it starts a process group of one, on an
    in-process store, when none is running."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), "cpu")
