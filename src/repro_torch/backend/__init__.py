"""Execution backends of the port for the SiM search/gather/lookup contract.

See base.py for the contract, scalar.py for the host reference,
batched.py for the single-launch CUDA fast path, sharded.py for the
multi-chip SSD and planestore.py for the device-resident page-plane arena
behind both.
"""
from .base import BackendStats, MatchBackend, Ticket, as_backend, make_backend
from .batched import BatchedKernelBackend
from .planestore import PlaneStore
from .scalar import ScalarBackend
from .sharded import ShardedSsdBackend

__all__ = ["BackendStats", "MatchBackend", "PlaneStore", "Ticket",
           "as_backend", "make_backend", "BatchedKernelBackend",
           "ScalarBackend", "ShardedSsdBackend"]
