"""Execution backends of the port for the SiM search/gather/lookup contract.

See base.py for the contract, batched.py for the single-launch CUDA fast
path and planestore.py for the device-resident page-plane arena behind it.
"""
from .base import BackendStats, MatchBackend, Ticket, make_backend
from .batched import BatchedKernelBackend
from .planestore import PlaneStore

__all__ = ["BackendStats", "MatchBackend", "PlaneStore", "Ticket",
           "make_backend", "BatchedKernelBackend"]
