"""The contract auditor of the port: AST lint, launch audit, conservation.

Three prongs, one CLI (``python -m repro_torch.analysis``):

  * ``contracts`` — AST lint rules (SIM001..SIM009) over ``src/repro_torch``
    that enforce the MatchBackend invariants documented in
    ``repro_torch.backend.base`` (ticket discipline, observer completeness,
    host-sync-free hot paths, counter integrity, unit suffixes, seed
    provenance), the dataflow rules on the engine in ``dataflow.py``;
  * ``launch_audit`` — a runtime auditor (SIM101..SIM104) that drives the
    batched and sharded backends through every flush path with their
    kernel entry points wrapped, and proves one kernel launch per flush
    phase, no host sync inside a launch, a bounded set of launch shapes
    and byte-exact counter reconciliation;
  * ``conservation`` — seeded replays on a metered flash timeline whose
    busy time, energy, bytes and fault counters must balance
    (SIM201..SIM204).

The audits run on the card unless ``device="cpu"`` (``--device cpu``).
Accepted pre-existing findings are pinned in ``baseline.toml`` next to this
file; ``--check`` fails on any finding not in the baseline.
"""
from .findings import Finding

__all__ = ["Finding"]
