"""Counts of the ops one step dispatches: the port's counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The JAX package compiles a step and reads the partitioned HLO text: it
parses computations, finds each while loop's trip count and multiplies
the loop body's dots, results and collectives by it, because XLA's own
``cost_analysis`` counts a ``scan`` body once.  The port has no HLO and
no loop to scale: eager PyTorch executes every iteration of every Python
loop (each layer, each recurrence step), so every op of the step reaches
PyTorch's dispatcher, where :class:`TraceCounter` (a ``TorchDispatchMode``)
sees it.  Nothing of the parser or of the trip-count propagation has a
consumer here.

Per traced region (one rank's step), in :class:`TraceCounts`:
  * ``dot_flops``        — PyTorch's flop formulas (``flop_registry``: the
                           matrix products, and the attention kernel's op
                           by the formula ``kernels/flash_attention/ops.py``
                           registers);
  * ``result_bytes``     — the bytes of every op's results, the JAX
                           package's materialisation proxy, kept so the two
                           packages compare;
  * ``bytes_accessed``   — every op's operand bytes plus its result bytes:
                           eager ops do not fuse, so each one reads its
                           operands from memory and writes its results;
  * ``collective_bytes`` — per kind, the operand bytes of each ``c10d`` and
                           ``_c10d_functional`` collective;
  * ``n_ops``            — the ops counted;
  * ``peak_bytes``       — the most device bytes live at once: the storages
                           alive when the trace starts (``track``) plus every
                           storage an op creates, each released when its last
                           tensor dies (a weakref finalizer on the storage).

An op moves no bytes when every result aliases an operand and nothing is
written (views, ``_unsafe_view``, ``detach``), or when it only allocates
(the ``empty`` family).  A collective's ``wait_tensor`` is not counted at
all: it marks where a result is ready and moves nothing, yet its fake
kernel returns a fresh tensor on meta where a real run returns its
operand, and a DTensor's lazily waited collectives dispatch it only on a
real run; the counter carries the operand's storage over to its result.  Only device ops count: an op none of whose
tensors lies on the counter's device is host work (a CPU random-number
state cloned by ``torch.utils.checkpoint`` on the card, a CPU constant);
``lift_fresh`` only marks a Python constant as a tensor, and ops of the
``prim`` namespace are metadata queries that only a tensor subclass
dispatches (a fake tensor's ``device``).  None of these is counted, so
that a trace and a run on the card count the same ops; nor is the scratch
output of an op that the card leaves empty where meta and the CPU fill it
(``log_sigmoid_forward``'s buffer).  A DTensor op is refused: its sharding
propagation dispatches the op once more at the global shape, which no
device runs; the port's steps compute on local shards.

On meta tensors the same counter traces a step without memory or a
device (``launch/dryrun.py``); on the card's tensors it counts the step as
it runs (``chip_smoke.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .roofline import COLLECTIVES

_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "scatter_": "scatter", "gather_": "gather", "reduce_": "reduce",
}
# The schema names of a collective's data operands.
_INPUT_ARGS = {"self", "input", "inputs", "input_tensor", "input_tensors",
               "tensor", "tensors"}
_ALLOCATE_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}
# Ops whose outputs past the first few are scratch that the card's kernel
# leaves empty while the meta and CPU kernels give it the input's size:
# ``log_sigmoid_forward``'s buffer (the xLSTM gates).  Only the leading
# outputs count.
_SCRATCH_AFTER = {"log_sigmoid_forward": 1}


@dataclasses.dataclass
class TraceCounts:
    dot_flops: int = 0
    result_bytes: int = 0
    bytes_accessed: int = 0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    n_ops: int = 0
    start_bytes: int = 0     # device bytes live when the trace began
    peak_bytes: int = 0

    @property
    def collective_total(self) -> int:
        return sum(self.collective_bytes.values())

    def key(self) -> tuple:
        """The counts a trace and a run on the card must share exactly."""
        return (self.dot_flops, self.bytes_accessed, self.result_bytes,
                self.n_ops, tuple(sorted(self.collective_bytes.items())))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (nested in lists and
    tuples), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    return out


@dataclasses.dataclass(frozen=True)
class _Op:
    """What the counter needs of one op overload, read once from it."""
    metadata: bool          # never counted: a ``prim`` query, a constant
    formula: object         # its flop formula, or None
    kind: str | None        # its collective kind, or None
    inputs: tuple           # positions of a collective's data operands
    writes: tuple           # positions of the arguments it writes
    allocates: bool         # only allocates (the ``empty`` family)
    waits: bool             # a collective's ``wait_tensor``
    results: int | None     # the outputs that count (the rest scratch)

    @classmethod
    def of(cls, func) -> "_Op":
        name = func._overloadpacket.__name__
        args = func._schema.arguments
        kind = _COLLECTIVE_KIND.get(name) \
            if func.namespace in ("c10d", "_c10d_functional") else None
        return cls(
            metadata=func.namespace == "prim" or name == "lift_fresh",
            formula=flop_registry.get(func._overloadpacket),
            kind=kind,
            inputs=tuple(i for i, a in enumerate(args)
                         if kind and a.name in _INPUT_ARGS),
            writes=tuple(i for i, a in enumerate(args)
                         if a.alias_info is not None
                         and a.alias_info.is_write),
            allocates=name in _ALLOCATE_ONLY,
            waits=name == "wait_tensor",
            results=_SCRATCH_AFTER.get(name))


class TraceCounter(TorchDispatchMode):
    """Counts every op dispatched inside ``with counter:`` into
    ``counter.counts``; device bytes live at ``device_type``'s storages."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type
        self.counts = TraceCounts()
        self._live: dict[int, int] = {}      # storage -> bytes
        self._live_bytes = 0
        self._ops: dict = {}

    # ------------------------------------------------------------- memory
    def track(self, *trees) -> None:
        """Count the device storages of the tensors in ``trees`` (a
        module's parameters and buffers, a DTensor's local shard) as live
        from now on: a step's inputs."""
        for leaf in tree_leaves(trees):
            if isinstance(leaf, torch.nn.Module):
                tensors = [*leaf.parameters(), *leaf.buffers()]
            else:
                tensors = _tensors(leaf)
            for t in tensors:
                self._add(t.to_local() if isinstance(t, DTensor) else t)
        self.counts.start_bytes = self._live_bytes
        self.counts.peak_bytes = max(self.counts.peak_bytes, self._live_bytes)

    def _add(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self._live_bytes += st.nbytes()
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _carry(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Move the tracking of ``src``'s storage to ``dst``'s, which holds
        the same value (a fake ``wait_tensor``'s fresh result)."""
        old = src.untyped_storage()._cdata
        st = dst.untyped_storage()
        if old == st._cdata or old not in self._live:
            return
        self._live[st._cdata] = self._live.pop(old)
        weakref.finalize(st, self._release, st._cdata)

    # ------------------------------------------------------------ counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _flat(args, [])
        if kwargs:
            _flat(tuple(kwargs.values()), ins)
        if any(isinstance(t, DTensor) for t in ins):
            raise TypeError(f"TraceCounter: {func} on a DTensor; count the "
                            "step's local shards")
        out = func(*args, **kwargs)
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = _Op.of(func)
        outs = _flat(out, [])[:op.results]
        dev = self.device_type
        if op.waits:
            for src, dst in zip(ins[:1], outs[:1]):
                self._carry(src, dst)
            return out
        if op.metadata or all(t.device.type != dev for t in ins + outs):
            return out
        c = self.counts
        c.n_ops += 1
        if op.formula is not None:
            c.dot_flops += int(op.formula(*args, **kwargs, out_val=out))
        if op.kind is not None:
            c.collective_bytes[op.kind] = c.collective_bytes.get(
                op.kind, 0) + sum(_nbytes(t) for i in op.inputs
                                  if i < len(args)
                                  for t in _flat(args[i], []))
        written = [t for i in op.writes if i < len(args)
                   for t in _flat(args[i], [])]
        held = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in held]
        for t in fresh:
            self._add(t)
        if self._live_bytes > c.peak_bytes:
            c.peak_bytes = self._live_bytes
        if (fresh or written) and not op.allocates:
            results = sum(_nbytes(t) for t in fresh + written)
            c.result_bytes += results
            c.bytes_accessed += results + sum(_nbytes(t) for t in ins)
        return out


def count(fn, *args, device_type: str = "cuda", **kwargs):
    """``(fn(*args, **kwargs), counts)``: one call of ``fn`` under a
    :class:`TraceCounter`, its arguments' storages (a module's parameters)
    live from the start."""
    counter = TraceCounter(device_type)
    counter.track(args, kwargs)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.counts
