"""Carry state across packages as plain numpy and ints: stored chip pages
and LM parameters.

The state of a ``SimChipArray`` is, per chip, its ``device_seed`` and
``pages_per_chip`` and, per programmed page, the ``StoredPage`` fields
(``raw``, ``clean_raw``, ``chunk_parities``, ``timestamp_ns``,
``n_entries``, ``injected_error_bits``).  :func:`chip_array_to_numpy`
reads that state off any object with the ``SimChipArray`` attribute layout
— the JAX package's or this one's — and :func:`chip_array_from_numpy`
builds the port's ``SimChipArray`` from it, bit for bit.

LM parameters travel as the JAX package's parameter tree: nested dicts of
numpy arrays keyed as the port's module names (``blocks.attn.wq`` is
``tree["blocks"]["attn"]["wq"]``).  :func:`params_from_numpy` builds the
port's model from such a tree and :func:`params_to_numpy` gives it back,
bit for bit; bfloat16 crosses as its 16-bit pattern.  The AdamW state
crosses the same way (:func:`opt_state_to_numpy`,
:func:`opt_state_from_numpy`): ``{"m": tree, "v": tree, "step": int32}``,
the JAX ``init_opt_state`` layout.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.engine import SimChipArray, StoredPage
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM

PAGE_FIELDS = ("raw", "clean_raw", "chunk_parities", "timestamp_ns",
               "n_entries", "injected_error_bits")


def chip_array_to_numpy(chips) -> dict:
    """State of a chip array as ``{"chips": [{"device_seed",
    "pages_per_chip", "pages": {local_addr: {field: value}}}]}``, with
    every array copied to numpy and every scalar an int."""
    out = []
    for chip in chips.chips:
        pages = {}
        for local, sp in chip.pages.items():
            page = {}
            for f in PAGE_FIELDS:
                v = getattr(sp, f)
                page[f] = (None if v is None else np.array(v, copy=True)
                           if isinstance(v, np.ndarray) else int(v))
            pages[int(local)] = page
        out.append({"device_seed": int(chip.device_seed),
                    "pages_per_chip": int(chips.pages_per_chip),
                    "pages": pages})
    return {"chips": out}


def chip_array_from_numpy(state: dict) -> SimChipArray:
    """Build the port's ``SimChipArray`` from :func:`chip_array_to_numpy`
    state.  Chip ``i`` must carry seed ``chips[0].device_seed + i`` and all
    chips the same ``pages_per_chip``, as a ``SimChipArray`` makes them."""
    chips = state["chips"]
    if not chips:
        raise ValueError("state holds no chips")
    base, per_chip = chips[0]["device_seed"], chips[0]["pages_per_chip"]
    for i, c in enumerate(chips):
        if c["device_seed"] != base + i or c["pages_per_chip"] != per_chip:
            raise ValueError(f"chip {i} (seed {c['device_seed']}, "
                             f"{c['pages_per_chip']} pages) does not fit a "
                             f"SimChipArray of base seed {base}")
    arr = SimChipArray(n_chips=len(chips), pages_per_chip=per_chip,
                       device_seed=base)
    for chip, c in zip(arr.chips, chips):
        for local, page in c["pages"].items():
            if not 0 <= int(local) < per_chip:
                raise IndexError(f"page {local} outside chip of {per_chip}")
            clean = page["clean_raw"]
            chip.pages[int(local)] = StoredPage(
                raw=np.array(page["raw"], dtype=np.uint8, copy=True),
                chunk_parities=np.array(page["chunk_parities"],
                                        dtype=np.uint32, copy=True),
                timestamp_ns=int(page["timestamp_ns"]),
                injected_error_bits=int(page["injected_error_bits"]),
                n_entries=int(page["n_entries"]),
                clean_raw=(None if clean is None else
                           np.array(clean, dtype=np.uint8, copy=True)))
    return arr


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> tensor of the same bits; bfloat16 arrays (numpy's
    ``ml_dtypes`` extension type, which torch does not read) go through
    their uint16 pattern."""
    a = np.array(a, copy=True, order="C")      # writable, never aliased
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes             # numpy's bfloat16; only needed here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_items(tree: dict, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict in ``jax.tree_util``'s order:
    keys sorted at every level, empty dicts skipped."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from tree_items(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``,
    into a tree of the same shape; the leaves are visited in
    ``jax.tree_util``'s order (keys sorted), as :func:`tree_items`'s."""
    out = {}
    for k in sorted(tree):
        leaves = [r[k] for r in rest]
        out[k] = tree_map(fn, tree[k], *leaves) if isinstance(tree[k], dict) \
            else fn(tree[k], *leaves)
    return out


def nest(flat: dict) -> dict:
    """``{"blocks.attn.wq": x}`` (parameter names) -> the tree
    ``{"blocks": {"attn": {"wq": x}}}``."""
    tree: dict = {}
    for name, leaf in flat.items():
        *outer, last = name.split(".")
        node = tree
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def param_tree(model: nn.Module) -> dict:
    """The model's live parameters as the JAX parameter tree: nested dicts,
    one level per submodule (``{}`` for one without parameters)."""
    tree = dict(model.named_parameters(recurse=False))
    for name, child in model.named_children():
        tree[name] = param_tree(child)
    return tree


def params_to_numpy(model: nn.Module) -> dict:
    """The model's parameters as a nested dict of numpy arrays (copies)."""
    return tree_map(lambda p: _tensor_to_numpy(p).copy(), param_tree(model))


def opt_state_to_numpy(state: dict) -> dict:
    """An AdamW state (``train.optimizer.init_opt_state``) as numpy copies,
    the JAX state's layout: moment trees and an int32 step."""
    return {"m": tree_map(lambda t: _tensor_to_numpy(t).copy(), state["m"]),
            "v": tree_map(lambda t: _tensor_to_numpy(t).copy(), state["v"]),
            "step": np.asarray(_tensor_to_numpy(state["step"]), np.int32)}


def opt_state_from_numpy(state: dict, *, device=None) -> dict:
    """The port's AdamW state on ``device`` (the card by default) from a
    numpy copy of either package's state, bit for bit."""
    device = resolve_device(device)
    to = lambda a: _tensor_from_numpy(np.asarray(a)).to(device)
    return {"m": tree_map(to, state["m"]), "v": tree_map(to, state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def params_from_numpy(tree: dict, cfg: ModelConfig, *,
                      device=None) -> LM:
    """The port's model for ``cfg``, of any family, with every parameter
    copied from ``tree`` (the JAX ``init_model`` parameters as numpy).
    Every leaf must name a parameter of the same shape and dtype, and
    every parameter must have a leaf.  ``device=None`` is the card."""
    model = LM(cfg, resolve_device(device))
    params = dict(model.named_parameters())

    seen = set()
    with torch.no_grad():
        for path, a in tree_items(tree):
            name = ".".join(path)
            if name not in params:
                raise KeyError(f"{name}: no such parameter in {cfg.name}")
            t = _tensor_from_numpy(np.asarray(a))
            p = params[name]
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the "
                                 f"model has {tuple(p.shape)} {p.dtype}")
            p.copy_(t)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"no value for parameters {missing}")
    return model
