"""The one traffic generator: reads a mix's data file (``traffic/<name>.json``)
and the configuration, and draws the cell's inputs from ``--seed``.

The mix's ``kind`` names the frozen draw that reads it,
``yardstick/kinds/<kind>.py``, whose ``make(config, traffic, seed)`` returns
the inputs that the configuration's system and reference take.  A new kind
of mix is a new file there; a new mix of a known kind is a data file alone.
"""
from __future__ import annotations

import importlib
import re


def make(config: dict, traffic: dict, seed: int):
    kind = traffic["kind"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", kind):
        raise ValueError(f"traffic kind {kind!r} is not a module name")
    try:
        mod = importlib.import_module(f"simbench.yardstick.kinds.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"simbench.yardstick.kinds.{kind}":
            raise
        raise ValueError(f"unknown traffic kind {kind!r}") from None
    return mod.make(config, traffic, seed)
