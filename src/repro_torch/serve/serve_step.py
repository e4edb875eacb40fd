"""Serving step: one greedy decode step against a resident cache.  (The
JAX package's ``serve_prefill`` only forwards to ``prefill``; call
``models.model.prefill`` directly.)"""
from __future__ import annotations

import torch

from repro_torch.models.model import DenseLM, decode_step


def serve_decode_step(model: DenseLM, token, caches: dict, index: int):
    """token (B, 1) integer; index: absolute position.  Greedy-samples the
    next token so the serving loop is self-contained.  Returns
    (next_token (B, 1) int32, logits, caches)."""
    logits, caches = decode_step(model, token, caches, index)
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return next_token, logits, caches
