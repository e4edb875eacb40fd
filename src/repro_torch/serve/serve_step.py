"""Serving step: one greedy decode step against a resident cache.  (The
JAX package's ``serve_prefill`` only forwards to ``prefill``; call
``models.model.prefill`` directly.)"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM, decode_step


def serve_decode_step(model: LM, token, caches: dict, index: int, *,
                      enc_out=None):
    """token (B, 1) integer; index: absolute position.  Greedy-samples the
    next token so the serving loop is self-contained.  Returns
    (next_token (B, 1) int32, logits, caches).  ``enc_out``: the audio
    encoder's output, as for ``decode_step``."""
    logits, caches = decode_step(model, token, caches, index,
                                 enc_out=enc_out)
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return next_token, logits, caches
