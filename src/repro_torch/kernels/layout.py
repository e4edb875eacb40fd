"""Layout conversions between SiM page bytes and kernel operands.

Pages are kept as two word *planes* of shape ``(N, 512)`` (lo words, hi
words), as on the chip, where the two words of a slot live on different
bitline groups.  On the device every word is a ``torch.int32`` bit pattern
that the CUDA kernels read as ``uint32_t``; on the host the same words are
numpy ``uint32``.  ``words_to_tensor`` and ``tensor_to_words`` move between
the two without changing a bit.

They are also the batched path's only crossings between host and card:
``COPIES`` counts each copy they make to or from a CUDA device, and its
bytes, since the last :func:`reset_copies` (as ``native.LAUNCHES`` counts
launches), and each copy is a ``copy.h2d`` or ``copy.d2h`` span.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.bits import bytes_to_slot_words, slot_words_to_bytes

SLOTS = 512
CHUNKS = 64
WORDS_PER_CHUNK = 16   # 64 B / 4 B

COPIES = {"h2d": 0, "h2d_bytes": 0, "d2h": 0, "d2h_bytes": 0}


def reset_copies() -> None:
    for name in COPIES:
        COPIES[name] = 0


def pages_to_planes(pages_bytes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 4096) uint8 -> ((N, 512) lo, (N, 512) hi) uint32 planes."""
    words = bytes_to_slot_words(np.asarray(pages_bytes, dtype=np.uint8))
    return np.ascontiguousarray(words[..., 0]), np.ascontiguousarray(
        words[..., 1])


def planes_to_pages(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    words = np.stack([lo, hi], axis=-1).astype(np.uint32)
    return slot_words_to_bytes(words)


def pages_to_chunk_words(pages_bytes: np.ndarray) -> np.ndarray:
    """(N, 4096) uint8 -> (N, 64, 16) uint32 chunk-major word view."""
    b = np.ascontiguousarray(np.asarray(pages_bytes, dtype=np.uint8))
    return b.view('<u4').reshape(*b.shape[:-1], CHUNKS, WORDS_PER_CHUNK)


def planes_to_chunk_words(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Device-side (B, 512) + (B, 512) planes -> (B, 64, 16) chunk words.

    Chunk j holds slots 8j..8j+7; its 16 words interleave lo/hi per slot.
    """
    b = lo.shape[0]
    return torch.stack([lo.reshape(b, CHUNKS, 8), hi.reshape(b, CHUNKS, 8)],
                       dim=-1).reshape(b, CHUNKS, WORDS_PER_CHUNK)


def chunk_words_to_planes(chunks: torch.Tensor):
    """(B, 64, 16) chunk words -> contiguous (B, 512) lo and hi planes, the
    inverse of :func:`planes_to_chunk_words`."""
    words = chunks.reshape(chunks.shape[0], SLOTS, 2)
    return words[..., 0].contiguous(), words[..., 1].contiguous()


def words_to_tensor(words, device, dtype=np.uint32) -> torch.Tensor:
    """numpy words -> contiguous tensor of the same bits (a copy: the
    tensor never aliases the caller's array).  ``uint32`` words become an
    int32 tensor; ``int32`` and ``int64`` (arena row indices) keep their
    type."""
    s = spans.ON and spans.begin("copy.h2d")
    a = np.ascontiguousarray(words, dtype=dtype)
    t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a
                         ).to(device, copy=True)
    if t.is_cuda and a.nbytes:
        COPIES["h2d"] += 1
        COPIES["h2d_bytes"] += a.nbytes
    if s:
        spans.end(s)
    return t


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> numpy uint32 words of the same bits."""
    s = spans.ON and spans.begin("copy.d2h")
    if t.is_cuda and t.numel():
        COPIES["d2h"] += 1
        COPIES["d2h_bytes"] += t.numel() * t.element_size()
    out = t.detach().cpu().numpy().view(np.uint32)
    if s:
        spans.end(s)
    return out
