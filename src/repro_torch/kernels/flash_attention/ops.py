"""Public wrapper of the flash attention kernel (csrc/flash_attention.cu):
the checks and the dispatch.  The kernel reads q, k and v in their
(B, S, H, D) layout and writes the output in it, so nothing is copied.

A CUDA tensor launches the kernel at any Sq and Sk, the decode shape
Sq = 1 included; a CPU tensor takes the plain PyTorch version in ref.py.
There is no fallback between the two.

The kernel is forward only, as the JAX package's is.  When autograd
records (grad enabled and an input that requires grad) the launch goes
through :class:`_FlashAttention`, whose backward recomputes the plain
``attend`` of ``models/layers.py`` on the saved q, k and v and returns its
vector-Jacobian product: the gradient the JAX package trains with, the VJP
of its ``_attend``.  So a CUDA output that needs a gradient always has a
``grad_fn``.  Under ``no_grad`` (serving) the launch is the same and no
Function is recorded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import attention_ref

HEAD_DIMS = tuple(range(16, 129, 16))   # every multiple of 16 to 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65_535         # the kernel's grid puts Hkv on y and B on z


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    q_offset: int | None = None):
    """Multi-head attention with optional causal / sliding-window masking.

    q: (B, Sq, H, D);  k, v: (B, Sk, Hkv, D), H a multiple of Hkv.  Query
    row i sits at absolute position ``q_offset + i`` (default ``Sk - Sq``)
    and sees keys ``q_offset + i - window < j <= q_offset + i``; a row that
    sees no key gives 0.  Returns (B, Sq, H, D) in q's dtype.
    """
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    q_offset = sk - sq if q_offset is None else q_offset
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no implementation on {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         f"kernel takes one of {list(DTYPES)} for all three")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or h % hkv or max(b, hkv) > MAX_GRID_YZ):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit the kernel")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    # The kernel reads (B, S, H, D) in place: no copy unless a caller hands
    # it a strided view.
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    mask = (causal, window, scale, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, *mask)
    return _launch(q, k, v, *mask)


def _launch(q, k, v, causal, window, scale, q_offset):
    """One launch of the kernel on checked, contiguous q, k, v."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.numel():
        native.launch("flash_attention_launch", q, k, v, out, b, sq, sk, d, h,
                      hkv, float(scale), int(causal), window or 0, q_offset,
                      DTYPES[q.dtype], device=q.device)
        native.LAUNCHES["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward; the backward is the VJP of the plain
    ``attend`` recomputed on the saved inputs (no kernel launch)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, scale=scale,
                        q_offset=q_offset)
        return _launch(q, k, v, causal, window, scale, q_offset)

    @staticmethod
    def backward(ctx, grad):
        # models.layers imports this module for its default attention, so
        # the plain attention is imported when a gradient is first taken.
        from repro_torch.models.layers import plain_attention
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = plain_attention(*qkv, **ctx.mask)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad)
        return dq, dk, dv, None, None, None, None
