"""Public wrapper of the flash attention kernel (csrc/flash_attention.cu):
the checks and the dispatch.  The kernel reads q, k and v in their
(B, S, H, D) layout and writes the output in it, so nothing is copied.

A CUDA tensor launches the kernel at any Sq and Sk, the decode shape
Sq = 1 included; a CPU tensor takes the plain PyTorch version in ref.py.
There is no fallback between the two.  A meta tensor takes the kernel's
route, checks included, and launches nothing: the op's fake
implementation gives the output's shape.  That is how the dry run
(``launch/dryrun.py``) traces the card's program without a card.

The kernel is forward only, as the JAX package's is.  When autograd
records (grad enabled and an input that requires grad) the launch goes
through :class:`_FlashAttention`, whose backward recomputes the plain
``attend`` of ``models/layers.py`` on the saved q, k and v and returns its
vector-Jacobian product: the gradient the JAX package trains with, the VJP
of its ``_attend``.  So a CUDA output that needs a gradient always has a
``grad_fn``.  Under ``no_grad`` (serving) the launch is the same and no
Function is recorded.

The launch itself is the op ``repro_torch::flash_attention_fwd`` (a
``torch.library.custom_op``), so PyTorch's own tracing sees the kernel:
on meta tensors and under ``FakeTensorMode`` its fake implementation gives
the output's shape and launches nothing, and ``FlopCounterMode`` (and
``launch/trace_analysis.py``) count its useful FLOPs by the formula
registered here, the one ``launch/roofline.py`` bounds the kernel with.

``return_lse=True`` also returns each row's log-sum-exp (B, Sq, H) float32,
which the kernel writes beside its output in the same launch (the op
``repro_torch::flash_attention_lse_fwd``, the same formula): the sharded
decode step splits attention along the cache and merges the ranks' partial
outputs by it (``parallel/tensor_parallel.merge_split_attention``).  It is
a forward-only output: under autograd the call raises.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import native
from repro_torch.launch.roofline import attention_flops
from .ref import attention_ref

HEAD_DIMS = tuple(range(16, 129, 16))   # every multiple of 16 to 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65_535         # the kernel's grid puts Hkv on y and B on z


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    q_offset: int | None = None, return_lse: bool = False):
    """Multi-head attention with optional causal / sliding-window masking.

    q: (B, Sq, H, D);  k, v: (B, Sk, Hkv, D), H a multiple of Hkv.  Query
    row i sits at absolute position ``q_offset + i`` (default ``Sk - Sq``)
    and sees keys ``q_offset + i - window < j <= q_offset + i``; a row that
    sees no key gives 0.  Returns (B, Sq, H, D) in q's dtype, and with
    ``return_lse`` also the rows' log-sum-exps (B, Sq, H) float32 of the
    scaled, masked logits (``ref.NEG_INF`` for a row that sees no key).
    """
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    q_offset = sk - sq if q_offset is None else q_offset
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset,
                             return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
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
    mask = (bool(causal), None if window is None else int(window),
            float(scale), int(q_offset))
    recording = torch.is_grad_enabled() and any(t.requires_grad
                                                for t in (q, k, v))
    if return_lse:
        if recording:
            raise ValueError("flash_attention: the log-sum-exp output has "
                             "no gradient; call it under no_grad")
        return _launch_lse(q, k, v, *mask)
    if recording:
        return _FlashAttention.apply(q, k, v, *mask)
    return _launch(q, k, v, *mask)


def _run(q, k, v, causal, window, scale, q_offset, lse):
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.numel():
        native.launch("flash_attention_launch", q, k, v, out, lse, b, sq, sk,
                      d, h, hkv, scale, int(causal), window or 0, q_offset,
                      DTYPES[q.dtype], device=q.device)
        native.LAUNCHES["flash_attention"] += 1
    return out


def launch_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int | None, scale: float,
                  q_offset: int) -> torch.Tensor:
    """One launch of the kernel on checked, contiguous CUDA q, k, v: the
    body of the op ``_launch``."""
    return _run(q, k, v, causal, window, scale, q_offset, None)


def launch_kernel_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: int | None, scale: float,
                      q_offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`launch_kernel` that also has the kernel write the rows'
    log-sum-exps (B, Sq, H) float32: the body of the op ``_launch_lse``."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _run(q, k, v, causal, window, scale, q_offset, lse), lse


_launch = torch.library.custom_op("repro_torch::flash_attention_fwd",
                                  launch_kernel, mutates_args=())
_launch_lse = torch.library.custom_op(
    "repro_torch::flash_attention_lse_fwd", launch_kernel_lse,
    mutates_args=())


@_launch.register_fake
def _(q, k, v, causal, window, scale, q_offset):
    return q.new_empty(q.shape)


@_launch_lse.register_fake
def _(q, k, v, causal, window, scale, q_offset):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _launch_flops(q_shape, k_shape, v_shape, causal, window, scale, q_offset,
                  *args, **kwargs) -> int:
    b, sq, h, d = q_shape
    return attention_flops(b, sq, k_shape[1], h, d, causal=causal,
                           window=window, q_offset=q_offset)


for _op in (torch.ops.repro_torch.flash_attention_fwd,
            torch.ops.repro_torch.flash_attention_lse_fwd):
    register_flop_formula(_op)(_launch_flops)


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
