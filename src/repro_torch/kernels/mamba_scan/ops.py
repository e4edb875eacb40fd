"""Public wrappers of the mamba heads' two kernels (csrc/mamba_scan.cu):
``mamba_conv``, the depthwise causal conv step with its SiLU, and
``mamba_scan``, the selective scan.  ``models/ssm.py``'s ``apply_mamba``
runs them around its three projections when it serves (no autograd).

Every device checks the operands alike, and refuses what the kernels do
not take.  Then a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain PyTorch version in ref.py.  There is no fallback between
the two.  A meta tensor launches nothing: the op's meta implementation
gives the output's shape, so the dry run (``launch/dryrun.py``) traces the
card's program without a card.

Both update their state in place, on every device: ``mamba_conv`` writes
the new conv tail into ``conv_tail`` and ``mamba_scan`` the final state
into ``state``, so a caller that hands them its caches' views (the serving
caches' per-layer slices) copies nothing back.  Each kernel reads every
value of its channel of that state before it writes any.

The launches are the ops ``repro_torch::mamba_conv`` and
``repro_torch::mamba_scan``, declared with ``torch.library.Library``
(their schemas mark the state written), so PyTorch's dispatcher, and
``launch/trace_analysis.py``'s counter on it, see one op a kernel.  They
have no gradient: under autograd ``apply_mamba`` runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from .ref import causal_conv_ref, selective_scan_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CONV = 8                  # the conv kernel's most taps K
STATES = (4, 8, 16, 32)       # N: a channel's states share a warp's lanes
MAX_GRID_YZ = 65_535

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("mamba_conv(Tensor xz, Tensor(a!) conv_tail, Tensor conv_w) "
            "-> Tensor")
_LIB.define("mamba_scan(Tensor xz, Tensor u, Tensor proj, Tensor a_log, "
            "Tensor d_skip, Tensor(a!) state) -> Tensor")


def _check(name: str, t: torch.Tensor, shape: tuple, dtype,
           device: torch.device) -> None:
    """Refuse what a kernel does not take: another device, type or shape,
    or strides other than contiguous ones."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: strides {t.stride()} are not contiguous")


def _xz_device(xz: torch.Tensor, op: str) -> torch.device:
    if xz.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{op}: no implementation on {xz.device}")
    if xz.dtype not in DTYPES:
        raise ValueError(f"{op}: dtype {xz.dtype}; the kernel takes one of "
                         f"{list(DTYPES)}")
    if xz.dim() != 3 or xz.shape[-1] % 2 or xz.shape[0] > MAX_GRID_YZ:
        raise ValueError(f"{op}: xz of shape {tuple(xz.shape)} is not "
                         "(B, S, 2e)")
    return xz.device


def mamba_conv(xz, conv_tail, conv_w):
    """The mamba heads' depthwise causal conv along the sequence, then SiLU.

    xz: (B, S, 2e), the in_proj product; u is its first e columns, read in
    place through its row stride.  conv_tail: (B, K - 1, e), the K - 1
    inputs before u, in xz's dtype.  conv_w: (K, e).  Returns
    (silu(conv(u)) (B, S, e) in xz's dtype, conv_tail), the new tail (the
    last K - 1 inputs) written into ``conv_tail`` in place.

    The conv sums tap by tap in xz's dtype, rounding after each product and
    each sum, and the SiLU runs in float32 and rounds once: the kernel
    gives the plain version's bits.
    """
    k, e = conv_w.shape
    device = _xz_device(xz, "mamba_conv")
    b, s, width = xz.shape
    if width != 2 * e or not 1 <= k <= MAX_CONV:
        raise ValueError(f"mamba_conv: xz {tuple(xz.shape)} and conv_w "
                         f"{tuple(conv_w.shape)} do not fit the kernel "
                         f"(1 <= K <= {MAX_CONV})")
    for name, t, shape in (("xz", xz, (b, s, 2 * e)),
                           ("conv_tail", conv_tail, (b, k - 1, e)),
                           ("conv_w", conv_w, (k, e))):
        _check(name, t, shape, xz.dtype, device)
    if device.type == "cpu":
        y, tail = causal_conv_ref(xz[..., :e], conv_tail, conv_w)
        conv_tail.copy_(tail)
        return y, conv_tail
    return torch.ops.repro_torch.mamba_conv(xz, conv_tail, conv_w), conv_tail


def mamba_scan(xz, u, proj, a_log, d_skip, state):
    """The mamba heads' selective scan, gated.

    xz: (B, S, 2e), the in_proj product, z its last e columns (read in
    place); u: (B, S, e), :func:`mamba_conv`'s output; proj: (B, S, 2N + 1),
    the x_proj product (its B, C and dt columns) in xz's dtype or float32;
    a_log: (e, N), d_skip: (e,) and state: (B, e, N), float32.

    delta = softplus(dt), a = -exp(a_log); each position in order
    h = exp(delta a) h + (delta u) b_t, y = c_t . h + u d_skip, all in
    float32.  Returns (y rounded to xz's dtype times silu(z) rounded to it,
    (B, S, e) in xz's dtype; state), the final state written into ``state``
    in place.  The kernel sums c_t . h in another order than the plain
    version; every other rounding is the plain version's.
    """
    e, n = a_log.shape
    device = _xz_device(xz, "mamba_scan")
    b, s, _ = xz.shape
    if n not in STATES:
        raise ValueError(f"mamba_scan: {n} states a channel; the kernel "
                         f"takes {STATES}")
    if proj.dtype not in (xz.dtype, torch.float32):
        raise ValueError(f"proj: dtype {proj.dtype}, expected {xz.dtype} "
                         "or torch.float32")
    for name, t, shape, dtype in (
            ("xz", xz, (b, s, 2 * e), xz.dtype),
            ("u", u, (b, s, e), xz.dtype),
            ("proj", proj, (b, s, 2 * n + 1), proj.dtype),
            ("a_log", a_log, (e, n), torch.float32),
            ("d_skip", d_skip, (e,), torch.float32),
            ("state", state, (b, e, n), torch.float32)):
        _check(name, t, shape, dtype, device)
    if device.type == "cpu":
        y, new = selective_scan_ref(u, xz[..., e:], proj.float(), a_log,
                                    d_skip, state)
        state.copy_(new)
        return y, state
    return torch.ops.repro_torch.mamba_scan(xz, u, proj, a_log, d_skip,
                                            state), state


def _launch_conv(xz, conv_tail, conv_w):
    b, s, _ = xz.shape
    k, e = conv_w.shape
    y = xz.new_empty((b, s, e))
    if y.numel():
        native.launch("mamba_conv_launch", xz, conv_tail, conv_w, y, b, s, e,
                      k, DTYPES[xz.dtype], device=xz.device)
        native.LAUNCHES["mamba_conv"] += 1
    return y


def _launch_scan(xz, u, proj, a_log, d_skip, state):
    b, s, _ = xz.shape
    e, n = a_log.shape
    y = xz.new_empty((b, s, e))
    if y.numel():
        native.launch("mamba_scan_launch", xz, u, proj, a_log, d_skip, state,
                      y, b, s, e, n, DTYPES[xz.dtype],
                      int(proj.dtype == torch.float32), device=xz.device)
        native.LAUNCHES["mamba_scan"] += 1
    return y


def _conv_shape(xz, conv_tail, conv_w):
    return xz.new_empty(xz.shape[:2] + conv_w.shape[-1:])


def _scan_shape(xz, u, proj, a_log, d_skip, state):
    return xz.new_empty(u.shape)


_LIB.impl("mamba_conv", _launch_conv, "CUDA")
_LIB.impl("mamba_scan", _launch_scan, "CUDA")
_LIB.impl("mamba_conv", _conv_shape, "Meta")
_LIB.impl("mamba_scan", _scan_shape, "Meta")
