"""Plain PyTorch version of the mamba heads' two kernels: the depthwise
causal conv step with its SiLU, and the selective scan one position a
step.  The ops (ops.py) run it on CPU tensors.  Under autograd
``models/ssm.py``'s ``apply_mamba`` runs the conv, :func:`scan_inputs` and
:func:`gate` too, with its own step loop for the scan."""
from __future__ import annotations

import torch
from torch import nn


def causal_conv_ref(u, conv_tail, conv_w):
    """u (B, S, e); conv_tail (B, K - 1, e), the K - 1 inputs before u, in
    u's dtype; conv_w (K, e).  Returns (silu(conv) (B, S, e) in u's dtype,
    the new tail: the last K - 1 inputs)."""
    s, kconv = u.shape[1], conv_w.shape[0]
    upad = torch.cat([conv_tail, u], dim=1)           # (B, S + K - 1, e)
    # depthwise causal conv along the sequence, summed tap by tap in u's
    # dtype in the JAX package's order
    y = sum(upad[:, i:i + s] * conv_w[i] for i in range(kconv))
    y = nn.functional.silu(y.float()).to(u.dtype)
    return y, upad[:, -(kconv - 1):] if kconv > 1 else conv_tail


def scan_inputs(proj, a_log):
    """proj (B, S, 2N + 1) float32, the x_proj product's B, C and dt
    columns; a_log (e, N) float32.  Returns (bmat, cmat (B, S, N), delta
    (B, S, e) = softplus(dt), a (e, N) = -exp(a_log), negative)."""
    b, s = proj.shape[:2]
    n = a_log.shape[-1]
    bmat, cmat, dt_raw = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n:]
    delta = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))   # softplus
    return bmat, cmat, delta.expand(b, s, a_log.shape[0]), -torch.exp(a_log)


def gate(y, z, dtype):
    """The scan's output y (float32) gated by silu(z), each rounded to
    ``dtype`` before the product."""
    return y.to(dtype) * nn.functional.silu(z.float()).to(dtype)


def selective_scan_ref(u, z, proj, a_log, d_skip, state):
    """u, z (B, S, e); proj (B, S, 2N + 1) float32 (:func:`scan_inputs`);
    d_skip (e,) float32; state (B, e, N) float32, the state before u.

    h_t = exp(delta_t a) h_{t-1} + (delta_t u_t) b_t ;
    y_t = c_t . h_t + u_t d_skip, in float32, one position a step: the
    decode step's closed-form update.  Returns (gate(y, z) (B, S, e) in u's
    dtype, the final state)."""
    bmat, cmat, delta, a = scan_inputs(proj, a_log)
    ys = []
    for t in range(u.shape[1]):
        dec = torch.exp(torch.einsum("bd,dn->bdn", delta[:, t], a))
        drv = torch.einsum("bd,bn->bdn", delta[:, t] * u[:, t].float(),
                           bmat[:, t])
        state = dec * state + drv
        ys.append(torch.einsum("bdn,bn->bd", state, cmat[:, t]))
    y = torch.stack(ys, dim=1) + u.float() * d_skip
    return gate(y, z, u.dtype), state
