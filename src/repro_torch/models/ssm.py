"""Recurrent blocks: the Mamba-style selective SSM (hymba's heads) and the
xLSTM pair (mLSTM matrix memory, sLSTM scalar memory).

The counterpart of the JAX package's ``models/ssm.py``.  Each block has a
sequence form (train and prefill) and a single-step form (decode).  The
time recurrences are Python loops over the sequence, one step a position,
where the JAX package runs ``jax.lax.scan``; the JAX package has no Pallas
kernel for them, so they run as plain PyTorch on any device.  The states
are float32 whatever the parameter dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import _dense_init, _param

NEG_INF = -1e30       # the stabiliser's start: exp(x - NEG_INF) never runs


# =========================================================== selective SSM

class Mamba(nn.Module):
    """in_proj (L, d, 2d), conv_w (L, K, d), x_proj (L, d, 2N + 1),
    out_proj (L, d, d) in the parameter dtype; a_log (L, d, N) and d_skip
    (L, d) in float32."""

    def __init__(self, cfg: ModelConfig, n_layers: int, device=None):
        super().__init__()
        self.cfg = cfg
        L, d, n = (n_layers,), cfg.d_model, cfg.ssm_state
        self.in_proj = _param(L + (d, 2 * d), cfg, device)
        self.conv_w = _param(L + (cfg.ssm_conv, d), cfg, device)
        self.x_proj = _param(L + (d, 2 * n + 1), cfg, device)
        self.a_log = _param(L + (d, n), cfg, device, torch.float32)
        self.d_skip = _param(L + (d,), cfg, device, torch.float32)
        self.out_proj = _param(L + (d, d), cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        _dense_init(self.in_proj, cfg.d_model, gen)
        _dense_init(self.conv_w, cfg.ssm_conv, gen)
        _dense_init(self.x_proj, cfg.d_model, gen)
        self.a_log.copy_(torch.log(torch.arange(
            1, cfg.ssm_state + 1, dtype=torch.float32,
            device=self.a_log.device)).expand(self.a_log.shape))
        self.d_skip.fill_(1.0)
        _dense_init(self.out_proj, cfg.d_model, gen)


def _mamba_scan(u, delta, a, bmat, cmat, d_skip, h0):
    """u, delta (B, S, D); a (D, N); bmat, cmat (B, S, N); h0 (B, D, N).

    h_t = exp(delta a) h_{t-1} + delta * b_t * u_t ;  y_t = c_t . h_t
    Returns (y (B, S, D), h_final (B, D, N))."""
    decay = torch.exp(torch.einsum("bsd,dn->bsdn", delta, a))
    drive = torch.einsum("bsd,bsn->bsdn", delta * u, bmat)
    h, hs = h0, []
    for t in range(u.shape[1]):
        h = decay[:, t] * h + drive[:, t]
        hs.append(h)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), cmat)
    return y + u * d_skip, h


def apply_mamba(p: dict, x, cfg: ModelConfig, *, state=None,
                conv_state=None, single_step: bool = False):
    """x (B, S, d).  Returns (y, (ssm_state, conv_state)); state (B, d, N)
    float32, conv_state (B, K - 1, d) the conv's tail in x's dtype."""
    b, s, d = x.shape
    n = cfg.ssm_state
    xz = torch.einsum("bsd,de->bse", x, p["in_proj"])
    u, z = xz[..., :d], xz[..., d:]

    kconv = cfg.ssm_conv
    if conv_state is None:
        conv_state = torch.zeros((b, kconv - 1, d), dtype=u.dtype,
                                 device=u.device)
    upad = torch.cat([conv_state, u], dim=1)          # (B, S + K - 1, d)
    # depthwise causal conv along the sequence, summed tap by tap in x's
    # dtype in the JAX package's order
    u = sum(upad[:, i:i + s] * p["conv_w"][i] for i in range(kconv))
    u = nn.functional.silu(u.float()).to(x.dtype)
    new_conv_state = upad[:, -(kconv - 1):] if kconv > 1 else conv_state

    proj = torch.einsum("bsd,de->bse", u, p["x_proj"]).float()
    bmat, cmat, dt_raw = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n:]
    delta = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))   # softplus
    delta = delta.expand(b, s, d)
    a = -torch.exp(p["a_log"])                        # (d, N), negative

    if state is None:
        state = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    if single_step:
        # one token: the closed-form update, no loop
        dec = torch.exp(torch.einsum("bd,dn->bdn", delta[:, 0], a))
        drv = torch.einsum("bd,bn->bdn", delta[:, 0] * u[:, 0].float(),
                           bmat[:, 0])
        state = dec * state + drv
        y = torch.einsum("bdn,bn->bd", state, cmat[:, 0])[:, None]
        y = y + u.float() * p["d_skip"]
    else:
        y, state = _mamba_scan(u.float(), delta, a, bmat, cmat, p["d_skip"],
                               state)
    y = y.to(x.dtype) * nn.functional.silu(z.float()).to(x.dtype)
    return torch.einsum("bsd,de->bse", y, p["out_proj"]), (state,
                                                            new_conv_state)


# ================================================================== mLSTM

class Mlstm(nn.Module):
    """wqkv ``lead`` + (d, 3, H, hd), wo ``lead`` + (H, hd, d) in the
    parameter dtype; wgates ``lead`` + (d, 2, H) in float32."""

    def __init__(self, cfg: ModelConfig, lead: tuple, device=None):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.mlstm_heads
        self.wqkv = _param(lead + (d, 3, h, d // h), cfg, device)
        self.wgates = _param(lead + (d, 2, h), cfg, device, torch.float32)
        self.wo = _param(lead + (h, d // h, d), cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wqkv, self.wgates, self.wo):
            _dense_init(w, self.cfg.d_model, gen)


def mlstm_state(lead: tuple, b: int, cfg: ModelConfig, device=None):
    """Zeroed mLSTM state (C, n, m) of ``lead`` + (B, H, hd, hd),
    (B, H, hd), (B, H), the stabiliser m at NEG_INF."""
    h = cfg.mlstm_heads
    hd = cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(lead + (b, h, hd, hd), **f32),
            torch.zeros(lead + (b, h, hd), **f32),
            torch.full(lead + (b, h), NEG_INF, **f32))


def apply_mlstm(p: dict, x, cfg: ModelConfig, *, state=None):
    """Stabilised mLSTM over x (B, S, d); state (C, n, m) as
    :func:`mlstm_state` without ``lead``.  Returns (out, state)."""
    b, s, d = x.shape
    hd = d // cfg.mlstm_heads
    qkv = torch.einsum("bsd,dthk->btshk", x, p["wqkv"])  # (B, 3, S, H, hd)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    k = k * (hd ** -0.5)
    gates = torch.einsum("bsd,dgh->bgsh", x.float(), p["wgates"])
    i_log, f_log = gates[:, 0], nn.functional.logsigmoid(gates[:, 1])
    q, k, v = q.float(), k.float(), v.float()

    if state is None:
        state = mlstm_state((), b, cfg, x.device)
    c_mem, n, m = state
    hs = []
    for t in range(s):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], i_log[:, t], \
            f_log[:, t]
        m_new = torch.maximum(ft + m, it)
        i_s = torch.exp(it - m_new)[..., None]         # (B, H, 1)
        f_s = torch.exp(ft + m - m_new)[..., None]
        c_mem = f_s[..., None] * c_mem + i_s[..., None] * torch.einsum(
            "bhv,bhk->bhvk", vt, kt)
        n = f_s * n + i_s * kt
        denom = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            min=1.0)[..., None]
        hs.append(torch.einsum("bhvk,bhk->bhv", c_mem, qt) / denom)
        m = m_new
    out = torch.stack(hs, dim=1).to(x.dtype)          # (B, S, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (c_mem, n, m)


# ================================================================== sLSTM

class Slstm(nn.Module):
    """wx, wr ``lead`` + (d, 4, d), float32."""

    def __init__(self, cfg: ModelConfig, lead: tuple, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.wx = _param(lead + (d, 4, d), cfg, device, torch.float32)
        self.wr = _param(lead + (d, 4, d), cfg, device, torch.float32)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wx, self.wr):
            _dense_init(w, self.cfg.d_model, gen)


def slstm_state(lead: tuple, b: int, cfg: ModelConfig, device=None):
    """Zeroed sLSTM state (c, n, h, m), each ``lead`` + (B, d) float32, the
    stabiliser m at NEG_INF."""
    shape = lead + (b, cfg.d_model)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(),
            torch.full(shape, NEG_INF, dtype=torch.float32, device=device))


def apply_slstm(p: dict, x, cfg: ModelConfig, *, state=None):
    """sLSTM with an exponential input gate and a normaliser state over
    x (B, S, d); sequential by construction (the recurrent weight wr).
    Returns (out, state)."""
    b, s, d = x.shape
    gx = torch.einsum("bsd,dge->bsge", x.float(), p["wx"])
    if state is None:
        state = slstm_state((), b, cfg, x.device)
    c, n, h, m = state
    hs = []
    for t in range(s):
        g = gx[:, t] + torch.einsum("bd,dge->bge", h, p["wr"])   # (B, 4, d)
        i_log, f_raw, z_raw, o_raw = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        f_log = nn.functional.logsigmoid(f_raw)
        m_new = torch.maximum(f_log + m, i_log)
        i_s = torch.exp(i_log - m_new)
        f_s = torch.exp(f_log + m - m_new)
        c = f_s * c + i_s * torch.tanh(z_raw)
        n = f_s * n + i_s
        h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), (c, n, h, m)
