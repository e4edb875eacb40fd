"""Recurrent blocks: the Mamba-style selective SSM (hymba's heads) and the
xLSTM pair (mLSTM matrix memory, sLSTM scalar memory).

The counterpart of the JAX package's ``models/ssm.py``.  Each block has a
sequence form (train and prefill) and a single-step form (decode).  The
time recurrences are Python loops over the sequence, one step a position,
where the JAX package runs ``jax.lax.scan``; the JAX package has no Pallas
kernel for them, so they run as plain PyTorch on any device.  The states
are float32 whatever the parameter dtype.

Under the sharded steps each block takes ``tp``, the mesh's model axis,
and splits where its placements do (``split_axis``: an axis splits the
dimensions it divides), as the JAX package's logical axes put them:
- mamba's channels (``mlp``): the rank owns channels [r d/M, (r+1) d/M) of
  u, z, the conv, ``a_log``, ``d_skip``, the state and the conv tail.
  ``in_proj``'s contiguous split of its 2d columns leaves a rank all-u or
  all-z columns, so it is gathered over the axis and the rank's u and z
  columns sliced from it (:func:`gather_shared`, whose backward
  reduce-scatters); ``x_proj``'s rows are the rank's channels, so its
  (B, S, 2N + 1) product is a partial sum, summed over the axis and read
  back by the rank's channels (``copy_to``), and ``out_proj`` is
  row-split;
- the mLSTM's heads: ``wqkv``, ``wgates`` and the (C, n, m) states local
  by heads, ``wo`` row-split;
- the sLSTM's columns: ``wx``, ``wr`` and (c, n, h, m) local by columns;
  each step all-gathers the full h for the ``wr`` product, and the output
  (B, S, d / M) is all-gathered into the replicated residual.
A block whose dimension the axis does not divide (xlstm-350m's 4 mLSTM
heads on a 16-way axis) keeps it whole and computes replicated.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel.tensor_parallel import (Axis, copy_to, gather_from,
                                                  gather_shared, reduce_from,
                                                  scatter_to, split_axis)
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


def _mamba_weights(p: dict, d: int, tp: Axis | None):
    """The channel axis (``tp`` where it splits the channels, else None)
    and the compute forms of ``in_proj`` (d, 2 d_local: the rank's u then
    z columns) and ``x_proj`` (d_local, 2N + 1: the rank's channel rows)."""
    w_in, x_proj = p["in_proj"], p["x_proj"]
    ax = split_axis(tp, p["conv_w"].shape[-1], d)
    in_ax = split_axis(tp, w_in.shape[-1], 2 * d)
    if ax is None:          # whole channels: in_proj whole, compute replicated
        return None, gather_from(w_in, in_ax, -1), x_proj
    w_in = gather_shared(w_in, in_ax, -1)
    n, lo = d // ax.size, ax.offset(d // ax.size)
    return ax, torch.cat([w_in[:, lo:lo + n], w_in[:, d + lo:d + lo + n]],
                         dim=-1), scatter_to(x_proj, ax, 0)


def apply_mamba(p: dict, x, cfg: ModelConfig, *, state=None,
                conv_state=None, single_step: bool = False,
                tp: Axis | None = None):
    """x (B, S, d).  Returns (y, (ssm_state, conv_state)); state (B, d, N)
    float32, conv_state (B, K - 1, d) the conv's tail in x's dtype.
    ``tp``: the model axis; ``p`` then holds the rank's channels (the
    module docstring), and so do the state and the conv tail."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    ax, w_in, x_proj = _mamba_weights(p, x.shape[-1], tp)
    d = w_in.shape[-1] // 2                           # the rank's channels
    xz = torch.einsum("bsd,de->bse", copy_to(x, ax), w_in)
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

    # a partial sum over the channels, summed, then read by each rank's own
    # channels (its gradient summed over them)
    proj = copy_to(reduce_from(torch.einsum("bsd,de->bse", u, x_proj)
                               .float(), ax), ax)
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
    out = reduce_from(torch.einsum("bsd,de->bse", y, p["out_proj"]), ax)
    return out, (state, new_conv_state)


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


def mlstm_state(lead: tuple, b: int, cfg: ModelConfig, device=None,
                heads: int | None = None):
    """Zeroed mLSTM state (C, n, m) of ``lead`` + (B, H, hd, hd),
    (B, H, hd), (B, H), the stabiliser m at NEG_INF; H is ``heads`` (a
    rank's local heads) or the config's."""
    h = heads or cfg.mlstm_heads
    hd = cfg.d_model // cfg.mlstm_heads
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(lead + (b, h, hd, hd), **f32),
            torch.zeros(lead + (b, h, hd), **f32),
            torch.full(lead + (b, h), NEG_INF, **f32))


def apply_mlstm(p: dict, x, cfg: ModelConfig, *, state=None,
                tp: Axis | None = None):
    """Stabilised mLSTM over x (B, S, d); state (C, n, m) as
    :func:`mlstm_state` without ``lead``.  Returns (out, state).  ``tp``:
    the model axis; ``p`` and the state then hold the rank's heads where
    the axis splits them."""
    b, s, d = x.shape
    h = p["wqkv"].shape[-2]
    ax = split_axis(tp, h, cfg.mlstm_heads)
    x = copy_to(x, ax)
    hd = d // cfg.mlstm_heads
    qkv = torch.einsum("bsd,dthk->btshk", x, p["wqkv"])  # (B, 3, S, H, hd)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    k = k * (hd ** -0.5)
    gates = torch.einsum("bsd,dgh->bgsh", x.float(), p["wgates"])
    i_log, f_log = gates[:, 0], nn.functional.logsigmoid(gates[:, 1])
    q, k, v = q.float(), k.float(), v.float()

    if state is None:
        state = mlstm_state((), b, cfg, x.device, heads=h)
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
    return reduce_from(torch.einsum("bshk,hkd->bsd", out, p["wo"]), ax), (
        c_mem, n, m)


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


def slstm_state(lead: tuple, b: int, cfg: ModelConfig, device=None,
                width: int | None = None):
    """Zeroed sLSTM state (c, n, h, m), each ``lead`` + (B, d) float32, the
    stabiliser m at NEG_INF; d is ``width`` (a rank's local columns) or
    the config's."""
    shape = lead + (b, width or cfg.d_model)
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z, z.clone(), z.clone(),
            torch.full(shape, NEG_INF, dtype=torch.float32, device=device))


def apply_slstm(p: dict, x, cfg: ModelConfig, *, state=None,
                tp: Axis | None = None):
    """sLSTM with an exponential input gate and a normaliser state over
    x (B, S, d); sequential by construction (the recurrent weight wr).
    Returns (out, state).  ``tp``: the model axis; ``p`` and the state
    then hold the rank's columns where the axis splits d, and each step
    reads the full h, all-gathered."""
    b, s, d = x.shape
    width = p["wx"].shape[-1]
    ax = split_axis(tp, width, d)
    gx = torch.einsum("bsd,dge->bsge", copy_to(x.float(), ax), p["wx"])
    if state is None:
        state = slstm_state((), b, cfg, x.device, width=width)
    c, n, h, m = state
    hs = []
    for t in range(s):
        h_all = copy_to(gather_from(h, ax, -1), ax)
        g = gx[:, t] + torch.einsum("bd,dge->bge", h_all, p["wr"])  # (B,4,d)
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
    out = gather_from(torch.stack(hs, dim=1), ax, -1)
    return out.to(x.dtype), (c, n, h, m)
