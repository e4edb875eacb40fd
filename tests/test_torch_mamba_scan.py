"""The mamba heads' kernels (``kernels/mamba_scan``) off the card: their
plain version against the scan autograd runs and a closed form of it,
their meta route, and ``apply_mamba``'s routes.

On the CPU the ops run ``ref.py``; on meta tensors they check their
operands and give the outputs' shapes without a launch.  The kernels
themselves are held against ``ref.py`` on the card in
``tests/test_torch_gpu.py``.
"""
import dataclasses

import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import native
from repro_torch.kernels.mamba_scan.ops import mamba_conv, mamba_scan
from repro_torch.kernels.mamba_scan.ref import (causal_conv_ref, gate,
                                               scan_inputs,
                                               selective_scan_ref)
from repro_torch.models import ssm
from repro_torch.models.ssm import apply_mamba

META = torch.device("meta")


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen).to(dtype)


def _scan_case(s: int, b: int = 2, e: int = 12, n: int = 4, seed: int = 0):
    """xz (B, S, 2e), a nonzero conv tail, conv_w, proj, a_log, d_skip and
    a nonzero state, float32."""
    gen = torch.Generator().manual_seed(seed + s)
    return dict(xz=_randn(gen, b, s, 2 * e), tail=_randn(gen, b, 3, e),
                conv_w=_randn(gen, 4, e) * 0.5,
                proj=_randn(gen, b, s, 2 * n + 1),
                a_log=_randn(gen, e, n) * 0.5, d_skip=_randn(gen, e),
                state=_randn(gen, b, e, n))


def _chunked_scan(log_decay, drive, h0, chunk=16):
    """Every state of the scan (B, S, D, N) in closed form, ``chunk``
    positions at a time from the state before them: h_t = exp(L_t) h +
    sum over tau <= t of exp(L_t - L_tau) drive_tau, L the chunk's running
    sum of the log decays, so that no exponent is above 0."""
    out = torch.empty_like(drive)
    h = h0
    for i in range(0, drive.shape[1], chunk):
        run = log_decay[:, i:i + chunk].cumsum(1)           # (B, c, D, N)
        c = run.shape[1]
        later = torch.ones((c, c), dtype=torch.bool).tril()[..., None, None]
        weights = torch.exp((run[:, :, None] - run[:, None]).masked_fill(
            ~later, float("-inf")))                          # (B, t, tau, ..)
        out[:, i:i + c] = (weights * drive[:, None, i:i + c]).sum(2) + \
            torch.exp(run) * h[:, None]
        h = out[:, i + c - 1]
    return out


@pytest.mark.parametrize("s", [1, 15, 16, 17, 40])
def test_the_sequential_recurrence_equals_the_chunked_scan_and_the_loop(s):
    """``ref.py``'s scan, one position a step, against the closed form in
    16-position chunks and against ``_mamba_scan``'s loop (the scan under
    autograd), from a nonzero state after a conv with a nonzero tail: y and
    the final state within 1e-5 relative.  The conv over the whole sequence
    equals the conv over its two halves, the first's tail carried to the
    second, bit for bit."""
    c = _scan_case(s)
    e = c["conv_w"].shape[1]
    u, tail = causal_conv_ref(c["xz"][..., :e], c["tail"], c["conv_w"])
    half = s // 2
    u1, t1 = causal_conv_ref(c["xz"][:, :half, :e], c["tail"], c["conv_w"])
    u2, t2 = causal_conv_ref(c["xz"][:, half:, :e], t1, c["conv_w"])
    assert torch.equal(torch.cat([u1, u2], 1), u) and torch.equal(t2, tail)
    z = c["xz"][..., e:]
    y_ref, h_ref = selective_scan_ref(u, z, c["proj"], c["a_log"],
                                      c["d_skip"], c["state"])
    bmat, cmat, delta, a = scan_inputs(c["proj"], c["a_log"])
    hs = _chunked_scan(torch.einsum("bsd,dn->bsdn", delta, a),
                       torch.einsum("bsd,bsn->bsdn", delta * u, bmat),
                       c["state"])
    chunked = (torch.einsum("bsdn,bsn->bsd", hs, cmat) + u * c["d_skip"],
               hs[:, -1])
    with torch.enable_grad():
        loop = ssm._mamba_scan(u, delta, a, bmat, cmat, c["d_skip"],
                               c["state"])
    for y, h in (chunked, loop):
        y = gate(y, z, u.dtype)
        for got, want in ((y, y_ref), (h, h_ref)):
            err = float((got - want).norm() / want.norm())
            assert err < 1e-5, err


class _Ops(TorchDispatchMode):
    """The names of the ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _meta_operands(case: str, b=2, s=5, e=32, n=16, k=4):
    bf16 = dict(device=META, dtype=torch.bfloat16)
    f32 = dict(device=META, dtype=torch.float32)
    conv = dict(xz=torch.empty(b, s, 2 * e, **bf16),
                conv_tail=torch.empty(b, k - 1, e, **bf16),
                conv_w=torch.empty(k, e, **bf16))
    scan = dict(xz=conv["xz"], u=torch.empty(b, s, e, **bf16),
                proj=torch.empty(b, s, 2 * n + 1, **bf16),
                a_log=torch.empty(e, n, **f32), d_skip=torch.empty(e, **f32),
                state=torch.empty(b, e, n, **f32))
    op, what = case.split(".")
    args = conv if op == "conv" else scan
    if what == "dtype":
        args["xz"] = args["xz"].half()
    elif what == "shape":
        key = "conv_tail" if op == "conv" else "state"
        args[key] = args[key][:, 1:]
    elif what == "stride":
        key = "conv_tail" if op == "conv" else "state"
        args[key] = args[key].transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "proj":
        args["proj"] = args["proj"].half()
    elif what == "states":
        args["a_log"] = torch.empty(e, 6, **f32)
        args["proj"] = torch.empty(b, s, 13, **bf16)
        args["state"] = torch.empty(b, e, 6, **f32)
    return (mamba_conv if op == "conv" else mamba_scan), args


@pytest.mark.parametrize("case", [
    "conv.ok", "conv.dtype", "conv.shape", "conv.stride",
    "scan.ok", "scan.dtype", "scan.shape", "scan.stride", "scan.proj",
    "scan.states"])
def test_the_meta_route_checks_and_launches_nothing(case):
    """On meta tensors each op gives its output's shape through one op of
    its own and writes its state in place (returns the tensor it was
    handed), launching nothing; it refuses another dtype, shape or stride
    (and the scan another proj dtype or a state count the kernel lacks)."""
    fn, args = _meta_operands(case)
    before = dict(native.LAUNCHES)
    if not case.endswith(".ok"):
        with pytest.raises(ValueError):
            fn(**args)
        assert native.LAUNCHES == before
        return
    with _Ops() as ops:
        y, held = fn(**args)
    state = args["conv_tail" if fn is mamba_conv else "state"]
    assert held is state and y.device == META
    assert y.shape == args["xz"].shape[:2] + (args["xz"].shape[2] // 2,)
    assert y.dtype == args["xz"].dtype
    assert ops.names == ["mamba_conv" if fn is mamba_conv else "mamba_scan"]
    assert native.LAUNCHES == before


def test_the_cpu_route_of_the_ops_is_ref_in_place():
    """On the CPU the ops give ``ref.py``'s outputs and write the new tail
    and state into the tensors they were handed."""
    c = _scan_case(7)
    e = c["conv_w"].shape[1]
    tail, state = c["tail"].clone(), c["state"].clone()
    u, held = mamba_conv(c["xz"], tail, c["conv_w"])
    u_ref, tail_ref = causal_conv_ref(c["xz"][..., :e], c["tail"],
                                      c["conv_w"])
    assert held is tail and torch.equal(u, u_ref)
    assert torch.equal(tail, tail_ref)
    y, held = mamba_scan(c["xz"], u, c["proj"], c["a_log"], c["d_skip"],
                         state)
    y_ref, h_ref = selective_scan_ref(u, c["xz"][..., e:], c["proj"],
                                      c["a_log"], c["d_skip"], c["state"])
    assert held is state and torch.equal(y, y_ref)
    assert torch.equal(state, h_ref)


def _apply_mamba_before(p, x, cfg, *, state=None, conv_state=None,
                        single_step=False):
    """``apply_mamba`` as it was before the kernels (one device, no
    ``tp``), kept verbatim to hold the plain routes to their bits.  Over a
    sequence it calls ``_mamba_scan``, whose loop autograd runs as it did
    then (without autograd it took 16-position chunks then, now gone)."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    ax, w_in, x_proj = ssm._mamba_weights(p, x.shape[-1], None)
    d = w_in.shape[-1] // 2
    xz = torch.einsum("bsd,de->bse", x, w_in)
    u, z = xz[..., :d], xz[..., d:]
    kconv = cfg.ssm_conv
    if conv_state is None:
        conv_state = torch.zeros((b, kconv - 1, d), dtype=u.dtype,
                                 device=u.device)
    upad = torch.cat([conv_state, u], dim=1)
    u = sum(upad[:, i:i + s] * p["conv_w"][i] for i in range(kconv))
    u = nn.functional.silu(u.float()).to(x.dtype)
    new_conv_state = upad[:, -(kconv - 1):] if kconv > 1 else conv_state
    proj = torch.einsum("bsd,de->bse", u, x_proj).float()
    bmat, cmat, dt_raw = proj[..., :n], proj[..., n:2 * n], proj[..., 2 * n:]
    delta = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))
    delta = delta.expand(b, s, d)
    a = -torch.exp(p["a_log"])
    if state is None:
        state = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    if single_step:
        dec = torch.exp(torch.einsum("bd,dn->bdn", delta[:, 0], a))
        drv = torch.einsum("bd,bn->bdn", delta[:, 0] * u[:, 0].float(),
                           bmat[:, 0])
        state = dec * state + drv
        y = torch.einsum("bdn,bn->bd", state, cmat[:, 0])[:, None]
        y = y + u.float() * p["d_skip"]
    else:
        y, state = ssm._mamba_scan(u.float(), delta, a, bmat, cmat,
                                   p["d_skip"], state)
    y = y.to(x.dtype) * nn.functional.silu(z.float()).to(x.dtype)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"])
    return out, (state, new_conv_state)


def _mamba_params(dtype, device="cpu", seed=0):
    cfg = reduced_config(get_config("hymba-1.5b-base"))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    mod = ssm.Mamba(cfg, 1, device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in mod.parameters():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
    return cfg, {k: v[0] for k, v in mod.named_parameters()}


def _decoded_before(p, x, cfg, *, state=None, conv_state=None):
    """The code before the kernels' decode step (``single_step``) run on
    x one position at a time: (the outputs, (the final state and tail))."""
    outs = []
    for t in range(x.shape[1]):
        out, (state, conv_state) = _apply_mamba_before(
            p, x[:, t:t + 1], cfg, state=state, conv_state=conv_state,
            single_step=True)
        outs.append(out)
    return torch.cat(outs, 1), (state, conv_state)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,given", [
    (1, True), (1, False), (21, True), (21, False)])
def test_apply_mamba_on_the_cpu_gives_the_bits_it_gave_before(
        s, given, dtype, grad):
    """The CPU's two routes, from a given state and tail or from zeros, at
    one position and over a sequence.  Under autograd the output, the
    state and the tail equal the code before the kernels over the sequence
    bit for bit; without autograd (serving, the ``mamba_scan`` op's CPU
    route) they equal that code's decode step run position by position
    bit for bit, and the given state and tail are written in place."""
    cfg, p = _mamba_params(dtype)
    gen = torch.Generator().manual_seed(s)
    dt = p["in_proj"].dtype
    e, n = cfg.mamba_width, cfg.ssm_state
    x = _randn(gen, 2, s, cfg.d_model, dtype=dt)
    kw = dict(state=_randn(gen, 2, e, n),
              conv_state=_randn(gen, 2, cfg.ssm_conv - 1, e, dtype=dt)) \
        if given else {}
    with torch.set_grad_enabled(grad):
        got = apply_mamba(p, x, cfg, **{k: v.clone() for k, v in kw.items()})
        want = _apply_mamba_before(p, x, cfg, **kw) if grad else \
            _decoded_before(p, x, cfg, **kw)
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_under_autograd_apply_mamba_records_a_gradient_without_kernels(
        device):
    """Under autograd ``apply_mamba`` takes the plain route on any device:
    no mamba op is dispatched, nothing launches, and the output carries a
    gradient back to the parameters (on the CPU, a finite nonzero one)."""
    cfg, p = _mamba_params("float32")
    p = {k: v.detach().to(device).requires_grad_() for k, v in p.items()}
    x = torch.randn(2, 9, cfg.d_model).to(device)
    before = dict(native.LAUNCHES)
    with _Ops() as ops:
        out, _ = apply_mamba(p, x, cfg)
    assert out.grad_fn is not None
    assert not {"mamba_conv", "mamba_scan"} & set(ops.names)
    assert native.LAUNCHES == before
    if device == "cpu":
        out.square().sum().backward()
        for name in ("in_proj", "conv_w", "a_log", "out_proj"):
            g = p[name].grad
            assert g is not None and torch.isfinite(g).all() and g.abs().sum()


@pytest.mark.parametrize("s", [1, 33])
def test_serving_on_meta_runs_the_two_ops_in_place(s):
    """Without autograd on meta tensors (the card's route, traced):
    ``apply_mamba`` dispatches each op once, whatever S, none of the plain
    scan's ops, and returns the state and tail it was handed."""
    cfg, p = _mamba_params("bfloat16", device=META)
    e, n = cfg.mamba_width, cfg.ssm_state
    x = torch.empty(2, s, cfg.d_model, device=META, dtype=torch.bfloat16)
    views = (torch.empty(2, e, n, device=META),
             torch.empty(2, cfg.ssm_conv - 1, e, device=META,
                         dtype=torch.bfloat16))
    with torch.no_grad(), _Ops() as ops:
        out, new = apply_mamba(p, x, cfg, state=views[0],
                               conv_state=views[1])
    assert out.shape == x.shape
    assert new[0] is views[0] and new[1] is views[1]
    assert ops.names.count("mamba_conv") == ops.names.count("mamba_scan") == 1
    assert not {"cumsum", "exp", "logaddexp", "silu"} & set(ops.names)


@pytest.mark.parametrize("case", ["1.bfloat16", "21.bfloat16", "21.float32",
                                  "strided.state", "strided.conv_state"])
def test_serving_on_the_cpu_writes_the_given_state_in_place(case):
    """Without autograd on the CPU, as on the card, ``apply_mamba`` writes
    the new state and tail into the tensors it was handed and returns
    them, with the bits of the autograd route, which returns new tensors
    and leaves the given ones as they were.  Like the kernels, it refuses
    a state or tail that is not contiguous."""
    what, kind = case.split(".")
    s = 21 if what == "strided" else int(what)
    cfg, p = _mamba_params(kind if kind in ("float32", "bfloat16")
                           else "bfloat16")
    dt = p["in_proj"].dtype
    gen = torch.Generator().manual_seed(s)
    e, n = cfg.mamba_width, cfg.ssm_state
    x = _randn(gen, 2, s, cfg.d_model, dtype=dt)
    given = dict(state=_randn(gen, 2, e, n),
                 conv_state=_randn(gen, 2, cfg.ssm_conv - 1, e, dtype=dt))
    keep = {k: v.clone() for k, v in given.items()}
    if what == "strided":
        t = given[kind]
        given[kind] = t.transpose(1, 2).contiguous().transpose(1, 2)
        with torch.no_grad(), pytest.raises(ValueError, match=kind[:5]):
            apply_mamba(p, x, cfg, **given)
        return
    out, new = apply_mamba(p, x, cfg, **given)          # autograd on
    for k in given:
        assert torch.equal(given[k], keep[k])
    with torch.no_grad():
        got, held = apply_mamba(p, x, cfg, **given)
    assert held[0] is given["state"] and held[1] is given["conv_state"]
    assert torch.equal(got, out)
    for g, w in zip(held, new):
        assert torch.equal(g, w)
