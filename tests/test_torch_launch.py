"""The port's launch tooling (specs, roofline, the trace counter, the dry
run) and its two examples against the JAX package's.

Specs are held leaf for leaf to the JAX ``jax.eval_shape`` stand-ins, and
the cache, batch and activation placements to the JAX ``PartitionSpec``s
on ``tests/test_torch_parallel.py``'s meshes (the JAX side in a subprocess
with eight forced host devices).  ``model_flops`` equals JAX's for every
arch and shape; the roofline's terms use the H100's constants.  The trace
counter's dot FLOPs equal JAX's ``analyze_hlo`` on the scan cases of
``tests/test_roofline.py`` written as Python loops; the attention kernel's
op is counted by its formula against a closed form; a trace on meta
tensors counts exactly what the same step run on the CPU counts (both
through the plain attention, the CPU's); and an L-layer model counts L
times a layer.  The dry run traces reduced cells on the production mesh
shapes over the ``fake`` process group in a subprocess.  The examples run
on the CPU and print the JAX examples' numbers.
"""
import dataclasses
import json
import os
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Shard
from torch.utils.flop_counter import FlopCounterMode

import repro.serve.batching as jbatching
from repro.configs import ARCHS as JARCHS
from repro.configs import shape_cells as jshape_cells
from repro.launch import roofline as jroofline
from repro.launch import specs as JS
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import decode_step as jdecode
from repro.models.model import prefill as jprefill
from repro_torch import configs, range_query_analytics, serve_lm
from repro_torch.configs import SHAPES, shape_cells
from repro_torch.kernels import native
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import roofline, specs
from repro_torch.launch.dryrun import build_step, lower_cell
from repro_torch.launch.trace_analysis import TraceCounter, count
from repro_torch.models.config import InputShape
from repro_torch.models.layers import plain_attention
from repro_torch.models.model import LM, init_model, prefill
from repro_torch.parallel.sharding import replicated
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import value_and_grad

REPO = Path(__file__).resolve().parents[1]
ARCHS = tuple(sorted(configs.ARCHS))
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SUBPROCESS_S = 600
META = torch.device("meta")


def _run(script: str, env_extra: dict) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env_extra)
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True,
                          timeout=SUBPROCESS_S)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _is_leaf(x) -> bool:
    """A tensor or stand-in, a placements tuple or a logical-axes tuple."""
    if hasattr(x, "shape"):
        return True
    return isinstance(x, tuple) and (
        all(isinstance(a, (str, type(None))) for a in x)
        or (x and all(isinstance(a, Placement) for a in x)))


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and tuples, paths as JAX's."""
    if _is_leaf(tree):
        return {prefix.rstrip("/"): tree}
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mesh(name) -> DeviceMesh:
    shape, names = MESHES[name]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).view(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def _as_spec(placements, mesh, ndim):
    """Placements -> the PartitionSpec entries, trailing Nones dropped."""
    out = []
    for d in range(ndim):
        axes = [n for n, p in zip(mesh.mesh_dim_names, placements)
                if isinstance(p, Shard) and p.dim == d]
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return out


def _jdtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


# ------------------------------------------------------------------ specs

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_eval_shape(arch):
    """Every parameter's shape, dtype and logical axes equal the JAX
    ``param_specs`` (``jax.eval_shape`` over ``init_model``)."""
    params, axes = specs.param_specs(configs.ARCHS[arch])
    jsds, jaxes = JS.param_specs(JARCHS[arch])
    got = {k: (tuple(t.shape), _jdtype(t)) for k, t in _flat(params).items()}
    want = {k: (tuple(s.shape), str(s.dtype)) for k, s in _jflat(jsds).items()}
    assert got == want
    assert all(t.device.type == "meta" for t in _flat(params).values())
    assert {k: list(v) for k, v in _flat(axes).items()} == {
        k: list(v) for k, v in _flat(jaxes).items()}


def _same_specs(got: dict, want) -> None:
    g = {k: (tuple(t.shape), _jdtype(t)) for k, t in _flat(got).items()}
    w = {k: (tuple(s.shape), str(s.dtype)) for k, s in _jflat(want).items()}
    assert g == w


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_equal_jax(arch, shape):
    """Batch, cache and encoder-output stand-ins of every arch x cell equal
    the JAX ones in shape and dtype (a skipped cell skips in both)."""
    cfg, jcfg = configs.ARCHS[arch], JARCHS[arch]
    cell, jcell = shape_cells(cfg)[shape], jshape_cells(jcfg)[shape]
    assert (cell is None) == (jcell is None)
    if cell is None:
        return
    _same_specs(specs.batch_specs(cfg, cell), JS.batch_specs(jcfg, jcell))
    _same_specs(specs.cache_specs(cfg, cell), JS.cache_specs(jcfg, jcell))
    enc, jenc = specs.enc_out_spec(cfg, cell), JS.enc_out_spec(jcfg, jcell)
    assert (enc is None) == (jenc is None)
    if enc is not None:
        assert (tuple(enc.shape), _jdtype(enc)) == (tuple(jenc.shape),
                                                    str(jenc.dtype))


def test_opt_specs_and_shardings_follow_the_params():
    cfg = configs.reduced_config(configs.ARCHS["olmo-1b"])
    params, axes = specs.param_specs(cfg)
    opt = specs.opt_specs(cfg, params, AdamWConfig(moment_dtype="float32"))
    for (k, p), (_, m) in zip(_flat(params).items(), _flat(opt["m"]).items()):
        assert m.shape == p.shape and m.dtype == torch.float32, k
    mesh = _mesh("2x2")
    p_sh = specs.param_shardings(cfg, mesh, axes, params)
    o_sh = specs.opt_shardings(p_sh, opt, mesh)
    assert o_sh["m"] is p_sh and o_sh["v"] is p_sh
    assert o_sh["step"] == replicated(mesh)


@pytest.fixture(scope="module")
def jax_cache_shardings():
    """{mesh: {arch|shape: {"cache": {path: spec}, "batch": spec,
    "act": spec}}} from the JAX package on 8 host devices."""
    script = textwrap.dedent("""
        import json, jax
        from repro.configs import ARCHS, shape_cells
        from repro.launch import specs as S
        from repro.launch.mesh import make_mesh
        def spec(s):
            return [list(p) if isinstance(p, tuple) else p for p in s.spec]
        out = {}
        for mname, (shape, names) in %r.items():
            mesh = make_mesh(shape, names)
            out[mname] = {}
            for arch, cfg in ARCHS.items():
                for sname, cell in shape_cells(cfg).items():
                    if cell is None:
                        continue
                    sds = S.cache_specs(cfg, cell)
                    sh = S.cache_shardings(cfg, cell, mesh, sds)
                    flat = {"/".join(str(getattr(k, "key", getattr(
                        k, "idx", k))) for k in path): spec(leaf)
                        for path, leaf in
                        jax.tree_util.tree_flatten_with_path(sh)[0]}
                    out[mname][arch + "|" + sname] = {
                        "cache": flat,
                        "batch": spec(S.batch_shardings(cfg, cell,
                                                        mesh)["tokens"]),
                        "act": spec(S.act_sharding(cfg, cell, mesh))}
        print("RESULT " + json.dumps(out))
    """ % (MESHES,))
    return _result(_run(script, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"}))


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return spec


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_batch_and_act_shardings_equal_jax(jax_cache_shardings,
                                                 mesh_name):
    """Every cache leaf's placements, the batch's and the activations' equal
    the JAX specs, for every arch x cell on both meshes (long_500k's batch
    of 1 replicated)."""
    mesh = _mesh(mesh_name)
    want_all = jax_cache_shardings[mesh_name]
    for arch in ARCHS:
        cfg = configs.ARCHS[arch]
        for sname, cell in shape_cells(cfg).items():
            if cell is None:
                continue
            want = want_all[f"{arch}|{sname}"]
            caches = specs.cache_specs(cfg, cell)
            sh = specs.cache_shardings(cfg, cell, mesh, caches)
            leaves, pls = _flat(caches), _flat(sh)
            got = {k: _as_spec(pls[k], mesh, leaves[k].ndim) for k in leaves}
            assert got == {k: _strip(v) for k, v in want["cache"].items()}, \
                (arch, sname)
            bsh = specs.batch_shardings(cfg, cell, mesh)["tokens"]
            assert _as_spec(bsh, mesh, 2) == _strip(want["batch"])
            assert _as_spec(specs.act_sharding(cfg, cell, mesh), mesh, 3) == \
                _strip(want["act"])


# --------------------------------------------------------------- roofline

@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    assert roofline.model_flops(configs.ARCHS[arch], SHAPES[shape]) == \
        jroofline.model_flops(JARCHS[arch], SHAPES[shape])


def test_roofline_terms_and_dominance_on_the_h100():
    """The H100 SXM's peaks: 989e12 bf16 FLOP/s, 3.35e12 B/s of HBM3, 50e9
    B/s of network a GPU; the terms, the bound and the dominant term."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NET_BW) == (
        989e12, 3.35e12, 50e9)
    assert roofline.INT32_OPS == 132 * 64 * 1.98e9      # ~16.7e12
    rl = roofline.Roofline(flops=989e12, bytes_accessed=3.35e12 * 2,
                           coll={"all-reduce": int(50e9)}, n_devices=256)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0)
    assert rl.collective_s == pytest.approx(1.0)
    assert rl.dominant == "memory" and rl.bound_s == pytest.approx(2.0)
    assert rl.roofline_fraction(989e12 / 2) == pytest.approx(0.25)
    rl = roofline.Roofline(flops=0, bytes_accessed=0, coll={},
                           n_devices=1)
    assert rl.roofline_fraction(1.0) == 0.0
    assert rl.to_dict()["dominant"] == "compute"


# ---------------------------------------------------------- trace counter

def _jax_dot_flops(fn, *sds) -> float:
    return analyze_hlo(jax.jit(fn).lower(*sds).compile().as_text()).dot_flops


def _meta(*shape, grad=False):
    return torch.empty(shape, device=META, requires_grad=grad)


def test_counter_equals_analyze_hlo_on_a_scan():
    def f(x, w):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=10)[0]

    x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    want = _jax_dot_flops(f, x, x)

    def g(x, w):
        for _ in range(10):
            x = x @ w
        return x

    _, c = count(g, _meta(128, 128), _meta(128, 128), device_type="meta")
    assert c.dot_flops == want == 10 * 2 * 128 ** 3
    assert c.n_ops == 10


def test_counter_equals_analyze_hlo_on_a_forward_backward_scan():
    """The JAX scan's body computes the carry's cotangent at every layer,
    step 0's included, so the torch loop differentiates x as well."""
    def jg(params, x):
        def loss(p):
            def body(c, w):
                return jnp.tanh(c @ w), None
            h, _ = jax.lax.scan(body, x, p)
            return jnp.sum(h ** 2)
        return jax.grad(loss)(params)

    want = _jax_dot_flops(jg, jax.ShapeDtypeStruct((6, 64, 64), jnp.float32),
                          jax.ShapeDtypeStruct((8, 64), jnp.float32))

    def g(p, x):
        h = x
        for i in range(6):
            h = torch.tanh(h @ p[i])
        return torch.autograd.grad((h ** 2).sum(), (p, x))

    _, c = count(g, _meta(6, 64, 64, grad=True), _meta(8, 64, grad=True),
                 device_type="meta")
    assert c.dot_flops == want == 6 * 2 * 8 * 64 * 64 * 3


def test_counter_equals_analyze_hlo_on_nested_scans():
    def f(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    x = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    want = _jax_dot_flops(f, x, x)

    def g(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    _, c = count(g, _meta(64, 64), _meta(64, 64), device_type="meta")
    assert c.dot_flops == want == 3 * 4 * 2 * 64 ** 3


def test_counter_bytes_views_writes_and_peak():
    """Operands plus results for a compute op; nothing for a view; an
    in-place op reads its operands and writes its first; an allocation
    moves nothing; the peak holds what lived at once."""
    a = torch.zeros(4, 8)
    counter = TraceCounter("cpu")
    counter.track(a)
    with counter:
        b = a + 1                       # 128 read, 128 written
        v = b.view(32)                  # a view: nothing
        b.mul_(2)                       # 128 + 128 read, 128 written
        e = torch.empty(16)             # an allocation: nothing moved
        del v
    c = counter.counts
    assert c.n_ops == 4
    assert c.result_bytes == 128 + 128
    assert c.bytes_accessed == (128 + 128) + (128 + 128)
    assert c.start_bytes == 128 and c.peak_bytes == 128 + 128 + 64
    del b, e
    assert counter._live_bytes == 128


def test_counter_counts_collectives_and_refuses_dtensor_ops():
    """A collective's operand bytes by kind, in a one-rank gloo group; an
    op on a DTensor is refused (its sharding propagation would count the
    op again at the global shape)."""
    script = textwrap.dedent("""
        import json, torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Shard
        from torch.distributed._functional_collectives import all_gather_tensor
        from repro_torch.launch.trace_analysis import TraceCounter
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
        t = torch.ones(4, 8)
        counter = TraceCounter("cpu")
        with counter:
            dist.all_reduce(t)
            all_gather_tensor(t, 0, mesh).wait()
        refused = False
        d = DTensor.from_local(t, mesh, [Shard(0)], run_check=False)
        try:
            with TraceCounter("cpu"):
                d + 1
        except TypeError:
            refused = True
        dist.destroy_process_group()
        print("RESULT " + json.dumps({"coll": counter.counts.collective_bytes,
                                      "refused": refused}))
    """)
    got = _result(_run(script, {}))
    assert got["coll"]["all-reduce"] == 128
    assert got["coll"]["all-gather"] == 128
    assert got["refused"]


@pytest.mark.parametrize("sq,sk,kw", [
    (64, 64, dict(causal=True)),
    (64, 64, dict(causal=False)),
    (64, 64, dict(causal=True, window=16)),
    (1, 128, dict(causal=True, q_offset=20)),
    (8, 128, dict(causal=True, q_offset=100, window=50)),
    (5, 3, dict(causal=True, q_offset=-2)),
    (16, 40, dict(causal=False, window=7)),
])
def test_attention_op_flops_equal_the_closed_form(sq, sk, kw):
    """The kernel's op on meta tensors (its route, no launch) is counted by
    its formula, 4·B·H·D a visible pair, in ``FlopCounterMode`` and in the
    trace counter alike; ``attention_pairs`` also gives the keys some row
    sees."""
    b, h, hkv, d = 2, 4, 2, 32
    q_offset = kw.get("q_offset", sk - sq)
    row = q_offset + np.arange(sq)[:, None]
    col = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if kw["causal"]:
        keep &= col <= row
    if "window" in kw:
        keep &= col > row - kw["window"]
    want = 4 * b * h * d * int(keep.sum())
    q = torch.empty((b, sq, h, d), device=META, dtype=torch.bfloat16)
    k = torch.empty((b, sk, hkv, d), device=META, dtype=torch.bfloat16)
    native.reset_launches()
    with FlopCounterMode(display=False) as fc:
        out = flash_attention(q, k, k, **kw)
    assert fc.get_total_flops() == want and out.shape == q.shape
    _, c = count(lambda: flash_attention(q, k, k, **kw), device_type="meta")
    assert c.dot_flops == want and c.n_ops >= 1
    assert native.LAUNCHES["flash_attention"] == 0
    pairs, seen = roofline.attention_pairs(sq, sk, causal=kw["causal"],
                                           window=kw.get("window"),
                                           q_offset=kw.get("q_offset"))
    assert (pairs, seen) == (int(keep.sum()), int(keep.any(0).sum()))


def test_the_log_sum_exp_op_counts_as_the_attention_op():
    """``flash_attention(return_lse=True)`` on meta tensors is the op
    ``repro_torch::flash_attention_lse_fwd``: the same FLOPs as the op
    without it, a (B, Sq, H) float32 second output from its fake
    implementation, and no launch."""
    q = torch.empty((2, 1, 8, 32), device=META, dtype=torch.bfloat16)
    k = torch.empty((2, 40, 2, 32), device=META, dtype=torch.bfloat16)
    native.reset_launches()
    _, plain = count(lambda: flash_attention(q, k, k, q_offset=30),
                     device_type="meta")
    (out, lse), c = count(lambda: flash_attention(q, k, k, q_offset=30,
                                                  return_lse=True),
                          device_type="meta")
    assert c.dot_flops == plain.dot_flops == 4 * 2 * 8 * 32 * 31
    assert out.shape == q.shape and lse.shape == (2, 1, 8)
    assert lse.dtype == torch.float32
    assert c.result_bytes == plain.result_bytes + lse.numel() * 4
    assert native.LAUNCHES["flash_attention"] == 0


def test_counter_leaves_out_the_log_sigmoid_scratch_buffer():
    """``log_sigmoid_forward``'s second output is a scratch buffer that the
    card's kernel leaves empty while meta and the CPU give it the input's
    size (the xLSTM gates): the counter counts the first output only, so a
    meta trace counts what the card runs."""
    x = torch.randn(4, 16)
    for device in ("cpu", "meta"):
        _, c = count(torch.nn.functional.logsigmoid, x.to(device),
                     device_type=device)
        assert (c.n_ops, c.result_bytes, c.bytes_accessed) == (1, 256, 512)


def _reduced(arch="olmo-1b", **kw):
    return dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                               **kw)


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_meta_trace_counts_what_a_cpu_run_counts(mode):
    """The same step on meta tensors and on the CPU, both through the plain
    attention (the CPU's route): every count and the peak equal."""
    cfg = _reduced(dtype="float32")

    def step(model, tokens):
        if mode == "prefill":
            return prefill(model, tokens, 16, attention=plain_attention)
        return value_and_grad(model, tokens, tokens.clone(),
                              attention=plain_attention)

    got = {}
    for dev in ("meta", "cpu"):
        model = LM(cfg, torch.device(dev)) if dev == "meta" \
            else init_model(cfg, device="cpu")
        tokens = torch.zeros((2, 12), dtype=torch.int32, device=dev)
        _, got[dev] = count(step, model, tokens, device_type=dev)
    assert got["meta"] == got["cpu"]
    assert got["meta"].dot_flops > 0 and got["meta"].peak_bytes > 0


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_an_l_layer_model_counts_l_times_a_layer(mode):
    """Every layer's ops reach the counter: the counts grow by the same
    amount from each layer to the next (the kernel's route, on meta)."""
    shape = InputShape("t", mode, 32, 2)
    cells = [build_step(_reduced(n_layers=n), shape) for n in (1, 2, 3, 5)]
    counts = [count(c.step, *c.inputs, device_type="meta")[1] for c in cells]
    for field in ("dot_flops", "bytes_accessed", "result_bytes", "n_ops"):
        v = [getattr(c, field) for c in counts]
        per_layer = v[1] - v[0]
        assert per_layer > 0 and v[2] - v[1] == per_layer, field
        assert v[3] - v[1] == 3 * per_layer, field


def test_lower_cell_report_without_a_mesh():
    """One card's step: the report's keys, the attention counted through
    the kernel's op, the useful-FLOPs ratio and roofline fraction."""
    cfg = _reduced()
    shape = InputShape("t", "train", 64, 4)
    counts, rep = lower_cell(cfg, shape)
    assert rep["n_devices"] == 1 and rep["mesh"] == "1"
    rl = rep["roofline"]
    assert rl["flops_per_dev"] == counts.dot_flops > 0
    assert rl["bound_s"] == max(rl["compute_s"], rl["memory_s"],
                                rl["collective_s"])
    assert rep["model_flops_global"] == roofline.model_flops(cfg, shape)
    assert 0 < rep["useful_flops_ratio"] < 1
    assert rep["memory_analysis"]["fits"]
    assert rep["memory_analysis"]["peak_bytes"] == counts.peak_bytes
    # live from the start: the weights, both moments and the batch
    n = sum(p.numel() for p in LM(cfg, META).parameters())
    assert counts.start_bytes == 2 * n + 2 * 4 * n + 4 + 2 * 4 * 64 * 4
    # the same trace twice counts the same; remat block runs the attention
    # in the forward and again in the recompute
    cell = build_step(cfg, shape)
    assert count(cell.step, *cell.inputs, device_type="meta")[1] == counts
    attn = roofline.attention_flops(4, 64, 64, cfg.padded_heads,
                                    cfg.head_dim)
    assert counts.dot_flops > 2 * cfg.n_layers * attn


# ---------------------------------------------------------------- dry run

def test_dry_run_on_the_production_meshes_over_the_fake_group(tmp_path):
    """``dryrun.main`` over reduced olmo-1b, qwen3-4b and mixtral-8x22b on
    the single and multi-pod mesh shapes (256 and 512 fake ranks): every
    cell ``ok``, the weights gathered over the mesh, the gradients
    all-reduced, and reports written."""
    script = textwrap.dedent("""
        import json
        from pathlib import Path
        from repro_torch import configs
        from repro_torch.launch import dryrun
        dryrun.get_config = lambda a: configs.reduced_config(
            configs.get_config(a))
        dryrun.OUT_DIR = Path(%r)
        fails = 0
        for arch in ("olmo-1b", "qwen3-4b", "mixtral-8x22b"):
            fails += dryrun.main(["--arch", arch, "--mesh", "both"])
        reports = {p.stem: json.loads(p.read_text())
                   for p in dryrun.OUT_DIR.glob("*.json")}
        print("RESULT " + json.dumps({"fails": fails, "reports": reports}))
    """ % str(tmp_path))
    got = _result(_run(script, {}))
    assert got["fails"] == 0
    reports = got["reports"]
    assert len(reports) == 3 * 4 * 2
    for tag, rep in reports.items():
        arch, shape, mesh = tag.split("__")
        if "skipped" in rep:
            assert shape == "long_500k" and arch != "mixtral-8x22b"
            continue
        assert rep["status"] == "ok", rep.get("error")
        assert rep["n_devices"] == {"single": 256, "multi": 512}[mesh]
        coll = rep["roofline"]["collective_bytes_per_dev"]
        assert coll["all-gather"] > 0          # the weights, gathered
        if rep["mode"] == "train":
            assert coll["all-reduce"] > 0      # the gradients, summed
        assert rep["roofline"]["flops_per_dev"] > 0
        assert rep["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")


# --------------------------------------------------------------- examples

def test_range_query_analytics_equals_the_jax_example(capsys):
    """Every number of the JAX example (on ``ScalarBackend``), printed line
    for line, from the port's on the batched backend's plain versions, with
    two launches (one ``sim_plan``, one ``sim_gather``) a select."""
    example = runpy.run_path(str(REPO / "examples" /
                                 "range_query_analytics.py"))
    example["main"]()
    want = capsys.readouterr().out
    got = range_query_analytics.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.replace(" (cpu)", "") == want
    assert got["rows"] == 20_000 and got["pages"] == 40
    assert got["exact"]["rows"] == got["exact"]["truth"] == \
        got["approx"]["rows"]
    assert [r["fp_rate"] for r in got["fp_sweep"]][0] == 0.0
    assert got["kernel_launches"] == 2 * 3
    assert f"{got['point']['chunk_bytes']} B of chunks" in want


def test_serve_lm_equals_the_jax_example(monkeypatch, capsys):
    """The JAX example's counts (its engine's model functions jitted):
    12 completions, the tokens generated and the block table's searches a
    token.  Weights differ (each package's own random init); no request
    stops early, so the counts do not depend on them."""
    monkeypatch.setattr(jbatching, "prefill",
                        jax.jit(jprefill, static_argnums=(1, 3)))
    monkeypatch.setattr(jbatching, "decode_step",
                        jax.jit(jdecode, static_argnums=(1,)))
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    runpy.run_path(str(REPO / "examples" / "serve_lm.py"))["main"]()
    want = capsys.readouterr().out.splitlines()
    got = serve_lm.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2:] == want[-2:]
    assert [ln for ln in lines if "block table" in ln] == \
        [ln for ln in want if "block table" in ln]
    assert len(got["completions"]) == 12
    assert got["tokens"] == sum(len(c.tokens) for c in got["completions"])
    assert f"{len(got['completions'])} completions, {got['tokens']} tokens" \
        in want[-2]
    assert native.LAUNCHES["flash_attention"] == 0     # the CPU never launches
