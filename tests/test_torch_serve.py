"""The port's dense LM and serving path against the JAX package's.

Both packages run the same weights: the JAX ``init_model`` parameters cross
to the port as numpy through ``repro_torch.convert.params_from_numpy``.
Everything runs in float32 on the CPU at ``reduced_config`` size, for the
four dense archs and a head-padded variant: prefill and three decode steps
hold logits and caches within 1e-4 and greedy tokens equal; a 4-request
``ServeEngine`` run, plain and SiM-paged, gives equal tokens and equal
``PagedStats``.  The JAX engine runs its model functions under
``jax.jit`` (the same functions, compiled once per shape instead of op by
op), which the tests install with ``monkeypatch``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.batching as jbatching
from repro.configs import ARCHS, reduced_config
from repro.launch.serve import serve as jax_serve
from repro.models.model import decode_step as jdecode
from repro.models.model import init_model as jinit
from repro.models.model import prefill as jprefill
from repro.serve.batching import Request as JRequest
from repro.serve.batching import ServeEngine as JServeEngine
from repro.serve.kvcache import SimPagedKVCache as JPagedCache
from repro.serve.serve_step import serve_decode_step as jserve_decode_step
from repro_torch import configs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import native
from repro_torch.launch.serve import serve
from repro_torch.models.model import (decode_step, init_model, make_caches,
                                      prefill)
from repro_torch.serve.batching import Request, ServeEngine
from repro_torch.serve.kvcache import SimPagedKVCache
from repro_torch.serve.serve_step import serve_decode_step

ARCH_CASES = {
    "qwen3-4b": {}, "granite-3-8b": {}, "olmo-1b": {}, "starcoder2-7b": {},
    # 12 q heads on 4 kv heads pad to 16 (ModelConfig.padded_heads)
    "granite-3-8b-padded": dict(n_heads=12, n_kv_heads=4),
}
JIT_PREFILL = jax.jit(jprefill, static_argnums=(1, 3))
JIT_DECODE = jax.jit(jdecode, static_argnums=(1,))


def _configs(case):
    arch = case.removesuffix("-padded")
    kw = dict(ARCH_CASES[case], dtype="float32")
    return (dataclasses.replace(reduced_config(ARCHS[arch]), **kw),
            dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                                **kw))


@pytest.fixture(scope="module", params=list(ARCH_CASES))
def models(request):
    """(JAX params, JAX cfg, port model, port cfg) on the same weights."""
    jcfg, cfg = _configs(request.param)
    params, _ = jinit(jax.random.PRNGKey(3), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return params, jcfg, model, cfg


@pytest.fixture
def jit_engine(monkeypatch):
    monkeypatch.setattr(jbatching, "prefill", JIT_PREFILL)
    monkeypatch.setattr(jbatching, "decode_step", JIT_DECODE)


def test_configs_are_the_jax_configs():
    assert {n: dataclasses.asdict(c) for n, c in configs.ARCHS.items()} == \
        {n: dataclasses.asdict(c) for n, c in ARCHS.items()}
    for name, c in ARCHS.items():
        port = configs.get_config(name)
        assert (port.padded_vocab, port.padded_heads) == (c.padded_vocab,
                                                          c.padded_heads)
        assert dataclasses.asdict(configs.reduced_config(port)) == \
            dataclasses.asdict(reduced_config(c))


def test_params_round_trip_bit_for_bit():
    """bfloat16 weights (the configs' own dtype) cross both ways unchanged,
    and the tree keeps the JAX package's structure."""
    jcfg, cfg = _configs("olmo-1b")
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in (jcfg, cfg))
    params, _ = jinit(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_numpy(params_from_numpy(tree, cfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    with pytest.raises(KeyError):
        params_from_numpy({"embed": tree["embed"]}, cfg, device="cpu")


@pytest.mark.parametrize("case", [
    "granite-3-8b-padded", "hymba-1.5b", "mixtral-8x22b", "kimi-k2-1t-a32b",
    "xlstm-350m", "internvl2-26b", "whisper-medium"])
def test_port_init_follows_the_jax_init(case):
    """The port's own random init draws other numbers, with the same
    shapes, dtypes (the router and recurrent gates float32 in a bf16
    model), spreads, norms of ones, mamba's a_log and d_skip, and zeroed
    padded heads; for every family."""
    if case in ARCH_CASES:
        jcfg, cfg = _configs(case)
    else:
        jcfg, cfg = (reduced_config(ARCHS[case]),
                     configs.reduced_config(configs.ARCHS[case]))
    jtree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg)[0])
    tree = params_to_numpy(init_model(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jtree),
                            jax.tree.leaves(tree)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert np.allclose(a.std(), b.std(), rtol=0.2), path
    for path, b in jax.tree_util.tree_leaves_with_path(tree):
        name = path[-1].key
        if name.startswith("norm_") or name in ("q_norm", "k_norm",
                                                "final_norm", "d_skip"):
            assert (b == 1).all(), path
        if name == "a_log":
            np.testing.assert_allclose(
                b, np.broadcast_to(np.log(np.arange(1, cfg.ssm_state + 1)),
                                   b.shape), rtol=1e-6)
    if cfg.padded_heads != cfg.n_heads:
        pad = np.arange(cfg.padded_heads) % (cfg.padded_heads // 4) >= 3
        assert not tree["blocks"]["attn"]["wq"][:, :, pad].any()
        assert not tree["blocks"]["attn"]["wo"][:, pad].any()


def test_prefill_and_decode_match_jax(models):
    params, jcfg, model, cfg = models
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 7))
    jl, jc = JIT_PREFILL(params, jcfg, jnp.asarray(tokens, jnp.int32), 16)
    logits, caches = prefill(model, torch.from_numpy(tokens), 16)
    for step in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
        for mine, theirs in zip(caches["kv"], jc["kv"]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       atol=1e-4, rtol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1))
        assert (logits.argmax(-1).numpy() == tok).all()
        if step < 3:
            jl, jc = JIT_DECODE(params, jcfg, jnp.asarray(tok[:, None],
                                                          jnp.int32),
                                jc, 7 + step)
            logits, caches = decode_step(model, torch.tensor(tok[:, None]),
                                         caches, 7 + step)
    if cfg.padded_vocab != cfg.vocab_size:
        assert (logits[:, cfg.vocab_size:] == -1e30).all()


def test_serve_decode_step_matches_jax(models):
    params, jcfg, model, cfg = models
    token = np.array([[5]], np.int32)
    jc = JIT_PREFILL(params, jcfg, jnp.asarray([[1, 2, 3]], jnp.int32), 8)[1]
    caches = prefill(model, torch.tensor([[1, 2, 3]]), 8)[1]
    jnext, jlogits, _ = jserve_decode_step(params, jcfg, jnp.asarray(token),
                                           jc, 3)
    nxt, logits, _ = serve_decode_step(model, torch.from_numpy(token),
                                       caches, 3)
    assert nxt.dtype == torch.int32 and nxt.shape == (1, 1)
    assert nxt.tolist() == np.asarray(jnext).tolist()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_jax(models, jit_engine, paged):
    """Four requests on two slots: continuous batching admits the last two
    as the first retire; tokens and the block table's counters agree."""
    params, jcfg, model, cfg = models
    rng = np.random.default_rng(4)
    reqs = [(rid, rng.integers(0, cfg.vocab_size, 6).tolist(), 2 + rid)
            for rid in range(4)]
    jcache = JPagedCache(jcfg, n_pages=32, page_tokens=4) if paged else None
    cache = SimPagedKVCache(cfg, n_pages=32, page_tokens=4,
                            device="cpu") if paged else None
    jeng = JServeEngine(params, jcfg, max_slots=2, cache_len=32,
                        paged_cache=jcache)
    eng = ServeEngine(model, max_slots=2, cache_len=32, paged_cache=cache)
    for rid, prompt, n in reqs:
        jeng.submit(JRequest(req_id=rid, prompt=prompt, max_new_tokens=n))
        eng.submit(Request(req_id=rid, prompt=prompt, max_new_tokens=n))
    want = {c.req_id: c.tokens for c in jeng.run()}
    got = {c.req_id: c.tokens for c in eng.run()}
    assert got == want and eng.steps == jeng.steps
    assert eng.prefills == 4 and eng.decodes == sum(
        len(t) - 1 for t in got.values())
    if paged:
        assert dataclasses.asdict(cache.stats) == dataclasses.asdict(
            jcache.stats)
        assert cache.stats.pages_freed == cache.stats.pages_allocated > 0
        assert len(cache._free) == cache.n_pages


def test_paged_cache_matches_jax():
    """Allocation, lookups (real search commands), writes, gathers and
    frees on both packages' caches: the same answers and counters."""
    jcfg, cfg = _configs("qwen3-4b")
    jpc = JPagedCache(jcfg, n_pages=64, page_tokens=4)
    pc = SimPagedKVCache(cfg, n_pages=64, page_tokens=4, device="cpu")
    assert [pc.allocate(7, 0), pc.allocate(7, 1), pc.allocate(9, 0)] == \
        [jpc.allocate(7, 0), jpc.allocate(7, 1), jpc.allocate(9, 0)]
    for seq, block in ((7, 0), (7, 1), (9, 0), (7, 2), (8, 0)):
        assert pc.lookup(seq, block) == jpc.lookup(seq, block)
    rng = np.random.default_rng(1)
    shape = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    toks = [rng.normal(size=shape).astype(np.float32) for _ in range(6)]
    for pos, t in enumerate(toks):
        pc.write_token(3, pos, torch.from_numpy(t), torch.from_numpy(2 * t))
        jpc.write_token(3, pos, jnp.asarray(t), jnp.asarray(2 * t))
    k, v = pc.gather_sequence(3, 6)
    jk, jv = jpc.gather_sequence(3, 6)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(k.numpy()[:, 5], toks[5])
    assert pc.free_sequence(3) == jpc.free_sequence(3) == 2
    assert pc.lookup(3, 0) is None and jpc.lookup(3, 0) is None
    assert pc._free == jpc._free
    assert dataclasses.asdict(pc.stats) == dataclasses.asdict(jpc.stats)
    with pytest.raises(KeyError):
        pc.gather_sequence(3, 1)


def test_launch_serve_matches_the_jax_launcher(jit_engine, capsys):
    """Both launchers draw the same requests from the same seed; weights
    differ (each package's own random init), token counts and the block
    table's counters do not."""
    _, jeng, jcache = jax_serve("qwen3-4b", n_requests=3, paged=True)
    comps, eng, cache = serve("qwen3-4b", n_requests=3, paged=True,
                              device="cpu")
    assert "SiM block table" in capsys.readouterr().out
    assert [len(c.tokens) for c in comps] == [len(c.tokens)
                                              for c in jeng.completed]
    assert dataclasses.asdict(cache.stats) == dataclasses.asdict(jcache.stats)
    assert native.LAUNCHES["flash_attention"] == 0     # the CPU never launches


def test_other_families_and_ring_caches_are_not_ported_yet():
    """Once refused, now ported: every other family inits, and a windowed
    config gets a ring of min(cache_len, window) slots (the parity of both
    is held in tests/test_torch_families*.py)."""
    for arch in ("mixtral-8x22b", "xlstm-350m", "hymba-1.5b",
                 "internvl2-26b", "whisper-medium"):
        cfg = configs.reduced_config(configs.get_config(arch))
        model = init_model(cfg, device="cpu")
        assert model.cfg.family == cfg.family != "dense"
    windowed = dataclasses.replace(
        configs.reduced_config(configs.get_config("qwen3-4b")),
        sliding_window=8)
    assert [t.shape[2] for t in make_caches(windowed, 1, 16)["kv"]] == [8, 8]
    assert [t.shape[2] for t in make_caches(windowed, 1, 4)["kv"]] == [4, 4]
