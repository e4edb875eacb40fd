"""The port's non-dense families and sliding-window ring caches against the
JAX package's, forward.

Both packages run the same weights: the JAX ``init_model`` parameters cross
to the port through ``repro_torch.convert.params_from_numpy``; tokens,
patch embeddings and audio frames are drawn from numpy seeds.  The JAX
package runs its plain ``_attend`` (its model path has no Pallas call on
the CPU) under ``jax.jit``; the port runs its plain versions on the CPU.
Cases, at ``reduced_config`` size: hymba (hybrid, window 8, a global layer
every 2), mixtral (moe, window 8) and kimi-k2 (moe with a shared expert),
each MoE at ``capacity_factor`` 1.25, where drops bind, and 8.0, xlstm
(ssm), internvl2 (vlm, 8 stub patches), whisper (audio, 16 stub frames)
and reduced qwen3 with ``sliding_window=8`` (a windowed dense config).

Tolerances.  float32: ``train_logits`` and ``aux``, ``prefill`` logits and
every cache leaf, three decode steps' logits and caches, each within 1e-4
(absolute and relative); the ring cases at prompt lengths below, at and
above the ring's 8 slots, their decode steps crossing the wrap.  bfloat16,
once per family: the logits of ``train_logits``, ``prefill`` and one
decode step within 3e-2 relative L2 error of JAX's (the two round each bf16
product and sum at other points; 2^-8 is one bf16 rounding).

Serving: both engines on the same weights give equal tokens; the JAX
engine's paged mirror past a ring and its failure on audio are shown,
beside the port's refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.batching as jbatching
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.launch.serve import serve as jax_serve
from repro.models.model import decode_step as jdecode
from repro.models.model import init_model as jinit
from repro.models.model import prefill as jprefill
from repro.models.model import train_logits as jtrain_logits
from repro.serve.batching import Request as JRequest
from repro.serve.batching import ServeEngine as JServeEngine
from repro.serve.kvcache import SimPagedKVCache as JPagedCache
from repro_torch import configs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch.serve import serve
from repro_torch.models import model as port_model
from repro_torch.models.model import (_layer_window, decode_step,
                                      init_model, make_caches, prefill,
                                      train_logits)
from repro_torch.models.moe import capacity
from repro_torch.serve.batching import Request, ServeEngine
from repro_torch.serve.kvcache import SimPagedKVCache

# case -> (arch, config overrides)
CASES = {
    "hymba": ("hymba-1.5b", {}),
    "mixtral": ("mixtral-8x22b", {}),
    "mixtral-cf8": ("mixtral-8x22b", dict(capacity_factor=8.0)),
    "kimi": ("kimi-k2-1t-a32b", {}),
    "kimi-cf8": ("kimi-k2-1t-a32b", dict(capacity_factor=8.0)),
    "xlstm": ("xlstm-350m", {}),
    "internvl": ("internvl2-26b", {}),
    "whisper": ("whisper-medium", {}),
    "qwen3-window": ("qwen3-4b", dict(sliding_window=8)),
}
RING = 8               # the ring of every windowed case: min(16, window 8)
CACHE_LEN = 16
TOL = 1e-4
BF16_REL = 3e-2
JIT_LOGITS = jax.jit(jtrain_logits, static_argnums=(1,))
JIT_PREFILL = jax.jit(jprefill, static_argnums=(1, 3))
JIT_DECODE = jax.jit(jdecode, static_argnums=(1,))


def _configs(case, **kw):
    arch, over = CASES[case]
    kw = dict(over, **kw)
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jreduced(JARCHS[arch]), **kw),
            dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                                **kw))


def _pair(case, **kw):
    jcfg, cfg = _configs(case, **kw)
    params, _ = jinit(jax.random.PRNGKey(3), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return params, jcfg, model, cfg


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(JAX params, JAX cfg, port model, port cfg) on the same weights."""
    return _pair(request.param)


def _frontend(cfg, rng, batch):
    """Stub embeddings as numpy float32, or None for a text-only config."""
    n = {"vision_stub": cfg.frontend_tokens,
         "audio_stub": cfg.encoder_seq}.get(cfg.frontend)
    if n is None:
        return None
    return rng.normal(size=(batch, n, cfg.d_model)).astype(np.float32)


def _both(a):
    return (None, None) if a is None else (jnp.asarray(a),
                                           torch.from_numpy(a.copy()))


def _leaves(tree):
    """Cache leaves in one order for both packages: dict keys sorted,
    tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL,
                               err_msg=what)


def _caches_close(got, want, what):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(b.shape), (what, i)
        _close(a, b, f"{what}: cache leaf {i}")


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- forward

def test_train_logits_and_aux_match_jax(pair):
    params, jcfg, model, cfg = pair
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12))
    jfe, fe = _both(_frontend(cfg, rng, 2))
    want, jaux = JIT_LOGITS(params, jcfg, jnp.asarray(tokens, jnp.int32),
                            frontend_embeds=jfe)
    with torch.no_grad():
        got, aux = train_logits(model, torch.from_numpy(tokens),
                                frontend_embeds=fe)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert got.shape == (2, 12, cfg.padded_vocab)
    _close(got, want, "train_logits")
    _close(aux, jaux, "aux")
    assert (float(aux) > 0) == cfg.is_moe


def _prompt_lengths(case):
    _, cfg = _configs(case)
    return (6, RING, 11) if cfg.sliding_window else (12,)


@pytest.mark.parametrize("case,s", [(c, s) for c in CASES
                                    for s in _prompt_lengths(c)])
def test_prefill_and_decode_match_jax(case, s):
    """Logits and every cache leaf after prefill and after each of three
    decode steps; on a ring the prompt is shorter than, as long as and
    longer than its 8 slots, and the decode steps cross the wrap."""
    params, jcfg, model, cfg = _pair(case)
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, cfg.vocab_size, (2, s))
    jfe, fe = _both(_frontend(cfg, rng, 2))
    jl, jc = JIT_PREFILL(params, jcfg, jnp.asarray(tokens, jnp.int32),
                         CACHE_LEN, frontend_embeds=jfe)
    logits, caches = prefill(model, torch.from_numpy(tokens), CACHE_LEN,
                             frontend_embeds=fe)
    if cfg.sliding_window:
        assert caches["kv"][0].shape[2] == RING
    for step in range(4):
        _close(logits, jl, f"logits after {step} decode steps")
        _caches_close(caches, jc, f"caches after {step} decode steps")
        tok = np.array(jnp.argmax(jl, -1))[:, None]
        assert (logits.argmax(-1).numpy() == tok[:, 0]).all()
        if step < 3:
            jl, jc = JIT_DECODE(params, jcfg, jnp.asarray(tok, jnp.int32),
                                jc, s + step, enc_out=jc.get("enc_out"))
            logits, caches = decode_step(model, torch.from_numpy(tok),
                                         caches, s + step,
                                         enc_out=caches.get("enc_out"))


def test_ring_slot_p_mod_c_holds_position_p():
    """Layer 0's k/v depend on the embeddings alone, so a ring prefill's
    slot p % C must hold bit for bit what a contiguous cache holds at p,
    for every p of the last C positions, in both packages."""
    params, jcfg, model, cfg = _pair("qwen3-window")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 19))
    flat_j = dataclasses.replace(jcfg, sliding_window=None)
    flat = dataclasses.replace(cfg, sliding_window=None)
    jring = JIT_PREFILL(params, jcfg, jnp.asarray(tokens, jnp.int32),
                        CACHE_LEN)[1]["kv"]
    jfull = JIT_PREFILL(params, flat_j, jnp.asarray(tokens, jnp.int32),
                        32)[1]["kv"]
    ring = prefill(model, torch.from_numpy(tokens), CACHE_LEN)[1]["kv"]
    flat_model = params_from_numpy(jax.tree.map(np.asarray, params), flat,
                                   device="cpu")
    full = prefill(flat_model, torch.from_numpy(tokens), 32)[1]["kv"]
    for p in range(19 - RING, 19):
        for r, f in zip(ring, full):
            assert torch.equal(r[0, :, p % RING], f[0, :, p])
        for r, f in zip(jring, jfull):
            np.testing.assert_array_equal(np.asarray(r[0, :, p % RING]),
                                          np.asarray(f[0, :, p]))


@pytest.mark.parametrize("case", ["mixtral", "kimi"])
def test_moe_drops_bind_at_capacity_factor_1_25(case, monkeypatch):
    """At capacity_factor 1.25 some expert of some layer is routed more
    tokens than its capacity (so the parity tests above cover drops); at
    8.0 none is."""
    over = {}

    def counting(p, x, cfg, **kw):
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(),
                                           p["router"]), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :cfg.top_k]
        routed = torch.zeros(x.shape[0], cfg.n_experts)
        routed.scatter_add_(1, top.reshape(x.shape[0], -1),
                            torch.ones(top.reshape(x.shape[0], -1).shape))
        over[cfg.capacity_factor] = max(
            over.get(cfg.capacity_factor, 0),
            int(routed.max()) - capacity(cfg, x.shape[1]))
        return apply_moe(p, x, cfg, **kw)

    apply_moe = port_model.apply_moe
    monkeypatch.setattr(port_model, "apply_moe", counting)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, 12)))
    for cf in (1.25, 8.0):
        model = _pair(case, capacity_factor=cf)[2]
        with torch.no_grad():
            train_logits(model, tokens)
    assert over[1.25] > 0 and over[8.0] <= 0


@pytest.mark.parametrize("case", ["hymba", "mixtral", "xlstm", "internvl",
                                  "whisper", "qwen3-window"])
def test_bfloat16_matches_jax(case):
    """One bf16 run per family: train_logits, prefill and a decode step
    within BF16_REL relative L2 error of JAX's."""
    params, jcfg, model, cfg = _pair(case, dtype="bfloat16")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11))
    jfe, fe = _both(_frontend(cfg, rng, 2))
    v = slice(0, cfg.vocab_size)
    want = JIT_LOGITS(params, jcfg, jnp.asarray(tokens, jnp.int32),
                      frontend_embeds=jfe)[0]
    with torch.no_grad():
        got = train_logits(model, torch.from_numpy(tokens),
                           frontend_embeds=fe)[0]
    assert _rel_l2(got[..., v], np.asarray(want)[..., v]) < BF16_REL
    jl, jc = JIT_PREFILL(params, jcfg, jnp.asarray(tokens, jnp.int32),
                         CACHE_LEN, frontend_embeds=jfe)
    logits, caches = prefill(model, torch.from_numpy(tokens), CACHE_LEN,
                             frontend_embeds=fe)
    assert _rel_l2(logits[:, v], np.asarray(jl)[:, v]) < BF16_REL
    tok = np.array(jnp.argmax(jl, -1))[:, None]
    jl = JIT_DECODE(params, jcfg, jnp.asarray(tok, jnp.int32), jc, 11,
                    enc_out=jc.get("enc_out"))[0]
    logits = decode_step(model, torch.from_numpy(tok), caches, 11,
                         enc_out=caches.get("enc_out"))[0]
    assert logits.dtype == torch.float32
    assert _rel_l2(logits[:, v], np.asarray(jl)[:, v]) < BF16_REL


def test_layer_windows_follow_the_jax_masks():
    """hymba's global layers are ids 0, 11 and 22 of 32; the others and
    every windowed config without global layers attend within the window;
    a config without a window has none."""
    hymba = configs.get_config("hymba-1.5b")
    assert [i for i in range(hymba.n_layers)
            if _layer_window(hymba, i) is None] == [0, 11, 22]
    assert {_layer_window(hymba, i) for i in (1, 10, 12, 31)} == {1024}
    mixtral = configs.get_config("mixtral-8x22b")
    assert {_layer_window(mixtral, i) for i in range(56)} == {4096}
    assert _layer_window(configs.get_config("qwen3-4b"), 0) is None


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_every_config_inits_prefills_and_decodes(arch):
    """Every one of the 10 configs, reduced, in its own dtype: finite
    logits of the expected shapes and caches of the expected layout."""
    cfg = configs.reduced_config(configs.get_config(arch))
    model = init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 12)))
    fe = _frontend(cfg, rng, 1)
    fe = None if fe is None else torch.from_numpy(fe)
    logits, caches = prefill(model, tokens, CACHE_LEN, frontend_embeds=fe)
    for i in range(3):
        logits, caches = decode_step(model, logits.argmax(-1)[:, None],
                                     caches, 12 + i,
                                     enc_out=caches.get("enc_out"))
        assert logits.shape == (1, cfg.padded_vocab)
        assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    want = make_caches(cfg, 1, CACHE_LEN)
    assert [tuple(t.shape) for t in _leaves(want)] == [
        tuple(t.shape) for t in _leaves({k: v for k, v in caches.items()
                                         if k != "enc_out"})]


# ---------------------------------------------------------------- serving

@pytest.fixture
def jit_engine(monkeypatch):
    monkeypatch.setattr(jbatching, "prefill", JIT_PREFILL)
    monkeypatch.setattr(jbatching, "decode_step", JIT_DECODE)


@pytest.mark.parametrize("case,paged", [
    ("hymba", False), ("mixtral", True), ("kimi", False), ("xlstm", False),
    ("internvl", True), ("qwen3-window", False)])
def test_engine_matches_jax(case, paged, jit_engine):
    """Four requests on two slots through both engines: equal tokens (the
    unpaged ones decode past the 8-slot rings, up to position 12) and,
    paged within the ring (up to position 7), equal block-table
    counters."""
    params, jcfg, model, cfg = _pair(case)
    rng = np.random.default_rng(4)
    prompt, extra = (4, 1) if paged else (5, 2)
    reqs = [(rid, rng.integers(0, cfg.vocab_size, prompt).tolist(),
             2 + extra * rid) for rid in range(4)]
    jcache = JPagedCache(jcfg, n_pages=32, page_tokens=4) if paged else None
    cache = SimPagedKVCache(cfg, n_pages=32, page_tokens=4,
                            device="cpu") if paged else None
    jeng = JServeEngine(params, jcfg, max_slots=2, cache_len=CACHE_LEN,
                        paged_cache=jcache)
    eng = ServeEngine(model, max_slots=2, cache_len=CACHE_LEN,
                      paged_cache=cache)
    for rid, prompt, n in reqs:
        jeng.submit(JRequest(req_id=rid, prompt=prompt, max_new_tokens=n))
        eng.submit(Request(req_id=rid, prompt=prompt, max_new_tokens=n))
    want = {c.req_id: c.tokens for c in jeng.run()}
    got = {c.req_id: c.tokens for c in eng.run()}
    assert got == want and eng.steps == jeng.steps
    if paged:
        assert dataclasses.asdict(cache.stats) == dataclasses.asdict(
            jcache.stats)
        assert cache.stats.pages_freed == cache.stats.pages_allocated > 0


@pytest.mark.parametrize("arch", sorted(set(configs.ARCHS)
                                        - {"whisper-medium"}))
def test_launch_serve_matches_the_jax_launcher(arch, jit_engine):
    """Both launchers, reduced, serve every arch but whisper: the same
    requests from the same seed, equal token counts (each package's own
    random weights)."""
    _, jeng, _ = jax_serve(arch, n_requests=3, verbose=False)
    comps, eng, _ = serve(arch, n_requests=3, verbose=False, device="cpu")
    assert [len(c.tokens) for c in comps] == [len(c.tokens)
                                              for c in jeng.completed]
    assert eng.prefills == 3


def test_jax_paged_mirror_pages_wrong_kv_past_the_ring_the_port_refuses(
        jit_engine):
    """One request, prompt of 6 on reduced hymba (an 8-slot ring): decode
    position 8 lives in ring slot 0, but the engine mirrors slot 8, which
    JAX clamps to slot 7 and so pages position 7's k/v as position 8's.
    The port raises at that mirror, its block-table counters equal to
    JAX's just before it."""
    params, jcfg, model, cfg = _pair("hymba")
    prompt = np.random.default_rng(6).integers(0, 256, 6).tolist()
    jcache = JPagedCache(jcfg, n_pages=32, page_tokens=4)
    jeng = JServeEngine(params, jcfg, max_slots=1, cache_len=CACHE_LEN,
                        paged_cache=jcache)
    jeng.submit(JRequest(req_id=0, prompt=prompt, max_new_tokens=6))
    while jeng.slots.get(0) is None or jeng.slots[0].position < RING:
        jeng.step()
    before = dataclasses.asdict(jcache.stats)
    jeng.step()                               # decodes and mirrors pos 8
    k = np.asarray(jcache.gather_sequence(0, RING + 1)[0])
    np.testing.assert_array_equal(k[:, RING], k[:, RING - 1])
    ring_k = np.asarray(jeng.slots[0].caches["kv"][0])[:, 0]
    assert not np.array_equal(ring_k[:, 0], ring_k[:, RING - 1])

    cache = SimPagedKVCache(cfg, n_pages=32, page_tokens=4, device="cpu")
    eng = ServeEngine(model, max_slots=1, cache_len=CACHE_LEN,
                      paged_cache=cache)
    eng.submit(Request(req_id=0, prompt=prompt, max_new_tokens=6))
    with pytest.raises(IndexError, match="does not hold position 8"):
        eng.run()
    assert dataclasses.asdict(cache.stats) == before

    # A prompt longer than the ring: slot 0 holds position 8 after the
    # roll, and JAX pages it as position 0; the port refuses at position 0.
    long_prompt = np.random.default_rng(7).integers(0, 256, 10).tolist()
    cache = SimPagedKVCache(cfg, n_pages=32, page_tokens=4, device="cpu")
    eng = ServeEngine(model, max_slots=1, cache_len=CACHE_LEN,
                      paged_cache=cache)
    eng.submit(Request(req_id=1, prompt=long_prompt, max_new_tokens=2))
    with pytest.raises(IndexError, match="does not hold position 0"):
        eng.run()
    assert cache.stats.searches == 0


def test_paged_ssm_is_refused():
    cfg = configs.reduced_config(configs.get_config("xlstm-350m"))
    model = init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="no k/v to page"):
        ServeEngine(model, paged_cache=SimPagedKVCache(
            cfg, n_pages=8, device="cpu"))


def test_neither_engine_serves_audio(jit_engine):
    """The engines pass no frontend embeddings, which whisper's encoder
    needs: JAX fails inside prefill, the port refuses the config."""
    with pytest.raises((AttributeError, TypeError)):
        jax_serve("whisper-medium", n_requests=1, verbose=False)
    with pytest.raises(ValueError, match="frontend embeddings"):
        serve("whisper-medium", n_requests=1, verbose=False, device="cpu")


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_params_cross_both_ways_for_every_config(arch):
    """bfloat16 parameters of every config (float32 routers and recurrent
    gates among them) cross from the JAX tree and back bit for bit, in the
    JAX tree's structure; a leaf of the wrong dtype, an unknown leaf and a
    missing one are refused."""
    jcfg = jreduced(JARCHS[arch])
    cfg = configs.reduced_config(configs.ARCHS[arch])
    tree = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg)[0])
    back = params_to_numpy(params_from_numpy(tree, cfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["embed"] = tree["embed"].astype(np.float32)
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(wrong, cfg, device="cpu")
    with pytest.raises(KeyError, match="no such parameter"):
        params_from_numpy(dict(tree, extra=tree["embed"]), cfg, device="cpu")
    with pytest.raises(KeyError, match="no value"):
        params_from_numpy({k: v for k, v in tree.items() if k != "blocks"},
                          cfg, device="cpu")
