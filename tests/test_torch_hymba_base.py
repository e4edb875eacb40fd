"""hymba-1.5b-base, Hymba at its published structure, through the port's
serving engine against the plain reference (``simbench/reference/lm.py``,
the benchmark's own), at a CPU size that keeps every kind of layer: global
layers 0 and 4, window layers 1-2 sharing one cache and 3 alone, 8 meta
tokens, a window of 8.  Prefill, then decode past the window, paged and
un-paged; the paged pool against the dense global caches; the spans; the
refusals of the sharded step and the dry run."""
import dataclasses

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import hymba
from repro_torch.models.config import HymbaConfig
from repro_torch.models.model import LM, decode_step, prefill
from repro_torch.serve.batching import Request, ServeEngine
from repro_torch.serve.kvcache import TABLE_SPAN, SimPagedKVCache
from simbench.reference import lm as reference
from simbench.systems.lm import load_weights
from simbench.yardstick.kinds.serve import draw_weights

ARCH = "hymba-1.5b-base"
CACHE_LEN = 64
# (prompt length, new tokens): one prompt past the window, one that
# crosses it while decoding.
REQUESTS = ((19, 12), (5, 14))


def _config_dict(cfg: HymbaConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["global_layers"] = list(cfg.global_layers)
    d["kv_groups"] = [list(g) for g in cfg.kv_groups]
    return d


def _model(dtype: str = "float32", seed: int = 3):
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype)
    weights = draw_weights(_config_dict(cfg), seed, torch.device("cpu"))
    model = LM(cfg, "cpu")
    load_weights(model, weights)
    return cfg, model, weights


def _serve(model, paged: bool, requests=REQUESTS, seed: int = 5,
           steps: int | None = None):
    """Serve ``requests`` through the engine (only ``steps`` engine steps
    when given); the prompts and each token's (token, logits) by
    request."""
    gen = torch.Generator().manual_seed(seed)
    cfg = model.cfg
    cache = SimPagedKVCache(cfg, n_pages=64, page_tokens=4,
                            device="cpu") if paged else None
    seen: dict = {}
    eng = ServeEngine(model, max_slots=2, cache_len=CACHE_LEN,
                      paged_cache=cache,
                      on_token=lambda r, t, lg: seen.setdefault(r, []).append(
                          (t, lg[0, :cfg.vocab_size].clone())))
    prompts = {}
    for rid, (s, n) in enumerate(requests):
        prompts[rid] = torch.randint(0, cfg.vocab_size, (s,),
                                     generator=gen).tolist()
        eng.submit(Request(req_id=rid, prompt=prompts[rid],
                           max_new_tokens=n))
    if steps is None:
        eng.run()
    for _ in range(steps or 0):
        eng.step()
    return prompts, seen, eng, cache


def _rels(cfg, weights, prompts, seen, **kw):
    """Each served step's logits against the reference's, relative L2."""
    out = []
    for rid, steps in seen.items():
        served = [t for t, _ in steps]
        ref = reference.forward(_config_dict(cfg), weights,
                                prompts[rid] + served[:-1], len(served),
                                **kw)
        got = torch.stack([lg for _, lg in steps])
        out += ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_matches_the_reference_past_the_window(paged):
    cfg, model, weights = _model()
    prompts, seen, eng, _ = _serve(model, paged)
    assert [len(seen[r]) for r in sorted(seen)] == [n for _, n in REQUESTS]
    assert all(len(prompts[r]) + len(seen[r]) > cfg.sliding_window
               for r in seen)
    assert max(_rels(cfg, weights, prompts, seen)) < 1e-4
    assert eng.prefill_tokens == sum(s for s, _ in REQUESTS)
    assert eng.mirrored == (sum(s + n - 1 for s, n in REQUESTS)
                            if paged else 0)


def _check(cfg, weights, prompts, seen, eng, cache, alter=None):
    """The benchmark's check of what the engine served, its paged pool
    read back for the sequences still in a slot (``alter`` applied to the
    first one's (k, v))."""
    rids = sorted(seen)
    executed = {"sequences": [{"prompt": prompts[r],
                               "served": [t for t, _ in seen[r]],
                               "window_from": 0} for r in rids]}
    kv = [cache.gather_sequence(r, eng.slots[r].position)
          if r in eng.slots else None for r in rids]
    if alter is not None:
        alter(*kv[0])
    got = {"logits": [torch.stack([lg for _, lg in seen[r]]) for r in rids],
           "kv": kv, "pages_free": cache.free_pages}
    inputs = type("Inputs", (), {"weights": weights})
    config = dict(_config_dict(cfg), kv_pages=cache.n_pages,
                  page_tokens=cache.page_tokens)
    return reference.check(config, inputs, executed, got)


def test_bf16_engine_passes_the_benchmark_check():
    """Both sequences past the window and still in their slots, so that
    the check reads their global k/v back from the paged pool."""
    cfg, model, weights = _model("bfloat16")
    served = [n - 2 for _, n in REQUESTS]
    prompts, seen, eng, cache = _serve(model, True, steps=min(served))
    assert sorted(eng.slots) == [0, 1]
    numbers, failed, compared = _check(cfg, weights, prompts, seen, eng,
                                       cache)
    assert all(v <= lim for v, lim in numbers.values()), (numbers, compared)
    assert failed == 0 and compared["steps"] == 2 * (min(served) + 1)
    assert compared["kv_positions"] == sum(
        s + min(served) for s, _ in REQUESTS)


def _zero_a_position(k, v):
    k[:, 6] = 0
    v[:, 6] = 0


def _swap_two_pages(k, v):
    """The second and third pages of the last global cache trade places."""
    for c in (k, v):
        c[-1, 4:12] = c[-1, 4:12].roll(4, 0).clone()


@pytest.mark.parametrize("fault, number", [
    (_zero_a_position, "kv_positions_off"),
    (_swap_two_pages, "kv_pages_off"),
    ("unfreed", "kv_pages_unaccounted")])
def test_a_paged_pool_fault_fails_the_check(fault, number):
    """A position left unwritten, pages of a deep global cache swapped,
    and a retired sequence's page kept from the free list each fail on
    their own number."""
    cfg, model, weights = _model()
    served = [n - 2 for _, n in REQUESTS]
    prompts, seen, eng, cache = _serve(model, True, steps=min(served))
    if fault == "unfreed":
        cache.allocate(9, 0)       # a page no sequence in a slot holds
        fault = None
    numbers, failed, _ = _check(cfg, weights, prompts, seen, eng, cache,
                                fault)
    assert [k for k, (v, lim) in numbers.items() if v > lim] == [number]
    # the altered sequence's tokens; a page off the books is no one's
    assert failed == (0 if fault is None else min(served) + 1)


def test_global_layers_on_the_ring_fail_past_the_window(monkeypatch):
    """The paper-table layout (every layer on a ring of the window's slots,
    so a global layer's decode sees only the window) departs from the
    reference once a sequence passes the ring, and the benchmark's check
    refuses it."""
    cfg, model, weights = _model()
    monkeypatch.setattr(hymba, "RING_KINDS", ("window", "global"))
    prompts, seen, _, _ = _serve(model, False)
    rels = _rels(cfg, weights, prompts, seen)
    assert max(rels) > 1e-2
    assert sorted(rels)[len(rels) // 2] > 1e-4


def test_dropping_the_meta_tokens_fails():
    cfg, model, weights = _model()
    prompts, seen, _, _ = _serve(model, False)
    weights = dict(weights, meta=torch.zeros_like(weights["meta"]))
    assert min(_rels(cfg, weights, prompts, seen)) > 1e-2


def test_meta_state_is_computed_once_and_is_every_cache_s_prefix():
    cfg, model, _ = _model()
    meta = hymba.meta_state(model)
    tokens = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]])
    logits, caches = prefill(model, tokens, CACHE_LEN)
    again, caches2 = hymba.prefill(model, tokens, CACHE_LEN, meta=meta)
    assert torch.equal(logits, again)
    m = cfg.meta_tokens
    for kind in hymba.KINDS:
        for t, mt in zip(caches2[kind], meta.kv[kind]):
            assert torch.equal(t[:, 0, :m], mt)
    assert caches["global"][0].shape[0] == len(cfg.global_layers) == 2
    assert caches["window"][0].shape[:3] == (2, 1, m + cfg.sliding_window)
    assert caches["mamba"][0].shape == (cfg.n_layers, 1, cfg.mamba_width,
                                        cfg.ssm_state)
    # the group's second layer projects nothing of its own
    assert [r.writes for r in hymba.cache_layout(cfg)] == [
        True, True, False, True, True]


def test_decode_past_the_global_cache_raises():
    cfg, model, _ = _model()
    _, caches = prefill(model, torch.tensor([[1, 2, 3]]), 4)
    decode_step(model, torch.tensor([[4]]), caches, 3)
    with pytest.raises(IndexError, match="past a global cache of 4"):
        decode_step(model, torch.tensor([[5]]), caches, 4)


def test_paged_pool_holds_the_global_caches_after_the_rings_wrap():
    """Stepping by hand: after every step, each live sequence's paged k/v
    (one page row a global cache) equals its dense global caches position
    by position, well past the 8-slot rings, with no IndexError."""
    cfg, model, _ = _model()
    cache = SimPagedKVCache(cfg, n_pages=64, page_tokens=4, device="cpu")
    assert cache.pool_k.shape[0] == len(cfg.global_layers)
    eng = ServeEngine(model, max_slots=2, cache_len=CACHE_LEN,
                      paged_cache=cache)
    eng.submit(Request(0, list(range(11)), 20))
    eng.submit(Request(1, list(range(3)), 20))
    m = cfg.meta_tokens
    for _ in range(15):
        eng.step()
        for rid, slot in eng.slots.items():
            n = slot.position
            k, v = cache.gather_sequence(rid, n)
            ck, cv = slot.caches["global"]
            assert torch.equal(k, ck[:, 0, m:m + n])
            assert torch.equal(v, cv[:, 0, m:m + n])
    assert eng.slots[0].position > 2 * cfg.sliding_window
    eng.run()
    assert cache.stats.pages_freed == cache.stats.pages_allocated


def test_a_long_sequence_spans_table_pages_and_frees_them_all():
    cfg = reduced_config(get_config("olmo-1b"))
    cache = SimPagedKVCache(cfg, n_pages=400, page_tokens=1, device="cpu")
    kv = torch.zeros(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    n = 2 * TABLE_SPAN + 20
    for pos in range(n):
        cache.write_token(9, pos, kv + pos, kv - pos)
    assert sorted(cache._pages_of[9]) == [1, 2, 3]
    k, _ = cache.gather_sequence(9, n)
    assert torch.equal(k[0, :, 0, 0], torch.arange(n, dtype=k.dtype))
    searches = cache.stats.searches
    assert cache.free_sequence(9) == n
    assert cache.stats.searches == searches + 3
    assert len(cache._free) == 400


def test_writing_a_run_of_tokens_is_writing_each_with_a_lookup_a_page():
    cfg = reduced_config(get_config("olmo-1b"))
    one, run = (SimPagedKVCache(cfg, n_pages=16, page_tokens=16,
                                device="cpu") for _ in range(2))
    k = torch.randn(cfg.n_layers, 40, cfg.n_kv_heads, cfg.head_dim)
    for pos in range(40):
        one.write_token(3, 5 + pos, k[:, pos], -k[:, pos])
    run.write_tokens(3, 5, k, -k)
    assert torch.equal(one.gather_sequence(3, 45)[0],
                       run.gather_sequence(3, 45)[0])
    assert run.stats.pages_allocated == one.stats.pages_allocated == 3
    # a lookup a page, then the gather's three; token by token, 40 and 3
    assert run.stats.searches == 3 + 3 < one.stats.searches == 40 + 3


def test_spans_name_the_serve_and_model_sites_only_when_on():
    cfg, model, _ = _model()
    spans.reset()
    try:
        _serve(model, True, requests=((6, 3),))
        assert spans.totals() == {}
        spans.enable()
        _serve(model, True, requests=((6, 3),))
        names = set(spans.totals())
    finally:
        spans.disable()
        spans.reset()
    assert {"serve.admit", "serve.decode", "serve.mirror",
            "model.attn.global", "model.attn.window",
            "model.mamba"} <= names


def test_sharded_paths_and_the_dry_run_refuse_it():
    from repro_torch.launch import dryrun
    from repro_torch.serve import serve_step
    cfg, model, _ = _model()
    with pytest.raises(ValueError, match="served on one device only"):
        dryrun.run_cell(ARCH, "decode_32k", "single")
    with pytest.raises(NotImplementedError, match="no sharded caches"):
        serve_step.sharded_caches(model, None, 2, 16)
    with pytest.raises(NotImplementedError, match="one device"):
        prefill(model, torch.tensor([[1, 2]]), 8, tp=object())
    with pytest.raises(NotImplementedError, match="served only"):
        from repro_torch.models.model import train_logits
        train_logits(model, torch.tensor([[1, 2]]))


def test_the_paper_table_hymba_keeps_its_config_and_ring():
    """hymba-1.5b stays the JAX package's config (global layer every 11, no
    meta tokens, no sharing) and its engine keeps the ring mirror's
    refusal (hazard 22, tests/test_torch_families.py)."""
    old = get_config("hymba-1.5b")
    assert not isinstance(old, HymbaConfig) and old.global_attn_every == 11
    new = get_config(ARCH)
    assert (new.global_layers, new.meta_tokens, new.mamba_width) == (
        (0, 15, 31), 128, 3200)
    assert sum(len(g) for g in new.kv_groups) == 29
    cfg = reduced_config(old)
    model = LM(cfg, "cpu")
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    eng = ServeEngine(model, max_slots=1, cache_len=64, paged_cache=(
        SimPagedKVCache(cfg, n_pages=32, page_tokens=4, device="cpu")))
    eng.submit(Request(0, list(range(10)), 2))
    with pytest.raises(IndexError, match="does not hold position 0"):
        eng.run()


def test_the_serving_scan_equals_the_loop_that_autograd_keeps():
    """The mamba scan's two sides on the CPU: without autograd (serving)
    the ``mamba_scan`` op (ref.py's recurrence, the final state written in
    place), under it ``_mamba_scan``'s loop.  Both give the same output
    and final state bit for bit, over several hundred positions from a
    nonzero state, in float32 and in bf16."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.mamba_scan.ref import gate, scan_inputs
    from repro_torch.models import ssm
    gen = torch.Generator().manual_seed(0)
    b, s, e, n = 2, 301, 24, 16

    def randn(*shape):
        return torch.randn(shape, generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        xz, u = randn(b, s, 2 * e).to(dtype), randn(b, s, e).to(dtype)
        proj, a_log = randn(b, s, 2 * n + 1).to(dtype), randn(e, n) * 0.5
        d_skip, h0 = randn(e), randn(b, e, n)
        bmat, cmat, delta, a = scan_inputs(proj.float(), a_log)
        with torch.enable_grad():
            y_loop, h_loop = ssm._mamba_scan(u.float(), delta, a, bmat, cmat,
                                             d_skip, h0)
        y_loop = gate(y_loop, xz[..., e:], dtype)
        h = h0.clone()
        with torch.no_grad():
            y, held = mamba_scan(xz, u, proj, a_log, d_skip, h)
        assert held is h
        assert torch.equal(y, y_loop) and torch.equal(h, h_loop)
