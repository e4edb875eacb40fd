"""The port's training path against the JAX package's.

Both packages run the same weights on the CPU in float32 at
``reduced_config`` size: the JAX ``init_model`` parameters cross to the
port through ``repro_torch.convert.params_from_numpy``.  The data stream
is bit-identical.  Tolerances, float32 (the sums run in other orders):
logits within 1e-5, the loss within 1e-5 and each gradient leaf within
1e-5 of its largest entry; one AdamW update on the same gradients:
parameters within 1e-6, moments within 1e-5 of each leaf's largest entry
(the global norm sums in another order, and ``b ** step`` is float32
``pow`` in both, whose last bit XLA and PyTorch round differently); three
train steps within 1e-5.  Checkpoints
cross between the packages bit for bit, and a crashed-and-resumed run
equals the uninterrupted one bitwise.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.models.model import init_model as jinit
from repro.models.model import train_logits as jtrain_logits
from repro.train import checkpoint as jckpt
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import batch_at_step as jbatch_at_step
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro.train.train_step import lm_loss as jlm_loss
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs, train_lm
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 param_tree, params_from_numpy,
                                 params_to_numpy, tree_items)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch.train import train
from repro_torch.models.layers import (attend, causal_mask_bias,
                                       plain_attention)
from repro_torch.models.model import init_model, train_logits
from repro_torch.train.checkpoint import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import DataConfig, batch_at_step
from repro_torch.train.ft import FailureInjector, StragglerWatchdog
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_train_step, value_and_grad

ARCHS = ("olmo-1b", "qwen3-4b", "granite-3-8b")
REMATS = ("none", "block", "full")
JIT_LOGITS = jax.jit(jtrain_logits, static_argnums=(1,))
JIT_GRAD = jax.jit(jax.value_and_grad(jlm_loss, has_aux=True),
                   static_argnums=(1,))


def _configs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jreduced(JARCHS[arch]), **kw),
            dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                                **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX params, JAX cfg, port model, port cfg, data config)."""
    jcfg, cfg = _configs(request.param)
    params, _ = jinit(jax.random.PRNGKey(3), jcfg)
    model = params_from_numpy(_np(params), cfg, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      seed=2)
    return params, jcfg, model, cfg, data


def _jbatch(data, step):
    return jbatch_at_step(JDataConfig(**dataclasses.asdict(data)), step)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("step", [0, 7, 1000])
@pytest.mark.parametrize("shape", [(97, 16, 4, 3), (256, 32, 8, 0),
                                   (50304, 64, 2, 9)])
def test_batch_at_step_bit_equal(shape, step):
    v, s, b, seed = shape
    data = DataConfig(vocab_size=v, seq_len=s, global_batch=b, seed=seed)
    got = batch_at_step(data, step, device="cpu")
    want = _jbatch(data, step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (got["labels"][:, -1] == -1).all()


@pytest.mark.parametrize("remat", REMATS)
def test_train_logits_match_jax(pair, remat):
    params, jcfg, model, cfg, data = pair
    tokens = batch_at_step(data, 0, device="cpu")["tokens"]
    want, jaux = JIT_LOGITS(params, jcfg, _jbatch(data, 0)["tokens"])
    with torch.no_grad():
        got, aux = train_logits(model, tokens, remat=remat)
    assert got.dtype == torch.float32
    assert got.shape == (4, 16, cfg.padded_vocab)
    v = cfg.vocab_size
    np.testing.assert_allclose(got[..., :v].numpy(), np.asarray(want)[..., :v],
                               atol=1e-5, rtol=0)
    assert (got[..., v:] == -1e30).all()
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_gradients_match_jax_value_and_grad(pair, remat):
    """Every leaf of the gradient, with each remat policy, against
    ``jax.value_and_grad(lm_loss)``."""
    params, jcfg, model, cfg, data = pair
    b = batch_at_step(data, 1, device="cpu")
    jb = _jbatch(data, 1)
    (_, (jloss, _)), jgrads = JIT_GRAD(params, jcfg, jb["tokens"],
                                       jb["labels"])
    (loss, aux), grads = value_and_grad(model, b["tokens"], b["labels"],
                                        remat=remat)
    assert abs(float(loss) - float(jloss)) < 1e-5 and float(aux) == 0.0
    names = {".".join(p) for p, _ in tree_items(_np(jgrads))}
    assert names == set(grads)
    for path, want in tree_items(_np(jgrads)):
        got = grads[".".join(path)]
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < 1e-5, path


def test_remat_policies_give_the_same_gradients(pair):
    _, _, model, _, data = pair
    b = batch_at_step(data, 2, device="cpu")
    runs = [value_and_grad(model, b["tokens"], b["labels"], remat=r)
            for r in REMATS]
    for (loss, _), grads in runs[1:]:
        assert float(loss) == float(runs[0][0][0])
        for name, g in grads.items():
            assert torch.equal(g, runs[0][1][name]), name


def test_attend_is_the_jax_attend_and_the_kernel_plain_version():
    """``attend`` against JAX's ``_attend`` (GQA, causal and windowed
    masks, bf16 probabilities) and, in float32, against ``attention_ref``."""
    from repro.models.layers import _attend as jattend
    from repro.models.layers import causal_mask_bias as jbias
    rng = np.random.default_rng(0)
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 2e-6),
                            (torch.bfloat16, jnp.bfloat16, 1e-2)):
        for (sq, sk, h, hkv, window, off) in ((8, 8, 4, 2, None, 0),
                                              (5, 12, 6, 3, 4, 7),
                                              (1, 9, 2, 2, None, 8)):
            q, k, v = (rng.normal(size=(2, s, n, 16)).astype(np.float32)
                       for s, n in ((sq, h), (sk, hkv), (sk, hkv)))
            bias = causal_mask_bias(sq, sk, window, off)
            np.testing.assert_array_equal(
                bias.numpy(), np.asarray(jbias(sq, sk, window, off)))
            t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
            got = attend(*t, bias).float().numpy()
            want = np.asarray(jattend(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                      jnp.asarray(bias.numpy()), None),
                              np.float32)
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
            if dtype == torch.float32:
                ref = attention_ref(*t, causal=True, window=window,
                                    q_offset=off).numpy()
                np.testing.assert_allclose(
                    plain_attention(*t, window=window, q_offset=off).numpy(),
                    ref, atol=2e-6)


def test_kernel_function_gradient_is_the_attend_vjp(monkeypatch):
    """The autograd Function around the kernel, its launch stood in for by
    the plain version (no ``grad_fn``, as the kernel's output): the
    output needs a gradient and has a ``grad_fn``; q, k, v gradients equal
    the VJP of ``plain_attention`` bitwise; in a remat-``block`` model the
    kernel runs once a layer forward and once a layer in the recompute."""
    launches = []

    def stand_in(q, k, v, causal, window, scale, q_offset):
        launches.append(q.shape)
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset).detach()

    monkeypatch.setattr(flash_ops, "_launch", stand_in)

    def kernel(q, k, v, *, causal=True, window=None, q_offset=None,
               scale=None):
        return flash_ops._FlashAttention.apply(q, k, v, causal, window,
                                               scale, q_offset)

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 6, n, 16)).astype(
        np.float32)).requires_grad_() for n in (4, 2, 2))
    g = torch.from_numpy(rng.normal(size=(2, 6, 4, 16)).astype(np.float32))
    out = kernel(q, k, v, causal=True, window=3, q_offset=0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(plain_attention(q, k, v, window=3, q_offset=0),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    _, cfg = _configs("qwen3-4b")
    model = init_model(cfg, seed=0, device="cpu")
    b = batch_at_step(DataConfig(cfg.vocab_size, 16, 4, 0), 0, device="cpu")
    launches.clear()
    (loss, _), grads = value_and_grad(model, b["tokens"], b["labels"],
                                      remat="block", attention=kernel)
    assert len(launches) == 2 * cfg.n_layers
    (ploss, _), pgrads = value_and_grad(model, b["tokens"], b["labels"],
                                        remat="block",
                                        attention=plain_attention)
    assert abs(float(loss) - float(ploss)) < 1e-6
    for name, t in grads.items():
        assert _rel(t.numpy(), pgrads[name].numpy()) < 1e-5, name
    for name in ("wq", "wk", "wv"):         # every layer's slice non-zero
        assert (grads[f"blocks.attn.{name}"].abs().sum(dim=(1, 2, 3))
                > 0).all()


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(pair, moment_dtype):
    """One update from a state three steps in, on the JAX gradients."""
    params, jcfg, _, cfg, data = pair
    jopt_cfg = JAdamWConfig(lr=1e-2, warmup_steps=5,
                            moment_dtype=moment_dtype, grad_clip=0.5)
    opt_cfg = AdamWConfig(**dataclasses.asdict(jopt_cfg))
    jb = _jbatch(data, 0)
    _, jgrads = JIT_GRAD(params, jcfg, jb["tokens"], jb["labels"])
    rng = np.random.default_rng(4)
    jstate = jinit_opt_state(params, jopt_cfg)
    jstate = {"m": jax.tree.map(lambda x: jnp.asarray(
                  rng.normal(size=x.shape) * 1e-3, x.dtype), jstate["m"]),
              "v": jax.tree.map(lambda x: jnp.asarray(
                  rng.random(size=x.shape) * 1e-6, x.dtype), jstate["v"]),
              "step": jnp.int32(3)}
    model = params_from_numpy(_np(params), cfg, device="cpu")
    state = opt_state_from_numpy(_np(jstate), device="cpu")
    grads = {n: torch.from_numpy(np.asarray(g).copy())
             for n, g in ((".".join(p), g) for p, g in tree_items(_np(jgrads)))}
    from repro_torch.convert import nest
    jp, jst, jm = jadamw_update(jgrads, jstate, params, jopt_cfg)
    _, st, m = adamw_update(nest(grads), state, param_tree(model), opt_cfg)
    assert int(st["step"]) == 4 and st["step"].dtype == torch.int32
    assert float(m["lr"]) == float(jm["lr"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        < 1e-6 * float(jm["grad_norm"])
    for path, want in tree_items(_np(jp)):
        got = params_to_numpy(model)
        for key in path:
            got = got[key]
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for k in ("m", "v"):
        for path, want in tree_items(_np(jst[k])):
            got = opt_state_to_numpy(st)[k]
            for key in path:
                got = got[key]
            # a moment is a difference of two terms, so each leaf is held
            # relative to its largest entry; bf16 moments may round one ulp
            # (2^-8) apart
            assert _rel(np.asarray(got, np.float32),
                        np.asarray(want, np.float32)) < (
                1e-5 if moment_dtype == "float32" else 1e-2), (k, path)


def test_three_train_steps_match_jax(pair):
    params, jcfg, _, cfg, data = pair
    jopt_cfg = JAdamWConfig(lr=1e-3, warmup_steps=2)
    opt_cfg = AdamWConfig(**dataclasses.asdict(jopt_cfg))
    model = params_from_numpy(_np(params), cfg, device="cpu")
    state = init_opt_state(param_tree(model), opt_cfg)
    jstate = jinit_opt_state(params, jopt_cfg)
    jstep = jax.jit(jmake_train_step(jcfg, jopt_cfg))
    step = make_train_step(cfg, opt_cfg)
    for s in range(3):
        params, jstate, jm = jstep(params, jstate, _jbatch(data, s))
        model, state, m = step(model, state,
                               batch_at_step(data, s, device="cpu"))
        assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
            < 1e-5 * float(jm["grad_norm"])
    for path, want in tree_items(_np(params)):
        got = params_to_numpy(model)
        for key in path:
            got = got[key]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_microbatch_accumulation_matches_full_batch():
    """The JAX test's configuration and bounds, in the port."""
    _, cfg = _configs("olmo-1b", remat="none")
    opt_cfg = AdamWConfig(lr=1e-3)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
                      seed=0)
    batch = batch_at_step(data, 0, device="cpu")
    out = []
    for mb in (1, 4):
        model = init_model(cfg, seed=1, device="cpu")
        state = init_opt_state(param_tree(model), opt_cfg)
        model, _, m = make_train_step(cfg, opt_cfg, microbatches=mb)(
            model, state, batch)
        out.append((float(m["loss"]), params_to_numpy(model)))
    assert abs(out[0][0] - out[1][0]) < 1e-5
    for (path, a), (_, b) in zip(tree_items(out[0][1]), tree_items(out[1][1])):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_the_packages_bit_for_bit(tmp_path, dtype):
    """A checkpoint saved by the JAX package loads in the port and the
    reverse, every leaf bit for bit; bf16 parameters and moments cross
    through the float32 widening."""
    jcfg, cfg = _configs("qwen3-4b", dtype=dtype)
    jopt_cfg = JAdamWConfig(moment_dtype=dtype)
    params, _ = jinit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    jopt = jinit_opt_state(params, jopt_cfg)
    jopt = {"m": jax.tree.map(lambda x: jnp.asarray(
                rng.normal(size=x.shape), x.dtype), jopt["m"]),
            "v": jopt["v"], "step": jnp.int32(7)}
    jckpt.save_checkpoint(tmp_path / "step_7", 7, params, jopt,
                          config_name="t")
    model = init_model(cfg, seed=9, device="cpu")
    state = init_opt_state(param_tree(model),
                           AdamWConfig(moment_dtype=dtype))
    step, _, state = load_checkpoint(latest_step(tmp_path), param_tree(model),
                                     state)
    assert step == 7 and int(state["step"]) == 7
    _assert_trees_equal(params_to_numpy(model), _np(params))
    _assert_trees_equal(opt_state_to_numpy(state), _np(jopt))

    save_checkpoint(tmp_path / "port" / "step_7", 7, param_tree(model), state,
                    config_name="t")
    jparams, _ = jinit(jax.random.PRNGKey(1), jcfg)
    jfresh = jinit_opt_state(jparams, jopt_cfg)
    step, p2, o2 = jckpt.load_checkpoint(
        jckpt.latest_step(tmp_path / "port"), jparams, jfresh)
    assert step == 7
    _assert_trees_equal(_np(p2), _np(params))
    _assert_trees_equal(_np(o2), _np(jopt))


def _assert_trees_equal(got, want):
    got, want = list(tree_items(got)), list(tree_items(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8),
                                      err_msg=str(path))


def test_opt_state_crosses_from_jax_init_opt_state_and_back():
    jcfg, cfg = _configs("granite-3-8b", dtype="bfloat16")
    params, _ = jinit(jax.random.PRNGKey(0), jcfg)
    jopt = _np(jinit_opt_state(params, JAdamWConfig(moment_dtype="bfloat16")))
    state = opt_state_from_numpy(jopt, device="cpu")
    _assert_trees_equal(opt_state_to_numpy(state), jopt)
    model = params_from_numpy(_np(params), cfg, device="cpu")
    mine = opt_state_to_numpy(init_opt_state(
        param_tree(model), AdamWConfig(moment_dtype="bfloat16")))
    _assert_trees_equal(mine, jopt)


def test_training_reduces_loss_end_to_end():
    """The JAX test's run and bound, in the port on the CPU."""
    run = train("olmo-1b", steps=30, batch=8, seq_len=32, lr=3e-3,
                verbose=False, device="cpu")
    assert run.steps_run == 30 and len(run.step_s) == 30
    assert np.mean(run.losses[-5:]) < np.mean(run.losses[:5]) - 0.3


def test_crash_restart_bitwise_resume(tmp_path):
    """Uninterrupted run == crash-at-step-12 + restart run, bitwise."""
    kw = dict(steps=20, batch=4, seq_len=16, lr=1e-3, verbose=False,
              ckpt_every=10, device="cpu")
    full = train("olmo-1b", ckpt_root=tmp_path / "a", **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        train("olmo-1b", ckpt_root=tmp_path / "b", crash_at=12, **kw)
    resumed = train("olmo-1b", ckpt_root=tmp_path / "b", **kw)
    assert resumed.resumed_from == 10 and resumed.steps_run == 10
    np.testing.assert_array_equal(np.asarray(full.losses[10:]),
                                  np.asarray(resumed.losses))


def test_train_lm_module_runs_on_the_cpu(capsys, tmp_path):
    train_lm.main(["--steps", "3", "--batch", "2", "--seq-len", "8",
                   "--device", "cpu", "--ckpt", str(tmp_path)])
    assert "over 3 steps" in capsys.readouterr().out


def test_straggler_watchdog_flags_slow_step():
    w = StragglerWatchdog(threshold=3.0, warmup_steps=3)
    for s in range(6):
        w.start_step(s)
        time.sleep(0.005)
        assert w.end_step() is None
    w.start_step(6)
    time.sleep(0.06)
    ev = w.end_step()
    assert ev is not None and ev.slowdown > 3 and ev.step == 6
    assert len(w.durations) == 7


def test_failure_injector_fires_once():
    inj = FailureInjector(crash_at_step=3)
    inj.maybe_crash(2)
    with pytest.raises(RuntimeError):
        inj.maybe_crash(3)
    inj.maybe_crash(3)          # second pass: already fired
