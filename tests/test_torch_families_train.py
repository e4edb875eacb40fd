"""The port's non-dense families against the JAX package's, gradients.

The cases of ``tests/test_torch_families.py`` (hymba, mixtral, kimi-k2,
xlstm, internvl2 with stub patches, whisper with stub frames, and reduced
qwen3 with ``sliding_window=8``) in float32 on the CPU, on the same
weights: the port's ``value_and_grad`` under each remat policy (none,
full, block) against ``jax.value_and_grad`` of the JAX ``lm_loss`` (remat
changes what is stored, not the function), and one ``make_train_step``
step against the jitted JAX step, the VLM and audio batches carrying a
``frontend``.  Tolerances, float32: the loss and ``aux`` within 1e-5, each
gradient leaf within 1e-4 of its largest entry (the forward checks'
bound: the backward runs through the recurrences' loops over the sequence,
summing in other orders than ``jax.lax.scan``'s transpose); after one
AdamW step every parameter within 1e-5 where its gradient stands above
the gradient bound (1e-4 of the leaf's largest); below it Adam's first
step, about lr * g / (|g| + eps), turns the gradients' rounding into a
difference of up to 2 lr, the bound there.  A parameter the loss never
reads (the xLSTM stack's ``norm_1``) has a zero gradient in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import reduced_config as jreduced
from repro.models.model import init_model as jinit
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro.train.train_step import lm_loss as jlm_loss
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.convert import (param_tree, params_from_numpy,
                                 params_to_numpy, tree_items)
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.models.layers import plain_attention
from repro_torch.train.train_step import (make_train_step, unread_parameters,
                                         value_and_grad)

CASES = {
    "hymba": ("hymba-1.5b", {}),
    "mixtral": ("mixtral-8x22b", {}),
    "kimi": ("kimi-k2-1t-a32b", {}),
    "xlstm": ("xlstm-350m", {}),
    "internvl": ("internvl2-26b", {}),
    "whisper": ("whisper-medium", {}),
    "qwen3-window": ("qwen3-4b", dict(sliding_window=8)),
}
REMATS = ("none", "full", "block")
TOL = 1e-5
GRAD_TOL = 1e-4
JIT_GRAD = jax.jit(jax.value_and_grad(jlm_loss, has_aux=True),
                   static_argnums=(1,))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(JAX params, JAX cfg, port model, port cfg, batch as numpy)."""
    arch, over = CASES[request.param]
    kw = dict(over, dtype="float32")
    jcfg = dataclasses.replace(jreduced(JARCHS[arch]), **kw)
    cfg = dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                              **kw)
    params, _ = jinit(jax.random.PRNGKey(3), jcfg)
    model = params_from_numpy(_np(params), cfg, device="cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    batch = {"tokens": tokens, "labels": labels}
    n = {"vision_stub": cfg.frontend_tokens,
         "audio_stub": cfg.encoder_seq}.get(cfg.frontend)
    if n is not None:
        batch["frontend"] = rng.normal(size=(2, n, cfg.d_model)).astype(
            np.float32)
    return params, jcfg, model, cfg, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("remat", REMATS)
def test_loss_aux_and_gradients_match_jax_value_and_grad(pair, remat):
    params, jcfg, model, cfg, batch = pair
    (_, (jloss, jaux)), jgrads = JIT_GRAD(
        params, jcfg, jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["labels"]),
        None if "frontend" not in batch else jnp.asarray(batch["frontend"]))
    b = _torch_batch(batch)
    (loss, aux), grads = value_and_grad(
        model, b["tokens"], b["labels"], frontend_embeds=b.get("frontend"),
        remat=remat)
    assert abs(float(loss) - float(jloss)) < TOL
    assert abs(float(aux) - float(jaux)) < TOL
    assert (float(aux) > 0) == cfg.is_moe
    names = {".".join(p) for p, _ in tree_items(_np(jgrads))}
    assert names == set(grads)
    for path, want in tree_items(_np(jgrads)):
        got = grads[".".join(path)]
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < GRAD_TOL, path


def test_one_train_step_matches_jax(pair):
    params, jcfg, _, cfg, batch = pair
    jopt_cfg = JAdamWConfig(lr=1e-3, warmup_steps=2)
    opt_cfg = AdamWConfig(**dataclasses.asdict(jopt_cfg))
    model = params_from_numpy(_np(params), cfg, device="cpu")
    state = init_opt_state(param_tree(model), opt_cfg)
    jstate = jinit_opt_state(params, jopt_cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = _np(JIT_GRAD(params, jcfg, jbatch["tokens"], jbatch["labels"],
                          jbatch.get("frontend"))[1])
    jparams, _, jm = jax.jit(jmake_train_step(jcfg, jopt_cfg))(
        params, jstate, jbatch)
    model, _, m = make_train_step(cfg, opt_cfg)(model, state,
                                                _torch_batch(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) < TOL
    assert abs(float(m["aux_loss"]) - float(jm["aux_loss"])) < TOL
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        < TOL * float(jm["grad_norm"])
    got = params_to_numpy(model)
    for (path, want), (_, g) in zip(tree_items(_np(jparams)),
                                    tree_items(jgrads)):
        leaf = got
        for key in path:
            leaf = leaf[key]
        diff = np.abs(leaf - want)
        clear = np.abs(g) > GRAD_TOL * np.abs(g).max()
        assert diff[clear].max(initial=0) < TOL, path
        assert diff.max() < 2 * jopt_cfg.lr, path


def test_only_unread_parameters_get_a_zero_gradient(pair):
    """The leaves that get a zero gradient are those JAX's gradient is
    zero for; any other parameter that drops out of the graph raises (here
    the attention's q, k, v detached: wq, wk, wv reach no loss)."""
    params, jcfg, model, cfg, batch = pair
    jgrads = _np(JIT_GRAD(params, jcfg, jnp.asarray(batch["tokens"]),
                          jnp.asarray(batch["labels"]),
                          None if "frontend" not in batch
                          else jnp.asarray(batch["frontend"]))[1])
    zero = {".".join(p) for p, g in tree_items(jgrads) if not g.any()}
    assert zero == unread_parameters(cfg)
    b = _torch_batch(batch)
    _, grads = value_and_grad(model, b["tokens"], b["labels"],
                              frontend_embeds=b.get("frontend"))
    assert {n for n, g in grads.items() if not g.any()} == zero

    def detached(q, k, v, **kw):
        return plain_attention(q.detach(), k.detach(), v.detach(), **kw)

    if cfg.family != "ssm":
        with pytest.raises(RuntimeError, match="not have been used"):
            value_and_grad(model, b["tokens"], b["labels"],
                           frontend_embeds=b.get("frontend"),
                           attention=detached)
