"""The port's sharded serve step against the JAX package's sharded serve
program and against its own one-process steps.

Each reduced config (float32) serves the same prompts from the same
weights (drawn by the port, carried to JAX through numpy) on a (2 data x 2
model) and a (1 data x 4 model) mesh: a prefill of a PROMPT-token prompt
into a CACHE-slot cache, then DECODE decode steps fed fixed tokens.  The
port's steps (``serve_prefill`` and ``serve_decode_step`` on DTensor
parameters and caches) run on four CPU processes over gloo, each on its
own heads, channels, vocabulary rows and cache slots; the JAX steps are
``serve_prefill`` and ``serve_decode_step`` jitted over four forced host
devices with the dry run's parameter and cache shardings, in a
subprocess.  Without a ring the prompt and decode steps reach position
PROMPT + DECODE - 1 = 15, so on the (1 x 4) mesh (8 slots a rank) two
model ranks hold keys and two none; hymba's and mixtral's 8-slot rings
wrap, 2 slots a rank there.  Logits, greedy tokens and every gathered
cache leaf are held within TOL of each tensor's largest entry against
both references.  Two planted faults must fail by a wide margin: the
merge of the ranks' partial attentions summing them without their
log-sum-exp weights, and mamba's ``in_proj`` gather with ``gather_from``'s
backward (each rank keeps its own partial gradient of the columns it
stores, which other ranks read) in a training step held to the
one-process step.  Every subprocess has a time limit and the process
group's store is a file under ``tmp_path``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import (nest, param_tree, params_from_numpy,
                                 params_to_numpy, tree_items)
from repro_torch.models.model import init_model
from repro_torch.serve.serve_step import serve_decode_step, serve_prefill
from repro_torch.train.data import DataConfig, batch_at_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "qwen3-4b", "mixtral-8x22b", "kimi-k2-1t-a32b",
         "whisper-medium", "internvl2-26b", "olmo-1b", "hymba-1.5b",
         "xlstm-350m")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
CASES = [(a, m) for a in ARCHS for m in MESHES]
BATCH, PROMPT, CACHE, DECODE = 4, 12, 32, 4
TOL = 1e-4              # of each tensor's largest entry
WIDE = 100.0            # a planted fault misses TOL by this factor at least
MERGE_FAULT_ARCH = "hymba-1.5b"    # a ring: every rank's slice holds keys
# A cache of 30 slots, which a 4-way model axis does not divide: the caches
# are then split by kv heads (olmo-1b's 4) or whole (qwen3-4b's 2).
UNEVEN_CACHE, UNEVEN_ARCHS = 30, ("olmo-1b", "qwen3-4b")
# The training step of the in_proj fault, as tests/test_torch_tensor_
# parallel.py takes it: one AdamW step that moves each parameter by its
# gradient's size.
OPT = dict(lr=1.0, eps=1.0, warmup_steps=1, weight_decay=0.0)
TRAIN_BATCH, TRAIN_SEQ = 8, 16
SUBPROCESS_S = 600


def _cfg(arch):
    return dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                               dtype="float32", remat="none")


def _inputs(cfg, seed=0):
    """The prompt (B, PROMPT), the DECODE fed tokens (DECODE, B, 1) and
    the frontend embeddings (or None), numpy."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    fed = rng.integers(0, cfg.vocab_size, (DECODE, BATCH, 1), dtype=np.int32)
    n = {"vision_stub": cfg.frontend_tokens,
         "audio_stub": cfg.encoder_seq}.get(cfg.frontend)
    fe = None if n is None else rng.normal(
        size=(BATCH, n, cfg.d_model)).astype(np.float32)
    return prompt, fed, fe


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


JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import ARCHS, reduced_config
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import cache_shardings, cache_specs
    from repro.models.config import InputShape
    from repro.models.model import init_model
    from repro.parallel.sharding import (batch_sharding, replicated,
                                         shardings_for_tree)
    from repro.serve.serve_step import serve_decode_step, serve_prefill
    out, archs, meshes = sys.argv[1], sys.argv[2].split(","), json.loads(
        sys.argv[3])
    B, P, C, D = %(batch)d, %(prompt)d, %(cache)d, %(decode)d

    def name(path):
        return ".".join(str(getattr(k, "key", k)) for k in path)

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, (tuple, list)):
            for t in tree:
                yield from leaves(t)
        else:
            yield tree

    for arch in archs:
        cfg = dataclasses.replace(reduced_config(ARCHS[arch]),
                                  dtype="float32", remat="none")
        params, axes = init_model(jax.random.PRNGKey(0), cfg)
        with np.load(f"{out}/weights_{arch}.npz") as z:
            params = jax.tree_util.tree_map_with_path(
                lambda path, _: jnp.asarray(z[name(path)]), params)
        with np.load(f"{out}/inputs_{arch}.npz") as z:
            prompt, fed = jnp.asarray(z["prompt"]), jnp.asarray(z["fed"])
            fe = jnp.asarray(z["fe"]) if "fe" in z.files else None
        shape = InputShape("serve", "decode", C, B)
        for mname, mshape in meshes.items():
            mesh = make_mesh(tuple(mshape), ("data", "model"))
            p_sh = shardings_for_tree(params, axes, mesh, fsdp=cfg.fsdp)
            t_sh = batch_sharding(mesh)
            c_sh = cache_shardings(cfg, shape, mesh, cache_specs(cfg, shape))
            pf = jax.jit(lambda p, t, f: serve_prefill(
                p, cfg, t, C, frontend_embeds=f),
                in_shardings=(p_sh, t_sh, None if fe is None else t_sh))
            dec = jax.jit(lambda p, c, t, i, e: serve_decode_step(
                p, cfg, t, c, i, enc_out=e),
                in_shardings=(p_sh, c_sh, t_sh, replicated(mesh),
                              None if cfg.encoder_layers == 0 else t_sh),
                out_shardings=(t_sh, t_sh, c_sh))
            res = {}
            with mesh:
                logits, caches = pf(params, prompt, fe)
                enc = caches.pop("enc_out", None)
                caches = jax.device_put(caches, c_sh)
                if enc is not None:
                    enc = jax.device_put(enc, t_sh)
                res["prefill"] = np.asarray(logits)
                for i in range(D):
                    nxt, logits, caches = dec(params, caches, fed[i],
                                              jnp.int32(P + i), enc)
                    res[f"logits_{i}"] = np.asarray(logits)
                    res[f"next_{i}"] = np.asarray(nxt)
            for j, leaf in enumerate(leaves(caches)):
                res[f"cache_{j}"] = np.asarray(leaf)
            np.savez(f"{out}/jax_{mname}_{arch}.npz", **res)
    print("RESULT " + json.dumps({"n_dev": jax.device_count()}))
""") % {"batch": BATCH, "prompt": PROMPT, "cache": CACHE, "decode": DECODE}


RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import configs
    from repro_torch.convert import nest, params_from_numpy, param_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, ssm
    from repro_torch.parallel import tensor_parallel as tpm
    from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                               shard_model)
    from repro_torch.serve.serve_step import serve_decode_step, serve_prefill
    from repro_torch.train.data import DataConfig, batch_at_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    rank, store, out, mname = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
    shape = tuple(json.loads(sys.argv[5]))
    archs, merge_arch = sys.argv[6].split(","), sys.argv[7]
    uneven = sys.argv[8].split(",")
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=4,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    B, P, C, D = %(batch)d, %(prompt)d, %(cache)d, %(decode)d

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, (tuple, list)):
            for t in tree:
                yield from leaves(t)
        else:
            yield tree

    def sharded(arch):
        cfg = dataclasses.replace(
            configs.reduced_config(configs.ARCHS[arch]), dtype="float32",
            remat="none")
        with np.load(f"{out}/weights_{arch}.npz") as z:
            model = params_from_numpy(nest(dict(z)), cfg, device="cpu")
        shard_model(model, mesh, fsdp=cfg.fsdp)
        return cfg, model

    def rows(a):
        return None if a is None else distribute(
            torch.from_numpy(a), mesh, batch_sharding(mesh))

    def serve(arch, tag, cache=C):
        cfg, model = sharded(arch)
        with np.load(f"{out}/inputs_{arch}.npz") as z:
            prompt, fed = z["prompt"], z["fed"]
            fe = z["fe"] if "fe" in z.files else None
        logits, caches = serve_prefill(model, rows(prompt), cache,
                                       frontend_embeds=rows(fe))
        enc = caches.pop("enc_out", None)
        res = {"prefill": logits.full_tensor().numpy()}
        for i in range(D):
            nxt, logits, caches = serve_decode_step(
                model, rows(fed[i]), caches, P + i, enc_out=enc)
            res[f"logits_{i}"] = logits.full_tensor().numpy()
            res[f"next_{i}"] = nxt.full_tensor().numpy()
        held = {}
        for j, leaf in enumerate(leaves(caches)):
            res[f"cache_{j}"] = leaf.full_tensor().numpy()
        if "kv" in caches:
            k = caches["kv"][0].to_local()
            held = {"slots": k.shape[2], "heads": k.shape[3],
                    "keys": bool(k.abs().sum() > 0)}
        if rank == 0:
            np.savez(f"{out}/{tag}_{mname}_{arch}.npz", **res)
        return held

    report = {"held": {}}
    for arch in archs:
        report["held"][arch] = serve(arch, "port")
    for arch in uneven:
        report["held"][f"{arch}/uneven"] = serve(arch, "uneven",
                                                  %(uneven)d)

    # Fault 1: the ranks' partial attentions summed without their weights.
    right = layers.merge_split_attention

    def unweighted(o, lse, seq, heads=None):
        if seq is None:
            return o
        part = o.float()
        part = tpm.all_reduce(part, seq) if heads is None \\
            else tpm.reduce_scatter(part, heads, 2)
        return part.to(o.dtype)
    layers.merge_split_attention = unweighted
    serve(merge_arch, "merge_fault")
    layers.merge_split_attention = right

    # Fault 2: mamba's in_proj gathered with gather_from's backward, in one
    # training step of hymba-1.5b.
    opt_cfg = AdamWConfig(**%(opt)r)

    def train(tag):
        cfg, model = sharded("hymba-1.5b")
        b = batch_at_step(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=%(tseq)d,
                                     global_batch=%(tbatch)d, seed=0), 0,
                          device="cpu")
        b = {k: distribute(v, mesh, batch_sharding(mesh))
             for k, v in b.items()}
        model, _, m = make_train_step(cfg, opt_cfg)(
            model, init_opt_state(param_tree(model), opt_cfg), b)
        full = {n: p.full_tensor().numpy()
                for n, p in model.named_parameters()}
        if rank == 0:
            np.savez(f"{out}/{tag}_{mname}.npz", **full)
    train("train")
    ssm.gather_shared = tpm.gather_from
    train("in_proj_fault")
    dist.barrier()
    dist.destroy_process_group()
    json.dump(report, open(f"{out}/rank{rank}_{mname}.json", "w"))
""") % {"batch": BATCH, "prompt": PROMPT, "cache": CACHE, "decode": DECODE,
        "opt": OPT, "tseq": TRAIN_SEQ, "tbatch": TRAIN_BATCH,
        "uneven": UNEVEN_CACHE}


def _spawn(args, env):
    return subprocess.Popen([sys.executable, "-c", *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _weights(arch, out):
    cfg = _cfg(arch)
    with np.load(out / f"weights_{arch}.npz") as z:
        return cfg, params_from_numpy(nest(dict(z)), cfg, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sharded serve steps and the port's 4-process runs on both
    meshes, all started together; the weights and inputs written first."""
    out = tmp_path_factory.mktemp("serve")
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = init_model(cfg, seed=0, device="cpu")
        np.savez(out / f"weights_{arch}.npz", **{
            ".".join(p): a for p, a in tree_items(params_to_numpy(model))})
        prompt, fed, fe = _inputs(cfg)
        np.savez(out / f"inputs_{arch}.npz", prompt=prompt, fed=fed,
                 **({} if fe is None else {"fe": fe}))
    # one thread a process: nine processes share the host with the other
    # test workers, and the reduced configs' products are tiny
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = {"jax": _spawn([JAX_SCRIPT, str(out), ",".join(ARCHS),
                            json.dumps(MESHES)],
                           dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=
                                "--xla_force_host_platform_device_count=4"))}
    for mname, shape in MESHES.items():
        for r in range(4):
            procs[f"{mname}/{r}"] = _spawn(
                [RANK_SCRIPT, str(r), str(out / f"store_{mname}"), str(out),
                 mname, json.dumps(shape), ",".join(ARCHS),
                 MERGE_FAULT_ARCH, ",".join(UNEVEN_ARCHS)], env)
    try:
        outs = {k: p.communicate(timeout=SUBPROCESS_S)
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, (k, outs[k][1][-4000:])
    line = [ln for ln in outs["jax"][0].splitlines()
            if ln.startswith("RESULT ")]
    got = {"jax": json.loads(line[-1][len("RESULT "):]), "dir": out}
    for mname in MESHES:
        got[mname] = [json.loads((out / f"rank{r}_{mname}.json").read_text())
                      for r in range(4)]
    return got


_SINGLE = {}


def _single(arch, out, cache=CACHE) -> dict:
    """The port's one-process prefill and decode steps from the same
    weights and inputs, in the layout of the saved runs."""
    if (arch, cache) not in _SINGLE:
        cfg, model = _weights(arch, out)
        with np.load(out / f"inputs_{arch}.npz") as z:
            prompt, fed = z["prompt"], z["fed"]
            fe = torch.from_numpy(z["fe"]) if "fe" in z.files else None
        logits, caches = serve_prefill(model, torch.from_numpy(prompt),
                                       cache, frontend_embeds=fe)
        enc = caches.pop("enc_out", None)
        res = {"prefill": logits.numpy()}
        for i in range(DECODE):
            nxt, logits, caches = serve_decode_step(
                model, torch.from_numpy(fed[i]), caches, PROMPT + i,
                enc_out=enc)
            res[f"logits_{i}"] = logits.numpy()
            res[f"next_{i}"] = nxt.numpy()
        for j, leaf in enumerate(_leaves(caches)):
            res[f"cache_{j}"] = leaf.numpy()
        _SINGLE[arch, cache] = res
    return _SINGLE[arch, cache]


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _worst(got: dict, want: dict) -> float:
    """The largest error of any tensor of ``got`` against ``want``, in units
    of TOL times that tensor's largest entry; greedy tokens must be
    equal."""
    assert sorted(got) == sorted(want)
    worst = 0.0
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if key.startswith("next_"):
            assert (g == w).all(), (key, g.ravel(), w.ravel())
            continue
        w = w.astype(np.float64)
        # the -1e30 stabilisers and pad logits compare as they are
        w, g = np.where(w <= -1e29, 0, w), np.where(g <= -1e29, 0,
                                                    g.astype(np.float64))
        scale = max(np.abs(w).max(), 1e-30)
        worst = max(worst, np.abs(g - w).max() / (TOL * scale))
    return worst


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_serve_equals_the_jax_sharded_serve(runs, arch, mesh):
    """Prefill and every decode step's logits, greedy tokens and the final
    caches within TOL of the JAX package's steps jitted over the same
    mesh."""
    assert runs["jax"]["n_dev"] == 4
    d = runs["dir"]
    got = _load(d / f"port_{mesh}_{arch}.npz")
    assert _worst(got, _load(d / f"jax_{mesh}_{arch}.npz")) <= 1.0


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_serve_equals_the_one_process_steps(runs, arch, mesh):
    """The same bounds against the port's own steps on one process."""
    got = _load(runs["dir"] / f"port_{mesh}_{arch}.npz")
    assert _worst(got, _single(arch, runs["dir"])) <= 1.0


@pytest.mark.parametrize("arch", UNEVEN_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_caches_the_model_axis_does_not_divide(runs, arch, mesh):
    """A cache of UNEVEN_CACHE slots: on the (1 x 4) mesh split by kv
    heads (olmo-1b's 4) or whole (qwen3-4b's 2), on the (2 x 2) mesh along
    its slots; the steps equal the one-process steps within TOL."""
    got = _load(runs["dir"] / f"uneven_{mesh}_{arch}.npz")
    assert _worst(got, _single(arch, runs["dir"], UNEVEN_CACHE)) <= 1.0
    kv, n_model = _cfg(arch).n_kv_heads, MESHES[mesh][1]
    want = (UNEVEN_CACHE // 2, kv) if n_model == 2 else \
        (UNEVEN_CACHE, kv // 4 if kv % 4 == 0 else kv)
    held = [r["held"][f"{arch}/uneven"] for r in runs[mesh]]
    assert [(h["slots"], h["heads"]) for h in held] == [want] * 4


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_slots(runs, mesh):
    """The k/v caches are split along their slots: C / model slots a rank
    (a ring's 8 too).  Up to position 15 of the 32-slot cache, the (1 x 4)
    mesh's first two model ranks hold keys and the last two none; on a
    ring every rank holds keys."""
    n_model = MESHES[mesh][1]
    for arch in ARCHS:
        cfg = _cfg(arch)
        held = [r["held"][arch] for r in runs[mesh]]
        if cfg.family == "ssm":
            assert held == [{}] * 4
            continue
        ring = cfg.sliding_window is not None
        slots = (min(CACHE, cfg.sliding_window) if ring else CACHE) // n_model
        want = [ring or (r % n_model) * slots < PROMPT + DECODE
                for r in range(4)]
        assert [h["slots"] for h in held] == [slots] * 4, arch
        assert [h["keys"] for h in held] == want, (arch, held)
    if mesh == "1x4":
        assert [r["held"]["qwen3-4b"]["keys"] for r in runs[mesh]] == \
            [True, True, False, False]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_an_unweighted_merge_fails_by_a_wide_margin(runs, mesh):
    """Summing the ranks' partial attentions without their log-sum-exp
    weights: hymba-1.5b's decode logits miss TOL by WIDE against both
    references (its prefill does not merge, and matches)."""
    d = runs["dir"]
    got = _load(d / f"merge_fault_{mesh}_{MERGE_FAULT_ARCH}.npz")
    for want in (_load(d / f"jax_{mesh}_{MERGE_FAULT_ARCH}.npz"),
                 _single(MERGE_FAULT_ARCH, d)):
        assert _worst({"prefill": got["prefill"]},
                      {"prefill": want["prefill"]}) <= 1.0
        assert _worst({"logits_0": got["logits_0"]},
                      {"logits_0": want["logits_0"]}) >= WIDE


def _train_single(out) -> dict:
    cfg, model = _weights("hymba-1.5b", out)
    opt_cfg = AdamWConfig(**OPT)
    batch = batch_at_step(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH, seed=0), 0,
                          device="cpu")
    model, _, _ = make_train_step(cfg, opt_cfg)(
        model, init_opt_state(param_tree(model), opt_cfg), batch)
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_in_proj_gather_needs_its_reduce_scatter(runs, mesh):
    """One sharded training step of hymba-1.5b equals the one-process step
    within TOL of each parameter's update; with ``in_proj`` gathered by
    ``gather_from`` (whose backward keeps only this rank's own partial of
    the columns it stores) ``in_proj``'s update misses it by WIDE."""
    d = runs["dir"]
    want = _train_single(d)
    start = _load(d / "weights_hymba-1.5b.npz")

    def ratio(got, name):
        w = want[name].astype(np.float64)
        upd = np.abs(w - start[name]).max()
        return np.abs(got[name] - w).max() / (TOL * upd + 1e-12)

    got = _load(d / f"train_{mesh}.npz")
    assert max(ratio(got, n) for n in want) <= 1.0
    fault = _load(d / f"in_proj_fault_{mesh}.npz")
    assert ratio(fault, "blocks.mamba.in_proj") >= WIDE
