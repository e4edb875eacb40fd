"""The port's compressed training step on a pod mesh against the JAX
package's compressed step on its ``shard_map`` path (jax 0.9.0; a jax
without ``jax.shard_map`` takes ``repro``'s stacked fallback).

One fixture starts everything together: a JAX subprocess of eight forced
host devices running ``make_compressed_train_step(cfg, opt_cfg, mesh)`` on
a (2, 2, 2) ``("pod", "data", "model")`` mesh, and eight gloo processes
running the port's step on the same mesh, each pod's gradient
tensor-parallel on its (data, model) submesh and each leaf through the
int8 error-feedback stage over the pod group.  Weights (drawn by the port)
and batches go across as numpy files.  The reduced configs run in float32,
remat ``none``, ``fsdp=False`` (the JAX contract: parameters replicated
over pods).

The cases:

- (a) the leaf stage alone on seeded leaves, one split over ``model``, one
  over ``data`` and ``model``, one whole: bit for bit the JAX
  ``compressed_psum_pod`` under ``vmap(axis_name="pod")``;
- (b) olmo-1b, two steps with an AdamW whose updates follow the
  gradient's size: the loss, gradient norm, each residual and each update
  (:func:`_int8_misses`, which allows the elements that round to a
  neighbouring int8 value);
- (c) 15 steps of ``test_pod_compressed_allreduce_converges``'s
  configuration, every loss within 1e-3 of JAX's;
- (d) a batch whose second pod has half its labels masked;
- (e) internvl2-26b and whisper-medium with frontend rows, mixtral-8x22b
  with its aux loss, on the mesh and in the stacked form;
- (f) a pod axis of one, in this process, bit for bit the stacked form;
- (g) planted faults (the pod all-reduce dropped, a per-shard scale, the
  token share summed over pods, the frontend dropped), which must miss.

Every subprocess has a time limit; a failing one is named with its exit
code and the tail of its stderr, each of them.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.parallel.compression import compressed_psum_pod as jpsum_pod
from repro_torch import configs
from repro_torch.convert import (nest, param_tree, params_from_numpy,
                                 params_to_numpy, tree_items)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import init_model
from repro_torch.parallel import compression
from repro_torch.parallel.compression import (init_error_state,
                                              make_compressed_train_step)
from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                           shard_model)
from repro_torch.train.data import DataConfig, batch_at_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import IGNORE, make_train_step

REPO = Path(__file__).resolve().parents[1]
BATCH, SEQ = 8, 16
WORLD = 8
# AdamW's first step with eps far above every gradient entry and no warmup
# or decay moves each parameter by lr * g / (|g| + eps): the gradient's own
# size, as the tensor-parallel tests step.
OPT = dict(lr=1.0, eps=1.0, warmup_steps=1, weight_decay=0.0)
# tests/test_distribution.py::test_pod_compressed_allreduce_converges
CONVERGE_OPT = dict(lr=5e-3, warmup_steps=1)
CONVERGE_STEPS = 15
FAMILIES = ("internvl2-26b", "whisper-medium", "mixtral-8x22b")
# name -> (shape, per mesh axis the dimension it splits, or None)
LEAVES = {"split": ((6, 8), (None, None, 1)),
          "both": ((4, 6), (None, 0, 1)),
          "whole": ((5, 7), (None, None, None))}
LOSS_TOL, GRAD_NORM_REL = 1e-5, 1e-4
CONVERGE_TOL = 1e-3
# An element whose target lies within float32 rounding of a half-integer
# multiple of the scale rounds to a neighbouring int8 value in one program
# and not in the other; it then differs by one quantization step, and a
# later step carries part of that.  Every other element is held within
# 1e-5 of the leaf's largest |g + err| (127 scales): the two programs'
# scales differ by float32 rounding of that maximum (~1e-6 relative),
# which moves each q * scale by up to 127 times the difference.
FLIP_STEP, FLIP_SHARE, CLOSE = 1 + 1e-5, 1e-3, 127 * 1e-5
SUBPROCESS_S = 400


def _cfg(arch):
    return dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                               dtype="float32", remat="none", fsdp=False)


def _frontend(cfg, seed=0):
    if cfg.frontend is None:
        return None
    n = cfg.frontend_tokens if cfg.frontend == "vision_stub" \
        else cfg.encoder_seq
    return np.random.default_rng(seed).normal(
        size=(BATCH, n, cfg.d_model)).astype(np.float32)


def _batch(seed, step, cfg):
    b = batch_at_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                 global_batch=BATCH, seed=seed), step,
                      device="cpu")
    out = {k: v.numpy() for k, v in b.items()}
    fe = _frontend(cfg)
    if fe is not None:
        out["frontend"] = fe
    return out


def _uneven(cfg):
    """Step 0's batch with every other label of pod 1's rows masked."""
    b = _batch(0, 0, cfg)
    b["labels"][BATCH // 2:, ::2] = IGNORE
    return b


# run -> (arch, AdamW settings, batch names); every run starts from the
# port's seed-0 weights of its arch.
RUNS = {"parity": ("olmo-1b", OPT, ["parity_0", "parity_1"]),
        "converge": ("olmo-1b", CONVERGE_OPT,
                     [f"converge_{i}" for i in range(CONVERGE_STEPS)]),
        "uneven": ("olmo-1b", OPT, ["uneven"]),
        **{a: (a, OPT, [f"family_{a}"]) for a in FAMILIES}}
SAVED = ("parity",) + FAMILIES       # runs whose parameters are compared


def _write_inputs(out: Path) -> None:
    for arch in {a for a, _, _ in RUNS.values()}:
        model = init_model(_cfg(arch), seed=0, device="cpu")
        np.savez(out / f"weights_{arch}.npz", **{
            ".".join(p): a for p, a in tree_items(params_to_numpy(model))})
    olmo = _cfg("olmo-1b")
    batches = {f"parity_{i}": _batch(0, i, olmo) for i in range(2)}
    batches.update({f"converge_{i}": _batch(1, i, olmo)
                    for i in range(CONVERGE_STEPS)})
    batches["uneven"] = _uneven(olmo)
    batches.update({f"family_{a}": _batch(0, 0, _cfg(a)) for a in FAMILIES})
    for name, b in batches.items():
        np.savez(out / f"batch_{name}.npz", **b)
    rng = np.random.default_rng(7)
    np.savez(out / "leaves.npz", **{
        f"{k}_{name}": (rng.normal(size=(2,) + shape)
                        * (1.0 if k == "g" else 1e-3)).astype(np.float32)
        for name, (shape, _) in LEAVES.items() for k in ("g", "e")})


JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import ARCHS, reduced_config
    from repro.launch.mesh import make_mesh
    from repro.models.model import init_model
    from repro.parallel.compression import (init_error_state,
                                            make_compressed_train_step)
    from repro.parallel.sharding import shardings_for_tree
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import lm_loss
    out, runs, saved = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    saved = saved.split(",")

    def name(path):
        return ".".join(str(getattr(k, "key", k)) for k in path)

    def flat(tree):
        return {name(path): np.asarray(leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    def pod_scales(cfg):
        # each pod's scale max|g + err| / 127, its gradient taken apart
        # from the step (the bound of an element that rounds otherwise)
        def scales(params, err, batch):
            fe = batch.get("frontend")
            split = lambda x: x.reshape(2, -1, *x.shape[1:])
            def one(tok, lab, f):
                return jax.grad(lambda p: lm_loss(p, cfg, tok, lab, f)[0])(
                    params)
            g = jax.vmap(one, in_axes=(0, 0, None if fe is None else 0))(
                split(batch["tokens"]), split(batch["labels"]),
                None if fe is None else split(fe))
            return jax.tree.map(lambda g, e: jnp.max(
                jnp.abs(g + e), axis=tuple(range(1, g.ndim))) / 127.0, g, err)
        return jax.jit(scales)

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    res = {}
    for run, (arch, opt, batches) in runs.items():
        cfg = dataclasses.replace(reduced_config(ARCHS[arch]),
                                  dtype="float32", remat="none", fsdp=False)
        params, axes = init_model(jax.random.PRNGKey(0), cfg)
        with np.load(f"{out}/weights_{arch}.npz") as z:
            params = jax.tree_util.tree_map_with_path(
                lambda path, _: jnp.asarray(z[name(path)]), params)
        opt_cfg = AdamWConfig(**opt)
        p_sh = shardings_for_tree(params, axes, mesh, fsdp=False)
        step = jax.jit(make_compressed_train_step(cfg, opt_cfg, mesh))
        scales = pod_scales(cfg) if run in saved else None
        opt_state = init_opt_state(params, opt_cfg)
        err = init_error_state(params, n_pods=2)
        res[run] = []
        with mesh:
            params = jax.device_put(params, p_sh)
            for i, bname in enumerate(batches):
                with np.load(f"{out}/batch_{bname}.npz") as z:
                    batch = {k: jnp.asarray(z[k]) for k in z.files}
                if scales is not None:
                    s = flat(scales(params, err, batch))
                params, opt_state, err, m = step(params, opt_state, err,
                                                 batch)
                res[run].append([float(m["loss"]), float(m["aux_loss"]),
                                 float(m["grad_norm"])])
                if scales is not None:
                    np.savez(f"{out}/jax_{run}_{i}.npz",
                             **{"p:" + k: v for k, v in flat(params).items()},
                             **{"e:" + k: v for k, v in flat(err).items()},
                             **{"s:" + k: v for k, v in s.items()})
    print("RESULT " + json.dumps({"metrics": res, "n_dev": jax.device_count(),
                                  "shard_map": hasattr(jax, "shard_map")}))
""")


RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch import configs
    from repro_torch.convert import nest, param_tree, params_from_numpy
    from repro_torch.convert import tree_items
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import compression
    from repro_torch.parallel.compression import (
        compress_over_pods, error_state_placements, init_error_state,
        make_compressed_train_step)
    from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                               shard_model)
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    runs, saved, leaves = (json.loads(sys.argv[4]), sys.argv[5].split(","),
                           json.loads(sys.argv[6]))
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=8,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    pod, data, model_rank = mesh.get_coordinate()
    res = {"coord": [pod, data, model_rank], "metrics": {}, "raised": {}}

    def cfg_of(arch):
        return dataclasses.replace(
            configs.reduced_config(configs.ARCHS[arch]), dtype="float32",
            remat="none", fsdp=False)

    def sharded(arch):
        cfg = cfg_of(arch)
        with np.load(f"{out}/weights_{arch}.npz") as z:
            model = params_from_numpy(nest(dict(z)), cfg, device="cpu")
        shard_model(model, mesh, fsdp=False)
        return cfg, model

    def batch_of(bname):
        with np.load(f"{out}/batch_{bname}.npz") as z:
            return {k: distribute(torch.from_numpy(z[k]), mesh,
                                  batch_sharding(mesh)) for k in z.files}

    def save(tag, tensors):
        full = {k: t.full_tensor().numpy() for k, t in tensors.items()}
        if rank == 0:
            np.savez(f"{out}/{tag}.npz", **full)

    def run(tag, arch, opt, batches, keep):
        cfg, model = sharded(arch)
        opt_cfg = AdamWConfig(**opt)
        state = init_opt_state(param_tree(model), opt_cfg)
        err = init_error_state(param_tree(model), 2, mesh)
        step = make_compressed_train_step(cfg, opt_cfg, mesh)
        res["metrics"][tag] = []
        for i, bname in enumerate(batches):
            model, state, err, m = step(model, state, err, batch_of(bname))
            res["metrics"][tag].append([float(m["loss"]),
                                        float(m["aux_loss"]),
                                        float(m["grad_norm"])])
            if keep:
                save(f"port_{tag}_{i}", {
                    **{"p:" + n: p for n, p in model.named_parameters()},
                    **{"e:" + ".".join(k): e for k, e in tree_items(err)}})

    def leaf_stage(tag):
        # this pod's gradient leaves and the residuals, placed as a
        # parameter split as LEAVES says would be
        with np.load(f"{out}/leaves.npz") as z:
            grads = {k: distribute(torch.from_numpy(z["g_" + k][pod]), mesh,
                                   [Replicate() if d is None else Shard(d)
                                    for d in splits])
                     for k, (_, splits) in leaves.items()}
            pl = error_state_placements(grads, mesh)
            errs = {k: distribute(torch.from_numpy(z["e_" + k]), mesh, pl[k])
                    for k in leaves}
        res.setdefault("err_placements", {k: [repr(p) for p in v]
                                          for k, v in pl.items()})
        mean, new = compress_over_pods(grads, errs, mesh)
        # the mean is replicated over pods: each pod's own is gathered
        got = {"m:" + k: t.full_tensor().numpy() for k, t in mean.items()}
        got.update({"e:" + k: t.full_tensor().numpy()
                    for k, t in new.items()})
        if data == 0 and model_rank == 0:
            np.savez(f"{out}/leaf_{tag}_pod{pod}.npz", **got)

    # which rows of the batch each rank holds
    res["rows"] = distribute(torch.arange(8), mesh,
                             batch_sharding(mesh)).to_local().tolist()

    leaf_stage("port")
    for tag, (arch, opt, batches) in runs.items():
        run(tag, arch, opt, batches, tag in saved)

    # The plain sharded step on the same mesh (the pod axis one more data
    # axis), one step of the parity run's weights and batch.
    cfg, model = sharded("olmo-1b")
    opt_cfg = AdamWConfig(**runs["parity"][1])
    model, _, m = train_step.make_train_step(cfg, opt_cfg)(
        model, init_opt_state(param_tree(model), opt_cfg),
        batch_of("parity_0"))
    res["plain"] = [float(m["loss"]), float(m["grad_norm"])]
    save("plain", {n: p for n, p in model.named_parameters()})

    # Planted faults, one at a time.
    right = compression.compressed_psum_pod
    compression.compressed_psum_pod = (
        lambda g, e, group=None, scale_groups=(): right(g, e, None,
                                                        scale_groups))
    leaf_stage("pod_dropped")
    run("pod_dropped", "olmo-1b", runs["parity"][1], runs["parity"][2][:1],
        True)
    compression.compressed_psum_pod = (
        lambda g, e, group=None, scale_groups=(): right(g, e, group))
    leaf_stage("shard_scale")
    run("shard_scale", "olmo-1b", runs["parity"][1], runs["parity"][2][:1],
        True)
    compression.compressed_psum_pod = right

    sum_over = train_step._sum_over_data
    calls = [0]
    def share_over_pods(t, mesh, axes=train_step.BATCH_AXES):
        # the first of the three sums in a step is the token count's
        calls[0] += 1
        sum_over(t, mesh, train_step.BATCH_AXES if calls[0] % 3 == 1
                 else axes)
    train_step._sum_over_data = share_over_pods
    run("share", *runs["uneven"], False)
    train_step._sum_over_data = sum_over

    grads_of = train_step.value_and_grad
    def no_frontend(*a, frontend_embeds=None, **kw):
        return grads_of(*a, **kw)
    train_step.value_and_grad = no_frontend
    for arch in ("internvl2-26b", "whisper-medium"):
        try:
            run("frontend_" + arch, *runs[arch], False)
        except (ValueError, RuntimeError) as e:
            res["raised"][arch] = [type(e).__name__, str(e)]
    train_step.value_and_grad = grads_of

    dist.barrier()
    dist.destroy_process_group()
    json.dump(res, open(f"{out}/rank{rank}.json", "w"))
""")


def _spawn(out: Path, key: str, args: list, env: dict) -> subprocess.Popen:
    """A Python subprocess whose stdout and stderr go to files under
    ``out`` named after ``key`` (no pipe to fill while others run)."""
    with open(out / f"{key}.stdout", "w") as so, \
            open(out / f"{key}.stderr", "w") as se:
        return subprocess.Popen([sys.executable, "-c", *args], env=env,
                                stdout=so, stderr=se, text=True)


def _wait_all(out: Path, procs: dict, limit: float) -> dict:
    """Wait for every process of ``procs`` (key -> Popen of :func:`_spawn`)
    within ``limit`` seconds in all; kill those still running.  Fails
    naming every process that hung or exited non-zero, each with its
    return code and the tail of its stderr; else returns each one's
    stdout."""
    deadline = time.monotonic() + limit
    hung = []
    for key, p in procs.items():
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            hung.append(key)
    for key in hung:
        procs[key].kill()
        procs[key].wait()
    failed = [(key, p.returncode) for key, p in procs.items()
              if key in hung or p.returncode != 0]
    if failed:
        pytest.fail("\n\n".join(
            f"{key}: exit {rc}"
            + (f", hung past {limit} s and killed" if key in hung else "")
            + "\n" + (out / f"{key}.stderr").read_text()[-3000:]
            for key, rc in failed))
    return {key: (out / f"{key}.stdout").read_text() for key in procs}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX compressed steps and the port's 8-process runs, started
    together after the weights, batches and leaves are written."""
    out = tmp_path_factory.mktemp("pods")
    _write_inputs(out)
    runs_arg = json.dumps(RUNS)
    saved = ",".join(SAVED)
    # one thread a process: nine processes share the host with the other
    # test workers, and the reduced configs' products are tiny
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = {"jax": _spawn(out, "jax", [JAX_SCRIPT, str(out), runs_arg,
                                        saved],
                           dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=
                                "--xla_force_host_platform_device_count=8"))}
    for r in range(WORLD):
        procs[f"rank{r}"] = _spawn(out, f"rank{r}", [
            RANK_SCRIPT, str(r), str(out / "store"), str(out), runs_arg,
            saved, json.dumps(LEAVES)], env)
    stdout = _wait_all(out, procs, SUBPROCESS_S)
    line = [ln for ln in stdout["jax"].splitlines()
            if ln.startswith("RESULT ")]
    return {"jax": json.loads(line[-1][len("RESULT "):]), "dir": out,
            "ranks": [json.loads((out / f"rank{r}.json").read_text())
                      for r in range(WORLD)],
            "seconds": time.monotonic() - t0}


def _load(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _int8_misses(got, want, scale) -> tuple:
    """Where ``got`` is beyond ``want``: an element more than CLOSE·scale
    away (1e-5 of the leaf's range) counts as rounded to a neighbouring
    int8 value, which is allowed only within FLIP_STEP·scale and for at
    most FLIP_SHARE of the elements.  ``scale`` broadcasts against the
    arrays.  Returns (the count of such elements, ``[]`` or the counts
    that miss)."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    scale = np.broadcast_to(scale, diff.shape)
    n = int((diff > CLOSE * scale).sum())
    beyond = int((diff > FLIP_STEP * scale).sum())
    if beyond or n > FLIP_SHARE * diff.size:
        return n, [(beyond, n, diff.size, float(diff.max()))]
    return n, []


def _metrics_misses(got, want, aux=False) -> list:
    out = []
    if abs(got[0] - want[0]) >= LOSS_TOL:
        out.append(("loss", got[0], want[0]))
    if aux and abs(got[1] - want[1]) >= LOSS_TOL:
        out.append(("aux", got[1], want[1]))
    if abs(got[2] - want[2]) > GRAD_NORM_REL * want[2]:
        out.append(("grad_norm", got[2], want[2]))
    return out


def _step_misses(runs, tag, run, i, flips=None) -> list:
    """The port's saved step ``i`` of ``tag`` against JAX's of ``run``:
    every residual leaf by its pod's scale, every update (the parameters
    less the same program's before the step) by the larger pod scale (a
    flipped element moves the mean by half its pod's step, and Adam's
    update by at most that)."""
    def params(prefix):
        if i == 0:
            return _weights(runs, RUNS[run][0])
        return {k[2:]: v for k, v in _load(
            runs["dir"] / f"{prefix}_{i - 1}.npz").items()
            if k.startswith("p:")}
    got = _load(runs["dir"] / f"port_{tag}_{i}.npz")
    want = _load(runs["dir"] / f"jax_{run}_{i}.npz")
    got_before, want_before = params(f"port_{tag}"), params(f"jax_{run}")
    misses = []
    for key in want:
        kind, leaf = key.split(":", 1)
        if kind == "s":
            continue
        scale = want["s:" + leaf]
        if kind == "e":
            scale = scale.reshape((2,) + (1,) * (want[key].ndim - 1))
            g, w = got[key], want[key]
        else:
            scale = scale.max()
            g, w = got[key] - got_before[leaf], want[key] - want_before[leaf]
        n, m = _int8_misses(g, w, scale)
        if m:
            misses.append((key, m))
        if flips is not None:
            flips[f"{i}/{key}"] = n
    return misses


def _weights(runs, arch) -> dict:
    return _load(runs["dir"] / f"weights_{arch}.npz")


def test_jax_ran_the_compressed_step_on_8_devices(runs):
    """The reference is ``repro``'s ``shard_map`` path wherever jax has
    ``jax.shard_map`` (its stacked fallback otherwise)."""
    assert runs["jax"]["n_dev"] == WORLD
    assert runs["jax"]["shard_map"] == hasattr(jax, "shard_map")
    assert set(runs["jax"]["metrics"]) == set(RUNS)
    print(f"fixture took {runs['seconds']:.1f} s")


def test_pod_p_holds_the_stacked_forms_rows(runs):
    """``batch_sharding`` splits rows over (pod, data), pod outer: pod p
    holds the p-th contiguous half, JAX's ``P("pod")`` and the stacked
    form's ``chunk``, and the data ranks split it in order."""
    halves = torch.arange(BATCH).chunk(2)
    for r in runs["ranks"]:
        p, d, _ = r["coord"]
        assert r["rows"] == halves[p].chunk(2)[d].tolist()


@pytest.mark.parametrize("tag", ["port", "pod_dropped", "shard_scale"])
def test_leaf_stage_is_bitwise_jax(runs, tag):
    """(a) Each pod's mean and the gathered residuals of the distributed
    stage equal the JAX ``compressed_psum_pod`` under ``vmap`` over the
    pod axis on the whole leaves, bit for bit; with the pod all-reduce
    dropped or a per-shard scale, they do not."""
    leaves = _load(runs["dir"] / "leaves.npz")
    pods = [_load(runs["dir"] / f"leaf_{tag}_pod{p}.npz") for p in range(2)]
    same = {}
    for name in LEAVES:
        jmean, jerr = jax.vmap(jpsum_pod, axis_name="pod")(
            jnp.asarray(leaves["g_" + name]), jnp.asarray(leaves["e_" + name]))
        same[name] = all(
            np.array_equal(got["m:" + name], np.asarray(jmean)[p])
            and np.array_equal(got["e:" + name], np.asarray(jerr))
            for p, got in enumerate(pods))
    if tag == "port":
        assert all(same.values()), same
    elif tag == "pod_dropped":
        assert not any(same.values()), same
    else:       # only a leaf split over other axes has shards' scales
        assert same == {"split": False, "both": False, "whole": True}, same


def test_residual_placements_follow_the_leaf(runs):
    """``Shard(0)`` over pod, the leaf's own splits moved up one."""
    want = {"split": ["Shard(dim=0)", "Replicate()", "Shard(dim=2)"],
            "both": ["Shard(dim=0)", "Shard(dim=1)", "Shard(dim=2)"],
            "whole": ["Shard(dim=0)", "Replicate()", "Replicate()"]}
    for r in runs["ranks"]:
        assert r["err_placements"] == want


def test_step_parity_with_the_jax_compressed_step(runs):
    """(b) olmo-1b, two steps: loss within 1e-5, gradient norm within 1e-4
    relative, every residual and update within :func:`_int8_misses`'s
    bounds of JAX's shard_map step; every rank reports the same."""
    want = runs["jax"]["metrics"]["parity"]
    for r in runs["ranks"]:
        assert r["metrics"]["parity"] == runs["ranks"][0]["metrics"]["parity"]
    got = runs["ranks"][0]["metrics"]["parity"]
    for g, w in zip(got, want):
        assert _metrics_misses(g, w) == []
    flips = {}
    for i in range(2):
        assert _step_misses(runs, "parity", "parity", i, flips) == []
    print("elements rounded to a neighbouring int8 value:",
          {k: n for k, n in flips.items() if n})


def test_compressed_steps_converge_and_track_jax(runs):
    """(c) The JAX convergence test's configuration and bounds against
    the exact step (the port's, one process), every loss within 1e-3 of
    JAX's compressed step's."""
    got = [m[0] for m in runs["ranks"][0]["metrics"]["converge"]]
    want = [m[0] for m in runs["jax"]["metrics"]["converge"]]
    cfg = _cfg("olmo-1b")
    opt_cfg = AdamWConfig(**CONVERGE_OPT)
    model = params_from_numpy(nest(_weights(runs, "olmo-1b")), cfg,
                              device="cpu")
    state = init_opt_state(param_tree(model), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    exact = []
    for i in range(CONVERGE_STEPS):
        b = _load(runs["dir"] / f"batch_converge_{i}.npz")
        model, state, m = step(model, state, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
        exact.append(float(m["loss"]))
    assert got[-1] < got[0] - 0.2
    assert abs(got[-1] - exact[-1]) < 0.15
    assert max(abs(a - b) for a, b in zip(got, want)) < CONVERGE_TOL, \
        (got, want)


def test_uneven_masking_takes_each_pods_own_mean(runs):
    """(d) Pod 1's rows half masked: the loss and gradient norm are JAX's,
    each pod's loss the mean over its own labelled tokens."""
    got = runs["ranks"][0]["metrics"]["uneven"][0]
    want = runs["jax"]["metrics"]["uneven"][0]
    assert _metrics_misses(got, want) == []
    assert got != runs["ranks"][0]["metrics"]["parity"][0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_on_the_mesh_match_jax(runs, arch):
    """(e) One step of each family on the mesh: loss, aux, gradient norm,
    residuals and updates as in (b)."""
    got = runs["ranks"][0]["metrics"][arch][0]
    want = runs["jax"]["metrics"][arch][0]
    assert _metrics_misses(got, want, aux=True) == []
    if arch == "mixtral-8x22b":
        assert want[1] > 0
    assert _step_misses(runs, arch, arch, 0) == []


def _stacked_step(runs, arch, n_pods=2):
    cfg = _cfg(arch)
    model = params_from_numpy(nest(_weights(runs, arch)), cfg, device="cpu")
    opt_cfg = AdamWConfig(**OPT)
    state = init_opt_state(param_tree(model), opt_cfg)
    err = init_error_state(param_tree(model), n_pods)
    b = _load(runs["dir"] / f"batch_family_{arch}.npz")
    model, _, err, m = make_compressed_train_step(cfg, opt_cfg)(
        model, state, err, {k: torch.from_numpy(v) for k, v in b.items()})
    return model, err, [float(m["loss"]), float(m["aux_loss"]),
                        float(m["grad_norm"])]


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_in_the_stacked_form_match_jax(runs, arch):
    """(e) The stacked form (2 pods, one process) passes each pod its
    frontend rows: one step held to JAX as on the mesh."""
    model, err, got = _stacked_step(runs, arch)
    assert _metrics_misses(got, runs["jax"]["metrics"][arch][0],
                           aux=True) == []
    saved = {**{"p:" + n: p.detach().numpy()
                for n, p in model.named_parameters()},
             **{"e:" + ".".join(k): e.numpy() for k, e in tree_items(err)}}
    np.savez(runs["dir"] / f"port_stacked_{arch}_0.npz", **saved)
    assert _step_misses(runs, f"stacked_{arch}", arch, 0) == []


def test_plain_sharded_step_on_the_pod_mesh_sums_over_pods(runs):
    """The plain sharded step on the same (2, 2, 2) mesh still takes the
    whole batch's mean, the pod axis one more data axis: within the
    tensor-parallel tests' bounds of the one-process step."""
    cfg = _cfg("olmo-1b")
    opt_cfg = AdamWConfig(**OPT)
    model = params_from_numpy(nest(_weights(runs, "olmo-1b")), cfg,
                              device="cpu")
    b = _load(runs["dir"] / "batch_parity_0.npz")
    model, _, m = make_train_step(cfg, opt_cfg)(
        model, init_opt_state(param_tree(model), opt_cfg),
        {k: torch.from_numpy(v) for k, v in b.items()})
    got = runs["ranks"][0]["plain"]
    assert abs(got[0] - float(m["loss"])) < LOSS_TOL
    assert abs(got[1] - float(m["grad_norm"])) < 1e-5 * float(m["grad_norm"])
    plain = _load(runs["dir"] / "plain.npz")
    for n, p in model.named_parameters():
        assert np.abs(plain[n] - p.detach().numpy()).max() < 1e-4, n


def test_a_pod_axis_of_one_is_bitwise_the_stacked_form(runs):
    """(f) The step on a (1, 1, 1) mesh (a process group of one on an
    in-process store) equals the stacked form with one pod bit for bit:
    losses, parameters and residuals, two steps."""
    cfg = _cfg("olmo-1b")
    opt_cfg = AdamWConfig(**OPT)
    batches = [{k: torch.from_numpy(v) for k, v in
                _load(runs["dir"] / f"batch_parity_{i}.npz").items()}
               for i in range(2)]

    def fresh():
        return params_from_numpy(nest(_weights(runs, "olmo-1b")), cfg,
                                 device="cpu")

    def steps(model, err, step, batch_of):
        state = init_opt_state(param_tree(model), opt_cfg)
        losses = []
        for b in batches:
            model, state, err, m = step(model, state, err, batch_of(b))
            losses.append(float(m["loss"]))
        return model, err, losses

    stacked, s_err, s_losses = steps(
        fresh(), init_error_state(param_tree(fresh()), 1),
        make_compressed_train_step(cfg, opt_cfg), lambda b: b)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
        model = fresh()
        shard_model(model, mesh, fsdp=False)
        model, err, losses = steps(
            model, init_error_state(param_tree(model), 1, mesh),
            make_compressed_train_step(cfg, opt_cfg, mesh),
            lambda b: {k: distribute(v, mesh, batch_sharding(mesh))
                       for k, v in b.items()})
        assert losses == s_losses
        for (n, p), q in zip(model.named_parameters(), stacked.parameters()):
            assert torch.equal(p.full_tensor(), q), n
        for (k, e), (_, f) in zip(tree_items(err), tree_items(s_err)):
            assert torch.equal(e.full_tensor(), f), k
    finally:
        dist.destroy_process_group()


def test_planted_faults_miss_the_bounds(runs):
    """(g) The pod all-reduce dropped (each pod keeps its own mean) and a
    per-shard scale miss (b)'s bounds; the token share summed over
    (pod, data) misses (d)'s; (a)'s are in the leaf-stage test."""
    for tag in ("pod_dropped", "shard_scale"):
        assert _step_misses(runs, tag, "parity", 0) != [], tag
    assert _metrics_misses(runs["ranks"][0]["metrics"]["share"][0],
                           runs["jax"]["metrics"]["uneven"][0]) != []


@pytest.mark.parametrize("arch,kind", [("internvl2-26b", RuntimeError),
                                       ("whisper-medium", ValueError)])
def test_a_dropped_frontend_raises(runs, arch, kind, monkeypatch):
    """(g) With the frontend rows dropped before each pod's gradient, the
    step raises on every rank and in the stacked form, as the fault did:
    whisper's encoder has nothing to encode, internvl2's frontend
    projection drops out of the graph."""
    for r in runs["ranks"]:
        assert r["raised"][arch][0] == kind.__name__, r["raised"]
    grads_of = compression.value_and_grad
    monkeypatch.setattr(
        compression, "value_and_grad",
        lambda *a, frontend_embeds=None, **kw: grads_of(*a, **kw))
    with pytest.raises(kind):
        _stacked_step(runs, arch)
