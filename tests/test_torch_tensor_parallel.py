"""The port's tensor-parallel training step against the JAX package's
sharded step and against its own single-process step.

Each reduced config (float32, remat ``none``) takes one step from the same
weights (drawn by the port, carried to JAX through numpy) and the same
batch on a (2 data x 2 model) and a (1 data x 4 model) mesh.  The port's
step runs on four CPU processes over gloo, each computing its own heads,
MLP columns, experts and vocabulary rows; the JAX step is
``make_train_step(block_specs=...)`` jitted over four forced host devices
with the sharding trees of ``launch/train.py``, in a subprocess.  Loss
within 1e-5 and parameters within 1e-4 of both references, the bounds of
``tests/test_distribution.py``; the optimizer (``OPT``) makes the step
move each parameter by the size of its gradient, and the gradient norm
and each leaf's update are held at relative bounds too.  A planted fault
(``copy_to``'s backward all-reduce dropped) shows that these bounds catch
a wrong backward.  The (1 x 4) mesh splits the reduced configs' 4 q heads
but not hymba's and qwen3's 2 kv heads (replicated kv).  The ranks also
record the local shapes their layers see, round-trip a sharded
checkpoint, resume a crashed run bitwise under deterministic algorithms,
and count one step beside the dry run's meta trace of the same rank of a
(2, 2) ``fake`` world.  Every subprocess has a time limit and the process
group's store is a file under ``tmp_path``; the fixture waits for them
all and names every one that failed or hung, with its exit code and the
tail of its stderr.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import (nest, param_tree, params_from_numpy,
                                 params_to_numpy, tree_items)
from repro_torch.models.model import init_model
from repro_torch.train.data import DataConfig, batch_at_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "qwen3-4b", "mixtral-8x22b", "kimi-k2-1t-a32b",
         "whisper-medium", "internvl2-26b", "olmo-1b", "hymba-1.5b",
         "xlstm-350m")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
CASES = [(a, m) for a in ARCHS for m in MESHES]
BATCH, SEQ = 8, 16
# AdamW's first step with eps far above every gradient entry and no warmup
# or decay moves each parameter by lr * g / (|g| + eps): the gradient's own
# size, not only its sign, so the parameters after one step hold the
# gradient to the references.
OPT = dict(lr=1.0, eps=1.0, warmup_steps=1, weight_decay=0.0)
UPDATE_REL = 1e-3       # of each leaf's largest update, float32 sums
FAULT_ARCH = "granite-3-8b"
SUBPROCESS_S = 600
RESUME_ARCH = "mixtral-8x22b"      # bf16, remat block, MoE routing


def _cfg(arch):
    return dataclasses.replace(configs.reduced_config(configs.ARCHS[arch]),
                               dtype="float32", remat="none")


def _frontend(cfg, seed=0):
    if cfg.frontend is None:
        return None
    n = cfg.frontend_tokens if cfg.frontend == "vision_stub" \
        else cfg.encoder_seq
    return np.random.default_rng(seed).normal(
        size=(BATCH, n, cfg.d_model)).astype(np.float32)


JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import ARCHS, reduced_config
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import param_specs
    from repro.models.model import init_model
    from repro.parallel.sharding import (batch_sharding,
        block_compute_shardings, replicated, shardings_for_tree)
    from repro.train.data import DataConfig, batch_at_step
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import make_train_step
    out, archs, meshes = sys.argv[1], sys.argv[2].split(","), json.loads(
        sys.argv[3])

    def name(path):
        return ".".join(str(getattr(k, "key", k)) for k in path)

    res = {}
    for arch in archs:
        cfg = dataclasses.replace(reduced_config(ARCHS[arch]),
                                  dtype="float32", remat="none")
        # the init tree's structure (olmo's empty norms too), the leaves
        # the port's
        params, axes = init_model(jax.random.PRNGKey(0), cfg)
        with np.load(f"{out}/weights_{arch}.npz") as z:
            params = jax.tree_util.tree_map_with_path(
                lambda path, _: jnp.asarray(z[name(path)]), params)
        batch = batch_at_step(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=%(seq)d,
                                         global_batch=%(batch)d, seed=0), 0)
        if cfg.frontend is not None:
            batch["frontend"] = jnp.asarray(
                np.load(f"{out}/frontend_{arch}.npy"))
        opt_cfg = AdamWConfig(**%(opt)r)
        for mname, shape in meshes.items():
            mesh = make_mesh(tuple(shape), ("data", "model"))
            p_sh = shardings_for_tree(params, axes, mesh, fsdp=cfg.fsdp)
            o_sh = {"m": p_sh, "v": p_sh, "step": replicated(mesh)}
            b_sh = {k: batch_sharding(mesh) for k in batch}
            # launch/train.py's block_specs (none for the xLSTM stack)
            block_specs = None
            if cfg.family != "ssm":
                sds, ax = param_specs(cfg)
                block_specs = block_compute_shardings(
                    sds["blocks"], ax["blocks"], mesh)
            step = jax.jit(make_train_step(cfg, opt_cfg,
                                           block_specs=block_specs),
                           in_shardings=(p_sh, o_sh, b_sh))
            with mesh:
                p, _, m = step(jax.device_put(params, p_sh),
                               jax.device_put(init_opt_state(params,
                                                             opt_cfg), o_sh),
                               jax.device_put(batch, b_sh))
            flat = {name(path): np.asarray(leaf) for path, leaf in
                    jax.tree_util.tree_flatten_with_path(p)[0]}
            np.savez(f"{out}/jax_{mname}_{arch}.npz", **flat)
            res[f"{arch}|{mname}"] = [float(m["loss"]),
                                      float(m["grad_norm"])]
    print("RESULT " + json.dumps({"loss": res,
                                  "n_dev": jax.device_count()}))
""") % {"seq": SEQ, "batch": BATCH, "opt": OPT}


RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import configs
    from repro_torch.convert import nest, param_tree, params_from_numpy
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.trace_analysis import count
    from repro_torch.launch.train import train
    from repro_torch.models import model as mm
    from repro_torch.models.layers import plain_attention
    from repro_torch.models.model import init_model
    from repro_torch.parallel import tensor_parallel
    from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                               shard_model)
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.data import DataConfig, batch_at_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    rank, store, out, mname = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
    shape = tuple(json.loads(sys.argv[5]))
    archs, resume_arch, fault_arch = (sys.argv[6].split(","), sys.argv[7],
                                      sys.argv[8])
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=4,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(shape, ("data", "model"), "cpu")

    seen = {}
    def record(key, fn, shapes):
        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            seen.setdefault(key, shapes(res, *a))
            return res
        return wrapped
    fa_ops.attention_ref = record(
        "attn", fa_ops.attention_ref,
        lambda r, q, k, v: [list(q.shape), list(k.shape)])
    mm.apply_mlp = record("mlp", mm.apply_mlp,
                          lambda r, p, x, tp=None: list(p["wo"].shape))
    mm.apply_moe = record("moe", mm.apply_moe, lambda r, p, *a, **kw: [
        list(p["router"].shape), list(p["w_gate"].shape)])
    mm._final_logits = record("logits", mm._final_logits,
                              lambda r, *a: list(r.shape))
    mm.apply_mamba = record("mamba", mm.apply_mamba, lambda r, p, *a, **kw:
                            [list(p["in_proj"].shape),
                             list(p["conv_w"].shape)])
    mm.apply_mlstm = record("mlstm", mm.apply_mlstm, lambda r, p, *a, **kw:
                            list(p["wqkv"].shape))
    mm.apply_slstm = record("slstm", mm.apply_slstm, lambda r, p, *a, **kw:
                            list(p["wx"].shape))

    def cfg_of(arch):
        return dataclasses.replace(
            configs.reduced_config(configs.ARCHS[arch]), dtype="float32",
            remat="none")

    def sharded(arch, seed=None):
        cfg = cfg_of(arch)
        if seed is None:
            with np.load(f"{out}/weights_{arch}.npz") as z:
                model = params_from_numpy(nest(dict(z)), cfg, device="cpu")
        else:
            model = init_model(cfg, seed=seed, device="cpu")
        shard_model(model, mesh, fsdp=cfg.fsdp)
        return cfg, model

    def batch_of(cfg, arch):
        b = batch_at_step(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=%(seq)d, global_batch=%(batch)d,
                                     seed=0), 0, device="cpu")
        if cfg.frontend is not None:
            b["frontend"] = torch.from_numpy(
                np.load(f"{out}/frontend_{arch}.npy"))
        return {k: distribute(v, mesh, batch_sharding(mesh))
                for k, v in b.items()}

    res = {"loss": {}, "local": {}}
    opt_cfg = AdamWConfig(**%(opt)r)

    def one_step(arch, tag):
        cfg, model = sharded(arch)
        opt = init_opt_state(param_tree(model), opt_cfg)
        seen.clear()
        model, opt, m = make_train_step(cfg, opt_cfg)(model, opt,
                                                      batch_of(cfg, arch))
        res["loss"][tag] = [float(m["loss"]), float(m["grad_norm"])]
        full = {n: p.full_tensor().numpy()
                for n, p in model.named_parameters()}
        if rank == 0:
            np.savez(f"{out}/{tag}_{mname}.npz", **full)
        return model, opt

    for arch in archs:
        model, opt = one_step(arch, arch)
        res["local"][arch] = dict(seen)
        if arch == "qwen3-4b":          # the sharded checkpoint, both ways
            save_checkpoint(f"{out}/ckpt_{mname}", 1, param_tree(model), opt)
            dist.barrier()
            _, fresh = sharded(arch, seed=5)
            fopt = init_opt_state(param_tree(fresh), opt_cfg)
            step, _, fopt = load_checkpoint(f"{out}/ckpt_{mname}",
                                            param_tree(fresh), fopt)
            res["reloaded"] = step == 1 and int(fopt["step"]) == 1 and all(
                torch.equal(p.to_local(), q.to_local()) for p, q in
                zip(model.parameters(), fresh.parameters())) and all(
                torch.equal(a.to_local(), b.to_local()) for a, b in zip(
                    [*opt["m"]["blocks"]["attn"].values()],
                    [*fopt["m"]["blocks"]["attn"].values()]))

    # A planted fault: copy_to's backward all-reduce dropped, so each
    # model-axis rank keeps its partial gradient of a replicated input.
    right = tensor_parallel._CopyTo.backward
    tensor_parallel._CopyTo.backward = staticmethod(lambda ctx, g: (g, None))
    one_step(fault_arch, "fault")
    tensor_parallel._CopyTo.backward = right

    # Crash and bitwise resume (bf16, remat block, deterministic).
    torch.use_deterministic_algorithms(True)
    kw = dict(steps=4, batch=%(batch)d, seq_len=%(seq)d, mesh=mesh,
              ckpt_every=2, verbose=False)
    straight = train(resume_arch, ckpt_root=f"{out}/run_a_{mname}", **kw)
    try:
        train(resume_arch, ckpt_root=f"{out}/run_b_{mname}", crash_at=3,
              **kw)
        res["crashed"] = False
    except RuntimeError:
        res["crashed"] = True
    again = train(resume_arch, ckpt_root=f"{out}/run_b_{mname}", **kw)
    torch.use_deterministic_algorithms(False)
    res["resume"] = {"straight": straight.losses, "again": again.losses,
                     "resumed_from": again.resumed_from}

    # One step counted on this rank, the attention's plain version (the
    # CPU's) on both sides of the dry run comparison.
    cfg, model = sharded("granite-3-8b")
    opt = init_opt_state(param_tree(model), opt_cfg)
    b = batch_of(cfg, "granite-3-8b")
    step = make_train_step(cfg, opt_cfg, attention=plain_attention)
    _, counts = count(step, model, opt, b, device_type="cpu")
    res["counts"] = [list(counts.key()[:4]), counts.collective_bytes]
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0 and mname == "2x2":
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.launch.dryrun import build_step, fake_world
        from repro_torch.models.config import InputShape
        with fake_world(4):
            fmesh = DeviceMesh("cpu", torch.arange(4).view(2, 2),
                               mesh_dim_names=("data", "model"))
            cell = build_step(cfg, InputShape("t", "train", %(seq)d,
                                              %(batch)d), fmesh,
                              opt_cfg=opt_cfg, attention=plain_attention)
            _, traced = count(cell.step, *cell.inputs, device_type="meta")
        res["traced"] = [list(traced.key()[:4]), traced.collective_bytes]
    json.dump(res, open(f"{out}/rank{rank}_{mname}.json", "w"))
""") % {"seq": SEQ, "batch": BATCH, "opt": OPT}


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
    """The JAX sharded steps and the port's 4-process runs on both meshes,
    all started together; the weights and frontend batches written
    first."""
    out = tmp_path_factory.mktemp("tp")
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = init_model(cfg, seed=0, device="cpu")
        np.savez(out / f"weights_{arch}.npz", **{
            ".".join(p): a for p, a in tree_items(params_to_numpy(model))})
        fe = _frontend(cfg)
        if fe is not None:
            np.save(out / f"frontend_{arch}.npy", fe)
    # one thread a process: nine processes share the host with the other
    # test workers, and the reduced configs' products are tiny
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = {"jax": _spawn(out, "jax", [JAX_SCRIPT, str(out),
                                        ",".join(ARCHS), json.dumps(MESHES)],
                           dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS=
                                "--xla_force_host_platform_device_count=4"))}
    for mname, shape in MESHES.items():
        for r in range(4):
            procs[f"{mname}_{r}"] = _spawn(out, f"{mname}_{r}", [
                RANK_SCRIPT, str(r), str(out / f"store_{mname}"), str(out),
                mname, json.dumps(shape), ",".join(ARCHS), RESUME_ARCH,
                FAULT_ARCH], env)
    stdout = _wait_all(out, procs, SUBPROCESS_S)
    line = [ln for ln in stdout["jax"].splitlines()
            if ln.startswith("RESULT ")]
    got = {"jax": json.loads(line[-1][len("RESULT "):]), "dir": out}
    for mname in MESHES:
        got[mname] = [json.loads((out / f"rank{r}_{mname}.json").read_text())
                      for r in range(4)]
    return got


def _single(arch, out):
    """The port's single-process step from the same weights and batch:
    loss, gradient norm and parameters."""
    cfg = _cfg(arch)
    with np.load(out / f"weights_{arch}.npz") as z:
        model = params_from_numpy(nest(dict(z)), cfg, device="cpu")
    opt_cfg = AdamWConfig(**OPT)
    batch = batch_at_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                     global_batch=BATCH, seed=0), 0,
                          device="cpu")
    fe = _frontend(cfg)
    if fe is not None:
        batch["frontend"] = torch.from_numpy(fe)
    model, _, m = make_train_step(cfg, opt_cfg)(
        model, init_opt_state(param_tree(model), opt_cfg), batch)
    return [float(m["loss"]), float(m["grad_norm"])], {
        ".".join(p): a for p, a in tree_items(params_to_numpy(model))}


def _jax(runs, arch, mesh):
    with np.load(runs["dir"] / f"jax_{mesh}_{arch}.npz") as z:
        want = {k: z[k] for k in z.files}
    return runs["jax"]["loss"][f"{arch}|{mesh}"], want


def _misses(runs, tag, mesh, arch, metrics, want: dict) -> list:
    """What of the TP run ``tag`` is beyond the bounds against a
    reference's ``metrics`` (loss, gradient norm) and parameters ``want``:
    the loss past 1e-5, the gradient norm past 1e-5 of itself, a parameter
    past 1e-4, or a leaf's update (its parameter less the initial weights,
    the gradient's image) past UPDATE_REL of the leaf's largest update."""
    got = runs[mesh][0]["loss"][tag]
    out = []
    if abs(got[0] - metrics[0]) >= 1e-5:
        out.append(("loss", got[0], metrics[0]))
    if abs(got[1] - metrics[1]) > 1e-5 * metrics[1]:
        out.append(("grad_norm", got[1], metrics[1]))
    with np.load(runs["dir"] / f"weights_{arch}.npz") as z0, \
            np.load(runs["dir"] / f"{tag}_{mesh}.npz") as z:
        assert sorted(z.files) == sorted(want)
        for name, w in want.items():
            p, p0 = z[name].astype(np.float64), z0[name].astype(np.float64)
            if np.abs(p - w).max() >= 1e-4:
                out.append(("parameter", name, np.abs(p - w).max()))
            du = np.abs((p - p0) - (w - p0)).max()
            if du > UPDATE_REL * np.abs(w - p0).max() + 1e-9:
                out.append(("update", name, du, np.abs(w - p0).max()))
    return out


@pytest.mark.parametrize("arch,mesh", CASES)
def test_tp_step_equals_the_jax_sharded_step(runs, arch, mesh):
    """Loss within 1e-5, every parameter within 1e-4, and the gradient
    (its norm, and each leaf's update) within the relative bounds of
    :func:`_misses` of the JAX step with ``block_specs``, jitted over the
    same mesh."""
    assert runs["jax"]["n_dev"] == 4
    assert all(r["loss"][arch] == runs[mesh][0]["loss"][arch]
               for r in runs[mesh])
    assert _misses(runs, arch, mesh, arch, *_jax(runs, arch, mesh)) == []


@pytest.mark.parametrize("arch,mesh", CASES)
def test_tp_step_equals_the_single_process_step(runs, arch, mesh):
    """The bounds of the JAX comparison against the port's own step on
    one process."""
    assert _misses(runs, arch, mesh, arch, *_single(arch, runs["dir"])) == []


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_dropped_copy_to_all_reduce_fails_the_bounds(runs, mesh):
    """With ``copy_to``'s backward all-reduce dropped on every rank, the
    forward (the loss) still matches, and the gradient is caught against
    both references."""
    for metrics, want in (_jax(runs, FAULT_ARCH, mesh),
                          _single(FAULT_ARCH, runs["dir"])):
        missed = _misses(runs, "fault", mesh, FAULT_ARCH, metrics, want)
        kinds = {m[0] for m in missed}
        assert "loss" not in kinds
        assert {"grad_norm", "parameter", "update"} <= kinds, missed


@pytest.mark.parametrize("arch,mesh", CASES)
def test_each_rank_computes_its_own_slice(runs, arch, mesh):
    """The shapes each rank's layers see are its placements' local
    shapes: batch rows over data; q heads, MLP columns, router columns and
    experts (or expert columns), vocabulary rows over model; kv heads
    split where they divide the model axis, else the one kv head that the
    rank's q heads read; hymba's mamba channels (``in_proj``'s 2d columns
    and the conv's d) and xlstm's sLSTM columns split, and its 2 mLSTM
    heads where they divide the axis (2 x 2), else whole (1 x 4)."""
    cfg = _cfg(arch)
    n_data, n_model = MESHES[mesh]
    b = BATCH // n_data
    h = cfg.padded_heads // n_model
    kv = cfg.n_kv_heads // n_model if cfg.n_kv_heads % n_model == 0 else 1
    for r in runs[mesh]:
        local = r["local"][arch]
        assert local["logits"] == [b, SEQ, cfg.padded_vocab // n_model]
        d = cfg.d_model
        if cfg.family == "ssm":
            assert local.keys() == {"logits", "mlstm", "slstm"}, local
            heads = cfg.mlstm_heads
            if heads % n_model == 0:
                heads //= n_model
            assert local["mlstm"] == [d, 3, heads, d // cfg.mlstm_heads]
            assert local["slstm"] == [d, 4, d // n_model]
            continue
        q, k = local["attn"]
        assert (q[0], q[2], k[2]) == (b, h, kv), local
        if cfg.family == "hybrid":      # the rank's mamba channels
            assert local["mamba"] == [[d, 2 * d // n_model],
                                      [cfg.ssm_conv, d // n_model]]
        if cfg.is_moe:
            router, w_gate = local["moe"]
            assert router == [cfg.d_model, cfg.n_experts // n_model]
            e, f = cfg.n_experts, cfg.expert_d_ff
            assert w_gate == ([e, cfg.d_model, f // n_model] if cfg.moe_tp
                              else [e // n_model, cfg.d_model, f])
        else:
            assert local["mlp"] == [cfg.d_ff // n_model, cfg.d_model]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_checkpoint_round_trips_bit_for_bit(runs, mesh):
    """qwen3-4b's TP-trained shards saved, then loaded onto a model drawn
    from another seed: every local shard and moment equal, step 1."""
    assert all(r["reloaded"] for r in runs[mesh])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resumed_tp_run_is_bitwise_the_straight_run(runs, mesh):
    """Reduced mixtral-8x22b (bf16, remat block) through ``train(mesh=)``
    under ``torch.use_deterministic_algorithms``: crashed at step 3 and
    restarted from the step-2 checkpoint, its last two losses equal the
    straight run's bit for bit."""
    for r in runs[mesh]:
        res = r["resume"]
        assert r["crashed"] and res["resumed_from"] == 2
        assert res["again"] == res["straight"][2:]
        assert all(np.isfinite(res["straight"]))


def test_dry_run_trace_counts_what_a_gloo_rank_runs(runs):
    """Rank 0's meta trace in a (2, 2) ``fake`` world (``dryrun
    .build_step``) and rank 0's step on gloo count the same dot FLOPs,
    bytes, ops and collective bytes of every kind (the attention's plain
    version on both sides, as the CPU runs it)."""
    r0 = runs["2x2"][0]
    assert r0["traced"] == r0["counts"]
    coll = r0["counts"][1]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0
