"""The port's distribution layer against the JAX package's.

``parallel/sharding.py``'s placements are held, leaf for leaf, to the JAX
``PartitionSpec``s on (2, 2) and (2, 2, 2) meshes: the JAX side runs in a
subprocess with eight forced host devices (as ``tests/test_distribution.py``
does), the port's on ``DeviceMesh`` objects built without a process group
over meta-device parameters, so full-size configs cost no memory.  The
int8 error-feedback leaf math is held bit for bit to the JAX
``compressed_psum_pod`` under a ``vmap`` over the pod axis.  The
data-parallel step on DTensor parameters runs on four CPU processes over
gloo (a 2 data x 2 model mesh) against the single-process step: loss
within 1e-5 and parameters within 1e-4, the bounds of
``tests/test_distribution.py``.  Every subprocess has a time limit and the
process group's store is a file under ``tmp_path``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro.parallel.compression import compressed_psum_pod as jpsum_pod
from repro.parallel.compression import quantize_int8 as jquantize
from repro_torch import configs
from repro_torch.convert import param_tree, params_to_numpy, tree_items
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.launch.train import train
from repro_torch.models.model import LM, init_model, logical_axes
from repro_torch.parallel.compression import (compress_stacked,
                                              compressed_psum_pod,
                                              error_state_placements,
                                              init_error_state,
                                              make_compressed_train_step,
                                              quantize_int8)
from repro_torch.parallel.sharding import (batch_sharding,
                                           block_compute_shardings,
                                           distribute, shard_model,
                                           shardings_for_tree, spec_for)
from repro_torch.train.data import DataConfig, batch_at_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

REPO = Path(__file__).resolve().parents[1]
ARCHS = tuple(sorted(configs.ARCHS))       # all 10, every family
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SUBPROCESS_S = 600


def _run(script: str, env_extra: dict) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env_extra)
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True,
                          timeout=SUBPROCESS_S)


@pytest.fixture(scope="module")
def jax_specs():
    """{arch|reduced: {mesh: {"fsdp"/"nofsdp"/"blocks": {path: spec},
    "report": [...], "batch": spec}}} from the JAX package."""
    script = textwrap.dedent("""
        import json, jax
        from repro.configs import ARCHS, reduced_config
        from repro.launch.mesh import make_mesh
        from repro.models.model import init_model
        from repro.parallel.sharding import (batch_sharding,
            block_compute_shardings, shardings_for_tree)
        def spec(s):
            return [list(p) if isinstance(p, tuple) else p for p in s.spec]
        def flat(tree):
            return {"/".join(str(getattr(k, "key", k)) for k in path):
                    spec(leaf) for path, leaf in
                    jax.tree_util.tree_flatten_with_path(tree)[0]}
        out = {}
        for arch in %r:
            for name, cfg in ((arch, ARCHS[arch]),
                              (arch + "|reduced", reduced_config(ARCHS[arch]))):
                sds = jax.eval_shape(
                    lambda: init_model(jax.random.PRNGKey(0), cfg)[0])
                _, axes = init_model(jax.random.PRNGKey(0),
                                     reduced_config(ARCHS[arch]))
                out[name] = {}
                for mname, (shape, names) in %r.items():
                    mesh = make_mesh(shape, names)
                    report = []
                    out[name][mname] = {
                        "fsdp": flat(shardings_for_tree(
                            sds, axes, mesh, fsdp=True, report=report)),
                        "nofsdp": flat(shardings_for_tree(
                            sds, axes, mesh, fsdp=False)),
                        "blocks": flat(block_compute_shardings(
                            sds["blocks"], axes["blocks"], mesh)),
                        "report": [[l, s, list(r) if isinstance(r, tuple)
                                    else r] for l, s, r in report],
                        "batch": spec(batch_sharding(mesh))}
        print("RESULT " + json.dumps(out))
    """ % (ARCHS, MESHES))
    proc = _run(script, {"XLA_FLAGS":
                         "--xla_force_host_platform_device_count=8",
                         "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _mesh(name) -> DeviceMesh:
    shape, names = MESHES[name]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).view(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def _as_spec(placements, mesh, ndim):
    """Placements -> the PartitionSpec entries (per tensor dim: None, an
    axis name, or the list of axis names, outer first)."""
    out = []
    for d in range(ndim):
        axes = [n for n, p in zip(mesh.mesh_dim_names, placements)
                if isinstance(p, Shard) and p.dim == d]
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:      # PartitionSpec drops trailing Nones
        out.pop()
    return out


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def _port_cfg(name):
    arch, _, reduced = name.partition("|")
    cfg = configs.ARCHS[arch]
    return configs.reduced_config(cfg) if reduced else cfg


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", [a + s for a in ARCHS
                                  for s in ("", "|reduced")])
def test_spec_for_matches_jax_partition_specs(jax_specs, name, mesh_name):
    """Every leaf's placements, with and without fsdp, the per-layer compute
    placements and the replicated-dimension report equal the JAX specs."""
    cfg = _port_cfg(name)
    mesh = _mesh(mesh_name)
    params = param_tree(LM(cfg, torch.device("meta")))
    axes = logical_axes(cfg)
    want = jax_specs[name][mesh_name]
    report = []
    got = {"fsdp": shardings_for_tree(params, axes, mesh, fsdp=True,
                                      report=report),
           "nofsdp": shardings_for_tree(params, axes, mesh, fsdp=False),
           "blocks": block_compute_shardings(params["blocks"],
                                             axes["blocks"], mesh)}
    for kind, tree in got.items():
        src = params["blocks"] if kind == "blocks" else params
        flat = {"/".join(path): _as_spec(pl, mesh, _leaf(src, path).ndim
                                         - (kind == "blocks"))
                for path, pl in tree_items(tree)}
        assert flat == {k: _strip(v) for k, v in want[kind].items()}, kind
    assert [[lg, s, list(r) if isinstance(r, tuple) else r]
            for lg, s, r in report] == want["report"]
    assert _as_spec(batch_sharding(mesh), mesh, 2) == _strip(want["batch"])


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_spec_for_replicates_what_does_not_divide_and_uses_an_axis_once():
    mesh = _mesh("2x2x2")
    report = []
    # 25 heads on a 2-way model axis replicate and are reported, which
    # leaves the model axis to the next "heads" dimension; "mlp" cannot
    # reuse it.
    pl = spec_for((8, 25, 4, 4), ("embed", "heads", "heads", "mlp"), mesh,
                  report=report)
    assert _as_spec(pl, mesh, 4) == [["pod", "data"], None, "model"]
    assert report == [("heads", 25, "model")]
    assert _as_spec(spec_for((6,), ("embed",), mesh, fsdp=False),
                    mesh, 1) == []


def test_logical_axes_equal_the_jax_init_axes():
    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced_config as jreduced
    from repro.models.model import init_model as jinit
    for arch in ARCHS:
        _, jaxes = jinit(jax.random.PRNGKey(0), jreduced(JARCHS[arch]))
        assert logical_axes(configs.reduced_config(configs.ARCHS[arch])) \
            == jaxes


def test_production_mesh_spec_is_pure():
    assert production_mesh_spec() == ((16, 16), ("data", "model"))
    shape, axes = production_mesh_spec(multi_pod=True)
    assert axes == ("pod", "data", "model") and np.prod(shape) == 512


# ------------------------------------------------ int8 error feedback

@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 4, 6)])
def test_int8_error_feedback_leaf_math_bit_equal_to_jax(shape):
    """The stacked reduction over 2 pods against the JAX
    ``compressed_psum_pod`` under ``vmap(axis_name="pod")``: the mean and
    each pod's new residual equal bit for bit; one pod alone against the
    port's single-pod ``compressed_psum_pod``."""
    rng = np.random.default_rng(len(shape))
    g = rng.normal(size=(2,) + shape).astype(np.float32)
    e = (rng.normal(size=(2,) + shape) * 1e-3).astype(np.float32)
    jmean, jerr = jax.vmap(jpsum_pod, axis_name="pod")(jnp.asarray(g),
                                                        jnp.asarray(e))
    mean, err = compress_stacked(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean)[0])
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean)[1])
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    jm1, je1 = jax.vmap(jpsum_pod, axis_name="pod")(jnp.asarray(g[:1]),
                                                    jnp.asarray(e[:1]))
    m1, e1 = compressed_psum_pod(torch.from_numpy(g[0]),
                                 torch.from_numpy(e[0]))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm1)[0])
    np.testing.assert_array_equal(e1.numpy(), np.asarray(je1)[0])
    x = rng.normal(size=shape).astype(np.float32) * 40
    np.testing.assert_array_equal(
        quantize_int8(torch.from_numpy(x), 0.25).numpy(),
        np.asarray(jquantize(jnp.asarray(x), 0.25)))


def test_compressed_step_converges_and_tracks_the_exact_step():
    """The configuration and bounds of the JAX
    ``test_pod_compressed_allreduce_converges``: 2 pods, 15 steps."""
    cfg = dataclasses.replace(configs.reduced_config(configs.ARCHS["olmo-1b"]),
                              dtype="float32", remat="none", fsdp=False)
    opt_cfg = AdamWConfig(lr=5e-3, warmup_steps=1)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
                      seed=1)
    mc = init_model(cfg, seed=0, device="cpu")
    mr = init_model(cfg, seed=0, device="cpu")
    oc = init_opt_state(param_tree(mc), opt_cfg)
    orr = init_opt_state(param_tree(mr), opt_cfg)
    err = init_error_state(param_tree(mc), n_pods=2)
    step_c = make_compressed_train_step(cfg, opt_cfg)
    step_r = make_train_step(cfg, opt_cfg)
    losses, ref = [], []
    for s in range(15):
        batch = batch_at_step(data, s, device="cpu")
        mc, oc, err, m = step_c(mc, oc, err, batch)
        mr, orr, r = step_r(mr, orr, batch)
        losses.append(float(m["loss"]))
        ref.append(float(r["loss"]))
    assert losses[-1] < losses[0] - 0.2
    assert abs(losses[-1] - ref[-1]) < 0.15
    assert all(float(t.abs().max()) > 0 for _, t in tree_items(err))


# ------------------------------------------- data parallel on DTensors

DP_SCRIPT = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch import configs
    from repro_torch.convert import param_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_model
    from repro_torch.launch.train import train
    from repro_torch.parallel.sharding import (batch_sharding, constrain,
                                               distribute, shard_model)
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.data import DataConfig, batch_at_step
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    cfg = dataclasses.replace(
        configs.reduced_config(configs.ARCHS["granite-3-8b"]),
        dtype="float32", remat="none")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    model = init_model(cfg, seed=0, device="cpu")
    shard_model(model, mesh, fsdp=cfg.fsdp)
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = init_opt_state(param_tree(model), opt_cfg)
    batch = batch_at_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=8, seed=0), 0, device="cpu")
    batch = {k: distribute(v, mesh, batch_sharding(mesh))
             for k, v in batch.items()}
    model, opt, m = make_train_step(cfg, opt_cfg)(model, opt, batch)
    full = {n: p.full_tensor().numpy() for n, p in model.named_parameters()}
    local = {n: p.to_local().shape for n, p in model.named_parameters()}
    save_checkpoint(out + "/ckpt", 1, param_tree(model), opt)
    dist.barrier()
    fresh = init_model(cfg, seed=5, device="cpu")
    shard_model(fresh, mesh, fsdp=cfg.fsdp)
    fopt = init_opt_state(param_tree(fresh), opt_cfg)
    step, _, fopt = load_checkpoint(out + "/ckpt", param_tree(fresh), fopt)
    same = step == 1 and all(
        torch.equal(p.to_local(), q.to_local()) for p, q in
        zip(model.parameters(), fresh.parameters())) and int(fopt["step"]) == 1
    whole = constrain(batch["tokens"], mesh, None, None)
    again = constrain(whole, mesh, "batch", None)
    constrained = [list(whole.to_local().shape), list(again.to_local().shape)]
    run = train("granite-3-8b", steps=2, batch=8, seq_len=16, mesh=mesh,
                verbose=False)
    if rank == 0:
        np.savez(out + "/params.npz", **full)
        json.dump({"loss": float(m["loss"]), "reloaded": bool(same),
                   "wq_local": list(local["blocks.attn.wq"]),
                   "embed_local": list(local["embed"]),
                   "constrained": constrained, "train": run.losses},
                  open(out + "/result.json", "w"))
    dist.destroy_process_group()
""")


def test_data_parallel_step_on_4_processes_matches_the_single_process_step(
        tmp_path):
    """A (2 data x 2 model) DTensor step on four gloo processes equals the
    single-process step; the sharded checkpoint reloads onto fresh sharded
    parameters bit for bit; ``constrain`` replicates and re-shards the
    batch; ``train(mesh=...)`` (bf16, remat ``block``) tracks the
    single-process ``train`` within 2e-2 over two steps (bf16 products
    of half batches round otherwise than of the whole)."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", DP_SCRIPT, str(r),
                               str(store), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    try:
        errs = [p.communicate(timeout=SUBPROCESS_S)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    got = json.loads((tmp_path / "result.json").read_text())
    cfg = dataclasses.replace(
        configs.reduced_config(configs.ARCHS["granite-3-8b"]),
        dtype="float32", remat="none")
    model = init_model(cfg, seed=0, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3)
    opt = init_opt_state(param_tree(model), opt_cfg)
    batch = batch_at_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=8, seed=0), 0, device="cpu")
    model, _, m = make_train_step(cfg, opt_cfg)(model, opt, batch)
    assert abs(float(m["loss"]) - got["loss"]) < 1e-5
    with np.load(tmp_path / "params.npz") as z:
        for path, want in tree_items(params_to_numpy(model)):
            assert np.abs(z[".".join(path)] - want).max() < 1e-4, path
    assert got["reloaded"]
    # wq (L, d, H, hd): d over data (fsdp), heads over model
    L, d, h, hd = model.blocks.attn.wq.shape
    assert got["wq_local"] == [L, d // 2, h // 2, hd]
    assert got["embed_local"] == [model.embed.shape[0] // 2,
                                  model.embed.shape[1] // 2]
    assert got["constrained"] == [[8, 16], [4, 16]]
    single = train("granite-3-8b", steps=2, batch=8, seq_len=16,
                   verbose=False, device="cpu")
    assert np.abs(np.subtract(got["train"], single.losses)).max() < 2e-2


def _world_of_one_equals_the_plain_step(make) -> None:
    """The DTensor step on the mesh ``make()`` returns (a process group of
    one on an in-process store) equals the plain step bit for bit."""
    assert not dist.is_initialized()
    cfg = dataclasses.replace(configs.reduced_config(configs.ARCHS["qwen3-4b"]),
                              dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    batch = batch_at_step(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=4, seed=0), 0, device="cpu")
    plain = init_model(cfg, seed=0, device="cpu")
    plain, _, m = make_train_step(cfg, opt_cfg)(
        plain, init_opt_state(param_tree(plain), opt_cfg), batch)
    try:
        mesh = make()
        assert mesh.size() == 1
        model = init_model(cfg, seed=0, device="cpu")
        shard_model(model, mesh, fsdp=cfg.fsdp)
        sharded = {k: distribute(v, mesh, batch_sharding(mesh))
                   for k, v in batch.items()}
        model, _, ms = make_train_step(cfg, opt_cfg)(
            model, init_opt_state(param_tree(model), opt_cfg), sharded)
        assert float(ms["loss"]) == float(m["loss"])
        for (n, p), q in zip(model.named_parameters(), plain.parameters()):
            assert torch.equal(p.full_tensor(), q), n
    finally:
        dist.destroy_process_group()


def test_host_mesh_step_equals_the_plain_step():
    """``make_host_mesh`` (a process group of one on an in-process store):
    the DTensor step on the (1, 1) mesh equals the plain step bit for
    bit."""
    from repro_torch.launch.mesh import make_host_mesh

    def host_mesh():
        mesh = make_host_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        return mesh
    _world_of_one_equals_the_plain_step(host_mesh)


# ------------------------------------ the compressed step on a pod mesh

def _pod_world_model(arch, fsdp):
    """A meta-device model of ``arch`` (full size) sharded over a (2, 2, 2)
    ``("pod", "data", "model")`` mesh of the running ``fake`` group."""
    mesh = DeviceMesh("cpu", torch.arange(8).view(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    model = LM(configs.ARCHS[arch], torch.device("meta"))
    shard_model(model, mesh, fsdp=fsdp)
    return mesh, model


def test_compressed_step_refuses_a_mesh_without_a_pod_axis():
    cfg = configs.reduced_config(configs.ARCHS["olmo-1b"])
    with pytest.raises(ValueError, match="'pod' mesh axis"):
        make_compressed_train_step(cfg, AdamWConfig(), _mesh("2x2"))


def test_compressed_step_refuses_parameters_split_over_pods():
    """``fsdp=True`` splits the embed dimensions over (pod, data): the
    step, the residual placements and the residuals refuse it."""
    cfg = configs.ARCHS["olmo-1b"]
    with fake_world(8):
        mesh, model = _pod_world_model("olmo-1b", fsdp=True)
        step = make_compressed_train_step(cfg, AdamWConfig(), mesh)
        with pytest.raises(ValueError, match="replicated over 'pod'"):
            step(model, {}, {}, {})
        with pytest.raises(ValueError, match="replicated over 'pod'"):
            error_state_placements(model, mesh)
        with pytest.raises(ValueError, match="replicated over 'pod'"):
            init_error_state(param_tree(model), 2, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_error_state_placements_follow_each_parameter(arch):
    """Each residual leaf ``(2, *shape)`` is ``Shard(0)`` over pod,
    ``Replicate`` over data, and its parameter's model split moved up one
    dimension; ``init_error_state`` places zeros so, each rank holding its
    pod's row of its parameter's local shard."""
    with fake_world(8):
        mesh, model = _pod_world_model(arch, fsdp=False)
        params = param_tree(model)
        placements = error_state_placements(model, mesh)
        err = init_error_state(params, 2, mesh)
        for (path, p), (_, pl), (_, e) in zip(tree_items(params),
                                              tree_items(placements),
                                              tree_items(err)):
            pod, data, mod = p.placements
            assert pod == Replicate() and data == Replicate(), path
            want_model = Shard(mod.dim + 1) if isinstance(mod, Shard) \
                else Replicate()
            assert pl == (Shard(0), Replicate(), want_model), path
            assert e.placements == pl and e.shape == (2,) + p.shape, path
            assert e.to_local().shape == (1,) + p.to_local().shape, path


def test_the_compressed_plan_leaves_pods_unsummed():
    """The plain sharded step's plan sums each whole parameter's gradient
    over pod and data (the whole batch's mean, as before the compressed
    step existed); the compressed step's plan (``mean_axes=("data",)``)
    over data only, leaving the cross-pod leg to the int8 stage."""
    from repro_torch.parallel.tensor_parallel import TensorParallel
    with fake_world(8):
        mesh, model = _pod_world_model("olmo-1b", fsdp=False)
        placements = {n: p.placements for n, p in model.named_parameters()}
        plain = TensorParallel.of(mesh, placements)
        pods = TensorParallel.of(mesh, placements, mean_axes=("data",))
        for name in placements:
            assert [a.group for a in plain.unsplit[name]] == [
                mesh.get_group(a).group_name for a in ("pod", "data")]
            assert [a.group for a in pods.unsplit[name]] == [
                mesh.get_group("data").group_name]
            assert plain.gathers[name] == pods.gathers[name] == ()


def test_pod_mesh_world_of_one_plain_step_equals_the_plain_step():
    """The plain sharded step on a (1, 1, 1) ``("pod", "data", "model")``
    mesh of one process equals the plain one-device step bit for bit, as
    on the (1, 1) host mesh."""
    from repro_torch.launch.mesh import make_mesh

    def pod_mesh():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        return make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    _world_of_one_equals_the_plain_step(pod_mesh)
