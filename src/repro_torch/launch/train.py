"""End-to-end training entry point.

Reduced configs run on the CPU (``--device cpu``) or the card; the full
configs (``--full``) on the card.  Every training feature — data stream,
train step, checkpoints, straggler watchdog, crash restart, and with a
mesh the sharded parameters — goes through this one loop.

  python -m repro_torch.launch.train --arch olmo-1b --steps 50
  python -m repro_torch.launch.train --arch olmo-1b --steps 5 --full --batch 8 --seq-len 512
  python -m repro_torch.launch.train --arch olmo-1b --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import param_tree
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_model
from repro_torch.parallel.sharding import batch_sharding, distribute, shard_model
from repro_torch.train.checkpoint import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import DataConfig, batch_at_step
from repro_torch.train.ft import FailureInjector, StragglerWatchdog
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainRun:
    losses: list
    steps_run: int
    resumed_from: int
    straggler_events: int
    step_s: list            # wall seconds of each step, data included


def train(arch: str | ModelConfig, *, steps: int = 50, reduced: bool = True,
          batch: int = 8, seq_len: int = 64, lr: float = 3e-3,
          ckpt_root: str | Path | None = None, ckpt_every: int = 20,
          crash_at: int | None = None, mesh=None, seed: int = 0,
          log_every: int = 10, verbose: bool = True,
          device=None) -> TrainRun:
    """Train ``arch`` (a config name, reduced unless ``reduced=False``, or a
    ``ModelConfig`` used as given) from random weights drawn from
    ``seed``, on ``device`` (the card by default).  With ``ckpt_root`` it
    saves every ``ckpt_every`` steps and resumes from the latest
    checkpoint there; ``crash_at`` raises at that step once.  ``mesh`` (a
    DeviceMesh with ``data``/``model`` axes, and ``pod``) shards the
    parameters, moments and batch over it; its device type is the
    device, and every rank runs this function.  The step then computes
    tensor-parallel over ``model`` and gathers each layer's FSDP split
    over the data axes just before use (``train/train_step.py``): the
    cases where the JAX launcher builds ``block_specs`` (``cfg.fsdp``, more
    than one device), and with no FSDP split the same program without
    gathers.  hymba's mamba heads and the xLSTM blocks, which the JAX
    launcher leaves to GSPMD, are gathered whole and run replicated."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if reduced and not isinstance(arch, ModelConfig):
        cfg = reduced_config(cfg)
    if mesh is not None:
        device = ("cpu" if mesh.device_type == "cpu" else
                  torch.device("cuda", torch.cuda.current_device()))
    device = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          moment_dtype=cfg.optimizer_dtype)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=batch, seed=seed)

    model = init_model(cfg, seed=seed, device=device)
    if mesh is not None:
        shard_model(model, mesh, fsdp=cfg.fsdp)
    params = param_tree(model)
    opt_state = init_opt_state(params, opt_cfg)

    start_step = 0
    if ckpt_root is not None:
        last = latest_step(ckpt_root)
        if last is not None:
            start_step, params, opt_state = load_checkpoint(last, params,
                                                            opt_state)
            if verbose:
                print(f"[train] resumed from {last} (step {start_step})")

    step_fn = make_train_step(cfg, opt_cfg)
    watchdog = StragglerWatchdog()
    injector = FailureInjector(crash_at)
    losses = []

    for step in range(start_step, steps):
        watchdog.start_step(step)
        batch_data = batch_at_step(data_cfg, step, device=device)
        if mesh is not None:
            batch_data = {k: distribute(v, mesh, batch_sharding(mesh))
                          for k, v in batch_data.items()}
        injector.maybe_crash(step)
        model, opt_state, metrics = step_fn(model, opt_state, batch_data)
        loss = float(metrics["loss"])
        losses.append(loss)
        ev = watchdog.end_step()
        if ev and verbose:
            print(f"[train] straggler: step {ev.step} "
                  f"{ev.slowdown:.1f}x median")
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if ckpt_root is not None and (step + 1) % ckpt_every == 0:
            save_checkpoint(Path(ckpt_root) / f"step_{step + 1}", step + 1,
                            params, opt_state, config_name=cfg.name)
    return TrainRun(losses=losses, steps_run=len(losses),
                    resumed_from=start_step,
                    straggler_events=len(watchdog.events),
                    step_s=list(watchdog.durations))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="the full config instead of the reduced one")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    run = train(args.arch, steps=args.steps, reduced=not args.full,
                batch=args.batch, seq_len=args.seq_len, ckpt_root=args.ckpt,
                device=args.device)
    print(f"[train] done: {run.steps_run} steps, "
          f"loss {run.losses[0]:.3f} -> {run.losses[-1]:.3f}")


if __name__ == "__main__":
    main()
