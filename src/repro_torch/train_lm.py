"""End-to-end training: data pipeline -> train step -> checkpoints
-> straggler watchdog, on a reduced model (pass --arch/--steps to scale;
the same entry point runs the full configs with ``launch.train.train(...,
reduced=False)``), on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: no checkpoints)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    run = train(args.arch, steps=args.steps, batch=args.batch,
                seq_len=args.seq_len, ckpt_root=args.ckpt, ckpt_every=50,
                log_every=20, device=args.device)
    print(f"\nloss {run.losses[0]:.3f} -> {run.losses[-1]:.3f} over "
          f"{run.steps_run} steps"
          + (f"; checkpoints in {args.ckpt}" if args.ckpt else ""))


if __name__ == "__main__":
    main()
