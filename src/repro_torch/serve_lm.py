"""End-to-end serving driver (the paper-native scenario): continuous
batching with the KV cache indexed by SiM pages — block-table lookups are
real search commands, sequence eviction is a §V-D partition sweep.  The
counterpart of the JAX package's ``examples/serve_lm.py``, on the card
unless ``--device cpu``: every attention of prefill and decode runs the
flash attention kernel, and every block-table search the batched
backend's kernels.

Run:  PYTHONPATH=src python -m repro_torch.serve_lm [--requests 12] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import serve


def main(argv=None) -> dict:
    """Serve the requests; print and return the completions, the tokens
    generated and the block-table searches per generated token (None
    without the paged cache)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--no-paged", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    completions, _, paged = serve(
        args.arch, n_requests=args.requests, paged=not args.no_paged,
        device=args.device)
    total = sum(len(c.tokens) for c in completions)
    print(f"\n{len(completions)} completions, {total} tokens generated")
    searches = None
    if paged is not None:
        searches = paged.stats.searches / total
        print(f"block-table searches per generated token: {searches:.1f}")
    return {"completions": completions, "tokens": total,
            "searches": None if paged is None else paged.stats.searches,
            "searches_per_token": searches}


if __name__ == "__main__":
    main()
