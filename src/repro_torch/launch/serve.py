"""Serving entry point: continuous batching over a reduced model or the
full config (``--full``), on the card unless ``--device cpu``.
``--paged`` routes the KV cache through the SiM-paged block table (the
paper's technique in the serving path).  Weights are random, from
``seed``.  Every arch the JAX package's engine serves is served: the
dense, MoE, hybrid, VLM (text only: the engine passes no patch
embeddings) and ssm families.  whisper's encoder needs its frames, which
the engine does not pass: the engine refuses it (the JAX engine fails in
prefill), and whisper runs through ``models.model.prefill`` and
``decode_step``.

  python -m repro_torch.launch.serve --arch qwen3-4b --full --paged
  python -m repro_torch.launch.serve --arch qwen3-4b --paged
  python -m repro_torch.launch.serve --arch qwen3-4b --paged --device cpu

``--arch hymba-1.5b-base`` serves hymba at its published structure
(``models/hymba.py``: global layers holding the whole context, meta
tokens, k/v shared between layers); ``--full`` is its published size.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_model
from repro_torch.serve.batching import Request, ServeEngine
from repro_torch.serve.kvcache import SimPagedKVCache


def requests(n_requests: int, vocab_size: int, seed: int) -> list[Request]:
    """Prompts of 4–16 tokens, 4–12 new tokens each, drawn from ``seed``:
    the JAX package's launch/serve.py draws the same ones."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n_requests):
        prompt = rng.integers(0, vocab_size,
                              size=rng.integers(4, 17)).tolist()
        out.append(Request(req_id=rid, prompt=prompt,
                           max_new_tokens=int(rng.integers(4, 13))))
    return out


def serve(arch: str, *, n_requests: int = 8, reduced: bool = True,
          paged: bool = False, max_slots: int = 4, cache_len: int = 128,
          seed: int = 0, verbose: bool = True, device=None):
    """Serve ``n_requests`` random requests; return (completions, engine,
    paged cache or None).  ``device=None`` is the card."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    model = init_model(cfg, seed=seed, device=device)
    paged_cache = None
    if paged:
        paged_cache = SimPagedKVCache(cfg, n_pages=256, page_tokens=16,
                                      device=device)
    engine = ServeEngine(model, max_slots=max_slots, cache_len=cache_len,
                         paged_cache=paged_cache)
    for req in requests(n_requests, cfg.vocab_size, seed):
        engine.submit(req)
    t0 = time.perf_counter()
    completions = engine.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(c.tokens) for c in completions)
    if verbose:
        print(f"[serve] {cfg.name} on {device}: {len(completions)} requests, "
              f"{total_tokens} tokens in {dt:.2f}s "
              f"({total_tokens / dt:.1f} tok/s, {engine.steps} engine steps)")
        if paged_cache is not None:
            s = paged_cache.stats
            print(f"[serve] SiM block table: {s.searches} searches, "
                  f"{s.programs} programs, {s.pages_allocated} pages alloc, "
                  f"{s.pages_freed} freed")
    return completions, engine, paged_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="the full config instead of the reduced one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    serve(args.arch, n_requests=args.requests, reduced=not args.full,
          paged=args.paged, max_slots=args.slots, device=args.device)


if __name__ == "__main__":
    main()
