"""How far apart teacher-forced hymba-1.5b logits land under attentions of
bf16 rounding quality, on the card.

    python3 scripts/logit_spread.py          # from the repo root, ~3 min

hymba-1.5b at full width and depth (seed 0), four 1,000-token prompts
(``chip_smoke.py``'s request 8, then seeds 11-13), 48 logits each: the
prefill's and 47 decode steps fed the kernel run's greedy tokens through
a 1,024-slot ring.  Runs: the flash attention kernel (twice: bitwise
repeatable?), ``plain_attention``, ``attention_ref``, the float64
attention rounded once to bf16, and four seeded dithers of it
(``chip_smoke.rounded_attention``).  Prints, for every pair of runs, the
median and largest relative L2 distance of the logits over the steps and
the steps past 5e-2; each attention call's relative L2 error against the
float64 attention on its own inputs; and, at decode step 32 of request 8,
each layer's mamba-branch RMS and the residual stream's distance from the
float64 run's.
"""
import itertools
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.models import model as model_module  # noqa: E402

PROMPT_LEN, STEPS, CACHE_LEN, SEEDS, DITHERS = 1000, 48, 2048, (11, 12, 13), 4
TRACE_STEP = 32        # request 8's decode step whose layers are traced


def main() -> int:
    if not torch.cuda.is_available():
        print("logit_spread: runs only on the card", file=sys.stderr)
        return 2
    native.build()
    dev = torch.device("cuda", 0)
    cfg = cs.get_config(cs.HYMBA_ARCH)
    model = cs.init_model(cfg, seed=0, device=dev)
    per_call = {}

    def tracked(name, fn):
        def call(q, k, v, **kw):
            out = fn(q, k, v, **kw)
            exact = cs.float64_attention(q, k, v, **kw)
            per_call.setdefault(name, []).append(
                float((out.double() - exact).norm() / exact.norm()))
            return out
        return call

    # the decode step TRACE_STEP's block outputs and mamba branches
    trace, tracing = {}, [None]
    block, mamba = model_module._dense_block, model_module.apply_mamba

    def traced_block(*a, **kw):
        out = block(*a, **kw)
        if tracing[0]:
            trace.setdefault(tracing[0], {}).setdefault("x", []).append(
                out[0].float())
        return out

    def traced_mamba(*a, **kw):
        out = mamba(*a, **kw)
        if tracing[0]:
            trace.setdefault(tracing[0], {}).setdefault("mamba", []).append(
                out[0].float())
        return out

    model_module._dense_block = traced_block
    model_module.apply_mamba = traced_mamba

    def run(prompt, attention, feed=None, name=None):
        logits, caches = model_module.prefill(
            model, torch.tensor([prompt], device=dev), CACHE_LEN,
            attention=attention)
        out, toks = [logits[0, :cfg.vocab_size].float()], []
        for i in range(STEPS - 1):
            toks.append(int(out[-1].argmax()) if feed is None else feed[i])
            tracing[0] = name if i + 1 == TRACE_STEP else None
            logits, caches = model_module.decode_step(
                model, torch.tensor([[toks[-1]]], device=dev), caches,
                len(prompt) + i, attention=attention)
            tracing[0] = None
            out.append(logits[0, :cfg.vocab_size].float())
        return out, toks

    prompts = {"request 8": np.random.default_rng(8).integers(
        0, cfg.vocab_size, PROMPT_LEN).tolist()}
    for seed in SEEDS:
        prompts[f"seed {seed}"] = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, PROMPT_LEN).tolist()
    t0 = time.perf_counter()
    for label, prompt in prompts.items():
        name = (lambda n: n) if label == "request 8" else (lambda n: None)
        runs = {}
        runs["kernel"], feed = run(
            prompt, tracked("kernel", cs.flash_attention), name=name("kernel"))
        again, _ = run(prompt, cs.flash_attention, feed)
        runs["plain"], _ = run(prompt, tracked("plain", cs.plain_attention),
                               feed, name=name("plain"))
        runs["ref"], _ = run(prompt, tracked("ref", cs.attention_ref), feed)
        runs["f64"], _ = run(prompt, cs.rounded_attention(), feed,
                             name=name("f64"))
        for seed in range(DITHERS):
            runs[f"dither{seed}"], _ = run(
                prompt, tracked(f"dither{seed}", cs.rounded_attention(seed)),
                feed)
        same = all(torch.equal(a, b) for a, b in zip(runs["kernel"], again))
        print(f"== {label}: kernel run bitwise repeatable: {same}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for a, b in itertools.combinations(runs, 2):
            r = [cs.rel_l2(x, y) for x, y in zip(runs[a], runs[b])]
            print(f"  {a:>8} vs {b:<8} median {np.median(r):.3e} max "
                  f"{max(r):.3e} at step {int(np.argmax(r))}; steps > 5e-2 "
                  f"{[s for s, x in enumerate(r) if x > 5e-2]}", flush=True)
    for name, errs in per_call.items():
        e = np.array(errs)
        print(f"per-call rel L2 vs the float64 attention, {name}: n {len(e)} "
              f"median {np.median(e):.3e} p99 {np.percentile(e, 99):.3e} max "
              f"{e.max():.3e}")
    print(f"== request 8, decode step {TRACE_STEP}, by layer")
    print("  mamba branch RMS (f64 run): " + " ".join(
        f"{float(m.pow(2).mean().sqrt()):.4f}" for m in trace["f64"]["mamba"]))
    for who in ("kernel", "plain"):
        print(f"  residual rel L2 from the f64 run's, {who}: " + " ".join(
            f"{cs.rel_l2(x, y):.3f}"
            for x, y in zip(trace[who]["x"], trace["f64"]["x"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
