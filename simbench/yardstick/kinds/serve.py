"""Traffic kind ``serve``: a closed loop of chat requests beside long
sessions, for an ``lm`` configuration, and the model's weights, all drawn
from ``--seed``.

- ``long_sessions`` sessions of ``long_context`` prompt tokens each, whose
  context is built at set-up, then decode up to ``long_new_tokens``;
- short requests, handed to the program one by one as a slot frees:
  prompts log-uniform over [``short_prompt_min``, ``short_prompt_max``]
  tokens, answers log-uniform over [``short_answer_min``,
  ``short_answer_max``] tokens (``short_requests`` drawn, in order).
  Request i's quantile is the van der Corput point i + 1 in base
  ``short_prompt_base`` (prompts) or ``short_answer_base`` (answers),
  shifted by a uniform drawn from the seed, modulo 1: each quantile is
  uniform, as an independent draw's, and any run of consecutive requests
  covers the range evenly.  A run admits only some ten requests; so its
  lengths cover the range in every run, as a longer run's would, where
  independent draws leave a run's tail to which prompts it happened to
  draw;
- ``warmup_requests`` requests of ``warmup_prompt`` tokens and
  ``warmup_answer`` answers, served alone at set-up.

``warmup`` and ``n_stream`` count window tokens as ``simbench/control.py``
counts a run's ops: none before the window, and at most every short
answer and long session's tokens in it.

Token ids are uniform over the configuration's vocabulary.  The weights
are the plain reference's layout (``reference/lm.py``), drawn afresh on
the run's card (the CPU without one) each time ``weights`` is read, from a
generator seeded with the seed: the system reads them once to load its
model and the check once more after the system is gone, so that the card
holds only the program's copy while it serves.  They are drawn in
the configuration's dtype (``a_log`` and ``d_skip`` in float32): each
projection normal with standard deviation 1/sqrt(fan-in), the embedding
the same (1/sqrt(d)), the meta vectors standard normal, the norm weights
1 + 0.1 N(0, 1), ``a_log`` log(1..N) + 0.1 N(0, 1), ``d_skip`` 1 + 0.1
N(0, 1).  A layer that reads its k/v group's cache has no k/v projection.

Float32 products run at float32 here: TF32 is turned off for the process,
which the reference needs and the program (bf16) does not read.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class ServeInputs:
    config: dict
    seed: int
    device: torch.device
    long_prompts: list       # token lists
    long_new_tokens: int
    short: list              # (prompt, answer length) in hand-over order
    warmup_requests: list    # (prompt, answer length)
    warmup: int = 0          # window tokens before the window (control.py)
    n_stream: int = 0        # the most window tokens a run can serve

    @property
    def weights(self) -> dict:
        """The weights (module docstring), drawn anew at each read."""
        return draw_weights(self.config, self.seed, self.device)


def van_der_corput(n: int, base: int) -> np.ndarray:
    """Points 1..n of the van der Corput sequence in ``base``."""
    out = np.zeros(n)
    i = np.arange(1, n + 1)
    scale = 1.0 / base
    while i.any():
        i, digit = np.divmod(i, base)
        out += digit * scale
        scale /= base
    return out


def _log_uniform(rng, lo: int, hi: int, n: int, base: int) -> list[int]:
    """``n`` integers log-uniform over [lo, hi] at the quantiles of the
    van der Corput sequence in ``base`` shifted by a seeded uniform."""
    u = (van_der_corput(n, base) + rng.uniform()) % 1.0
    x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    return np.minimum(np.floor(x).astype(np.int64), hi).tolist()


def draw_weights(config: dict, seed: int, device) -> dict:
    """The model's weights in the reference's layout (module docstring)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, config["dtype"])
    d, f = int(config["d_model"]), int(config["d_ff"])
    hq = int(config["n_heads"]) * int(config["head_dim"])
    hkv = int(config["n_kv_heads"]) * int(config["head_dim"])
    e = int(config["mamba_expand"]) * d
    n, k = int(config["ssm_state"]), int(config["ssm_conv"])

    def normal(*shape, std=1.0, mean=0.0, dt=dtype):
        x = torch.randn(shape, generator=gen, device=device)
        return (x * std + mean).to(dt)

    def proj(fan_in, fan_out):
        return normal(fan_in, fan_out, std=fan_in ** -0.5)

    def norm():
        return normal(d, std=0.1, mean=1.0)

    readers = {i for g in config["kv_groups"] for i in g[1:]}
    w = {"embed": normal(int(config["vocab_size"]), d, std=d ** -0.5),
         "meta": normal(int(config["meta_tokens"]), d),
         "final_norm": norm(), "layers": []}
    a_log = torch.arange(1, n + 1, device=device, dtype=torch.float32).log()
    for lid in range(int(config["n_layers"])):
        lw = {"attn_norm": norm(), "wq": proj(d, hq)}
        if lid not in readers:
            lw["wk"], lw["wv"] = proj(d, hkv), proj(d, hkv)
        lw.update(
            wo=proj(hq, d), in_proj=proj(d, 2 * e),
            conv=normal(k, e, std=k ** -0.5), x_proj=proj(e, 2 * n + 1),
            a_log=a_log + normal(e, n, std=0.1, dt=torch.float32),
            d_skip=normal(e, std=0.1, mean=1.0, dt=torch.float32),
            out_proj=proj(e, d), ffn_norm=norm(), w_gate=proj(d, f),
            w_up=proj(d, f), w_down=proj(f, d))
        w["layers"].append(lw)
    return w


def make(config: dict, traffic: dict, seed: int) -> ServeInputs:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    rng = np.random.default_rng(seed)
    vocab = int(config["vocab_size"])

    def prompt(length: int) -> list[int]:
        return rng.integers(0, vocab, length).tolist()

    t = traffic
    longs = [prompt(int(t["long_context"]))
             for _ in range(int(t["long_sessions"]))]
    n_short = int(t["short_requests"])
    lengths = _log_uniform(rng, int(t["short_prompt_min"]),
                           int(t["short_prompt_max"]), n_short,
                           int(t["short_prompt_base"]))
    answers = _log_uniform(rng, int(t["short_answer_min"]),
                           int(t["short_answer_max"]), n_short,
                           int(t["short_answer_base"]))
    short = [(prompt(s), a) for s, a in zip(lengths, answers)]
    warm = [(prompt(int(t["warmup_prompt"])), int(t["warmup_answer"]))
            for _ in range(int(t["warmup_requests"]))]
    n_long = int(t["long_new_tokens"])
    return ServeInputs(config=config, seed=seed, device=device,
                       long_prompts=longs, long_new_tokens=n_long,
                       short=short, warmup_requests=warm,
                       n_stream=len(longs) * n_long + sum(answers))
