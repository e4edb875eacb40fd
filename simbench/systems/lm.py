"""System under test of the ``lm`` configurations: the port's serving
engine (``repro_torch.serve.batching.ServeEngine``) with its SiM-paged
k/v cache (``serve/kvcache.SimPagedKVCache``), one device.

Set-up builds the model at the configuration's sizes, loads the weights
the traffic drew (the reference's layout) into it, builds the paged cache
and the engine, serves the warm-up requests alone, then admits the long
sessions (their prefill and prompt mirror build their context) and the
first short requests.  The window then steps the engine, a closed loop:
as a short request retires, the next is handed over.

An op is one output token.  Its latency runs from the moment the
sequence's previous token was readable on the host, or, for a request's
first token, from its hand-over to the engine: the gaps between tokens a
user feels, admissions' stalls included.  The counters say how many of
the window's gaps came from an engine step that admitted a request (whose
prefill the other slots waited for), and how many of those at or above
the window's 95th percentile did.

The logits each token was chosen from are kept on the host; the weights
are read from the traffic once, to load the model (the traffic draws them
anew for the check), so that the card holds what the engine holds.  After
the window the results also hold each live sequence's global-layer k/v as
the SiM-paged pool gives it back (``gather_sequence``) and the pool's free
pages, for the check.

In a traced run the program's spans are on over the window; :data:`WINDOW`
keeps their totals and the engine's and the block table's counters over
the window's part before the profiler starts, for the per-layer metrics.
A program without the spans or counters leaves them out.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from simbench.window import sync

# The last traced window's span totals ({name: (count, total_ns, self_ns)})
# and counters, before the profiler started; empty until a traced window.
WINDOW: dict = {}

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "tie_embeddings", "norm_eps",
              "rope_theta", "ssm_state", "ssm_conv", "mamba_expand",
              "sliding_window", "global_layers", "meta_tokens", "kv_groups",
              "dtype")


def model_config(config: dict):
    """The program's config of ``config["arch"]`` with the file's sizes."""
    from repro_torch.configs import get_config
    kw = {k: config[k] for k in MODEL_KEYS if k in config}
    for k in ("global_layers", "kv_groups"):
        if k in kw:
            kw[k] = tuple(tuple(g) if isinstance(g, list) else g
                          for g in kw[k])
    return dataclasses.replace(get_config(config["arch"]), **kw)


@torch.no_grad()
def load_weights(model, weights: dict) -> None:
    """Set every parameter of the port's model (its embeddings tied) from
    weights in the reference's layout (``reference/lm.py``); the padded
    vocabulary rows are zero, as are the k/v projections of layers that
    read their group's cache."""
    cfg = model.cfg
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    model.embed.zero_()
    model.embed[:cfg.vocab_size] = weights["embed"]
    model.meta.copy_(weights["meta"])
    model.final_norm.copy_(weights["final_norm"])
    b = model.blocks
    for lid, lw in enumerate(weights["layers"]):
        b.norms.norm_0[lid] = lw["attn_norm"]
        b.norms.norm_1[lid] = lw["ffn_norm"]
        b.attn.wq[lid] = lw["wq"].view(d, h, hd)
        b.attn.wo[lid] = lw["wo"].view(h, hd, d)
        for name in ("wk", "wv"):
            if name in lw:
                getattr(b.attn, name)[lid] = lw[name].view(d, kv, hd)
            else:
                getattr(b.attn, name)[lid] = 0
        for name, key in (("in_proj", "in_proj"), ("conv_w", "conv"),
                          ("x_proj", "x_proj"), ("a_log", "a_log"),
                          ("d_skip", "d_skip"), ("out_proj", "out_proj")):
            getattr(b.mamba, name)[lid] = lw[key]
        b.mlp.wi_gate[lid] = lw["w_gate"]
        b.mlp.wi_up[lid] = lw["w_up"]
        b.mlp.wo[lid] = lw["w_down"]


class System:
    host_layer = "serve"

    def __init__(self, config: dict, inputs, device):
        from repro_torch.models.model import LM
        from repro_torch.serve.batching import Request, ServeEngine
        from repro_torch.serve.kvcache import SimPagedKVCache

        cfg = model_config(config)
        self.cfg, self.inputs, self.device = cfg, inputs, device
        self.Request = Request
        self.model = LM(cfg, device)
        load_weights(self.model, inputs.weights)
        self.cache = SimPagedKVCache(
            cfg, n_pages=int(config["kv_pages"]),
            page_tokens=int(config["page_tokens"]),
            table_pages=int(config["table_pages"]),
            n_chips=int(config["table_chips"]), device=device)
        self.backend = self.cache.chips
        self.engine = ServeEngine(
            self.model, max_slots=int(config["max_slots"]),
            cache_len=int(config["cache_len"]), paged_cache=self.cache,
            on_token=self._on_token)
        self.prompts: dict[int, list] = {}
        self.served: dict[int, list] = {}
        self.logits: dict[int, list] = {}
        self.window_from: dict[int, int] = {}
        self.last: dict[int, float] = {}
        self.latencies: list[float] = []
        self.in_window = False
        self.admitting: list[bool] = []    # each window gap's step admitted
        self.next_short = 0
        self.retired = 0
        self.counters: dict = {}

    # -------------------------------------------------------------- loop
    def _on_token(self, req_id: int, token: int, logits) -> None:
        now = time.perf_counter()
        if self.in_window:
            self.latencies.append(now - self.last[req_id])
        self.last[req_id] = now
        self.served[req_id].append(token)
        self.logits[req_id].append(logits[0, :self.cfg.vocab_size].cpu())

    def _hand(self, prompt, n_new: int) -> None:
        rid = len(self.prompts)
        self.prompts[rid] = prompt
        self.served[rid], self.logits[rid] = [], []
        self.window_from[rid] = 0
        self.last[rid] = time.perf_counter()
        self.engine.submit(self.Request(req_id=rid, prompt=prompt,
                                        max_new_tokens=n_new))

    def _hand_short(self) -> None:
        if self.next_short < len(self.inputs.short):
            self._hand(*self.inputs.short[self.next_short])
            self.next_short += 1

    def _refill(self, retired: int) -> int:
        """Hand a short request for each one retired since ``retired``."""
        done = len(self.engine.completed)
        for _ in range(done - retired):
            self._hand_short()
        return done

    def warm_up(self) -> None:
        eng, inputs = self.engine, self.inputs
        for prompt, n_new in inputs.warmup_requests:
            self._hand(prompt, n_new)
        eng.run()
        for prompt in inputs.long_prompts:
            self._hand(prompt, inputs.long_new_tokens)
        for _ in range(eng.max_slots - len(inputs.long_prompts)):
            self._hand_short()
        eng.step()
        self.retired = len(eng.completed)
        sync(self.device)

    def window(self, win) -> tuple[int, np.ndarray]:
        """Step the engine until the window closes; return the tokens served
        in it and their latencies (s)."""
        from repro_torch import spans
        eng = self.engine
        traced = win.tracer is not None
        WINDOW.clear()
        before = self._counters()
        for rid, toks in self.served.items():
            self.window_from[rid] = len(toks)
        if traced:
            spans.reset()
            spans.enable()
        self.in_window = True
        win.open()
        done = 0
        while win.tick(done):
            if traced and not WINDOW and win.span_ops is not None:
                WINDOW.update(spans=spans.totals(), counters=self._delta(
                    before))            # the profiler has just started
            prefills, before_step = eng.prefills, len(self.latencies)
            eng.step()
            self.admitting += [eng.prefills > prefills] * (
                len(self.latencies) - before_step)
            self.retired = self._refill(self.retired)
            done = len(self.latencies)
        win.close(done)
        self.in_window = False
        if traced:
            if not WINDOW:
                WINDOW.update(spans=spans.totals(),
                              counters=self._delta(before))
            spans.disable()
            spans.reset()
            print("[simbench] program spans before the profiler (count, "
                  "total s, self s): " + ", ".join(
                      f"{k} {c} {t * 1e-9:.6f} {sf * 1e-9:.6f}" for k, (
                          c, t, sf) in sorted(WINDOW["spans"].items())) +
                  f"; counters {WINDOW['counters']}", file=sys.stderr)
        self.counters = self._delta(before)
        lat = np.asarray(self.latencies[:done])
        self.counters.update(self._stalls(lat, self.admitting[:done]))
        return done, lat

    @staticmethod
    def _stalls(lat: np.ndarray, admitting: list) -> dict:
        """How many of the window's gaps, and of those at or above its
        95th percentile, came from steps that admitted a request."""
        if not len(lat):
            return {}
        adm = np.asarray(admitting, bool)
        tail = lat >= np.percentile(lat, 95)
        return {"gaps_admitting": int(adm.sum()),
                "gaps_p95_and_above": int(tail.sum()),
                "gaps_p95_and_above_admitting": int((tail & adm).sum())}

    def _counters(self) -> dict:
        eng = self.engine
        out = {k: v for k, v in dataclasses.asdict(self.cache.stats).items()}
        out.update({k: getattr(eng, k) for k in (
            "prefills", "decodes", "prefill_tokens", "mirrored", "steps")
            if hasattr(eng, k)})
        out["served"] = sum(len(t) for t in self.served.values())
        return out

    def _delta(self, before: dict) -> dict:
        now = self._counters()
        return {k: now[k] - before.get(k, 0) for k in now}

    def results(self) -> tuple[dict, dict]:
        """Every sequence served, warm-up and set-up included: its prompt,
        its tokens and the first served in the window; the logits each
        token was chosen from; for each sequence still in a slot, its
        global-layer (k, v), each (caches, positions, Hkv, hd), of the
        positions the paged pool holds (those of its prompt and every token
        it was served but the last), as the pool gives them back; and the
        pages on the pool's free list."""
        rids = sorted(self.prompts)
        executed = {"sequences": [
            {"prompt": self.prompts[r], "served": self.served[r],
             "window_from": self.window_from[r]} for r in rids]}
        live = self.engine.slots
        got = {"logits": [torch.stack(self.logits[r]).float()
                          if self.logits[r] else None for r in rids],
               "kv": [self.cache.gather_sequence(r, live[r].position)
                      if r in live else None for r in rids],
               "pages_free": self.cache.free_pages}
        return executed, got
