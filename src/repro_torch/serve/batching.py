"""Continuous-batching serving engine.

Slots hold independent sequences with their own caches and positions;
finished sequences retire and waiting requests admit without draining the
batch.  Slots step through ``decode_step`` one at a time (batch 1 each),
as the JAX package's engine does.

With a ``SimPagedKVCache`` the engine also mirrors every token's KV into
SiM-indexed pages: each write is a block-table search on the SiM chip
model, and a retiring sequence frees its pages with one §V-D partition
search.

Two cases where the JAX package's engine fails or goes wrong are refused
here with a clear error:
- The mirror pages position p's k/v from cache slot p.  A
  sliding-window ring of C slots holds position p in slot p % C, and only
  the last C positions: once the ring has wrapped, slot p holds a later
  position, and for p >= C JAX's indexing clamps to slot C - 1.  Either
  way JAX pages another position's k/v.  The port raises ``IndexError`` at
  the first such mirror, after the writes before it (so the block table's
  counters equal JAX's up to it).  An ssm config, which has no k/v at
  all, is refused with a paged cache.
- The engine passes no frontend embeddings, and an audio config's encoder
  needs its frames: JAX fails in prefill, the port refuses the config.
  Serve whisper through ``prefill`` and ``decode_step``.

A ``HymbaConfig`` (hymba-1.5b-base: global layers that hold the whole
context, window rings, meta tokens, k/v shared between layers) is served
through ``models/hymba.py``: the engine computes the meta tokens' state
once, from the model's weights as they are when it is built, and each
prefill starts from it.  Its paged mirror pages each global-layer cache's
k/v (slot = position, never a ring), so no position is refused; a prompt
is paged page by page (``SimPagedKVCache.write_tokens``: one lookup a
page), where the other configs page it token by token as the JAX package's
engine does.

``on_token(req_id, token, logits)``, when given, is called as each token
becomes readable on the host (a prefill's first token and every decoded
one).  Spans (``repro_torch.spans``): ``serve.admit`` (a request's
prefill and its prompt's mirror), ``serve.decode`` (one slot's decode
step and its mirror) and ``serve.mirror`` (one token's, or a prompt's,
block-table lookups, allocations and programs).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from repro_torch import spans
from repro_torch.models import hymba
from repro_torch.models.config import HymbaConfig
from repro_torch.models.model import LM, decode_step, prefill


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_token: int | None = None


@dataclasses.dataclass
class Completion:
    req_id: int
    tokens: list[int]
    prefill_s: float
    decode_s: float


@dataclasses.dataclass
class _Slot:
    request: Request
    caches: dict
    position: int
    generated: list[int]
    t_prefill: float


class ServeEngine:
    """``prefills`` and ``decodes`` count the model calls, each of which runs
    one attention per layer; ``prefill_tokens`` counts the prompts'
    tokens and ``mirrored`` the tokens paged; ``prefill_s`` and
    ``decode_s`` sum their host clock times, argmax included, and ``run_s``
    is the time of ``run``.
    Greedy decoding reads every argmax back to the host, so each of these
    clocks stops after the device work it times has finished."""

    def __init__(self, model: LM, *, max_slots: int = 4,
                 cache_len: int = 256, paged_cache=None, on_token=None):
        cfg = model.cfg
        if cfg.encoder_layers:
            raise ValueError(f"{cfg.name}: the engine passes no frontend "
                             "embeddings, which the audio encoder needs; "
                             "run prefill and decode_step with them")
        if paged_cache is not None and cfg.family == "ssm":
            raise ValueError(f"{cfg.name}: an ssm model has no k/v to page")
        self.model = model
        self.cfg = cfg
        self.device = model.embed.device
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.paged = paged_cache
        self.on_token = on_token
        self.meta = hymba.meta_state(model) \
            if isinstance(cfg, HymbaConfig) else None
        self.queue: deque[Request] = deque()
        self.slots: dict[int, _Slot] = {}
        self.completed: list[Completion] = []
        self.steps = 0
        self.prefills = 0
        self.decodes = 0
        self.prefill_tokens = 0
        self.mirrored = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.run_s = 0.0

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    # ----------------------------------------------------------- internals
    def _admit(self) -> None:
        while self.queue and len(self.slots) < self.max_slots:
            req = self.queue.popleft()
            s = spans.ON and spans.begin("serve.admit")
            t0 = time.perf_counter()
            tokens = torch.tensor([req.prompt], dtype=torch.int64,
                                  device=self.device)
            if self.meta is None:
                logits, caches = prefill(self.model, tokens, self.cache_len)
            else:
                logits, caches = hymba.prefill(self.model, tokens,
                                               self.cache_len, meta=self.meta)
            first = int(torch.argmax(logits, dim=-1)[0])
            dt = time.perf_counter() - t0
            self.prefills += 1
            self.prefill_tokens += len(req.prompt)
            self.prefill_s += dt
            if self.on_token is not None:
                self.on_token(req.req_id, first, logits)
            slot = _Slot(request=req, caches=caches,
                         position=len(req.prompt), generated=[first],
                         t_prefill=dt)
            if self.paged is not None:
                self._mirror_prompt_kv(req, caches)
            self.slots[req.req_id] = slot
            if s:
                spans.end(s)

    def _mirror_prompt_kv(self, req: Request, caches: dict) -> None:
        """Mirror prefilled KV into the SiM-paged pool (per token; a
        ``HymbaConfig``'s per page)."""
        n = len(req.prompt)
        if self.meta is None:
            for pos in range(n):
                self._mirror(req.req_id, caches, pos, n)
            return
        s = spans.ON and spans.begin("serve.mirror")
        ck, cv = caches["global"]
        slots = self._global_slot(ck, torch.arange(n, device=ck.device))
        self.paged.write_tokens(req.req_id, 0, ck[:, 0, slots],
                                cv[:, 0, slots])
        self.mirrored += n
        if s:
            spans.end(s)

    def _global_slot(self, ck, pos):
        """The slot of a ``HymbaConfig``'s global cache that holds text
        position ``pos``: meta tokens + ``pos``.  The cache never wraps; on
        a ring (``hymba.RING_KINDS``) the modulo gives what a slot holds."""
        m = self.cfg.meta_tokens
        return m + pos % (ck.shape[2] - m)

    def _mirror(self, req_id: int, caches: dict, pos: int,
                length: int) -> None:
        """Page position ``pos``'s k/v from cache slot ``pos``, of a cache
        that holds the sequence's first ``length`` positions (a
        ``HymbaConfig``'s global caches: slot meta tokens + ``pos``)."""
        s = spans.ON and spans.begin("serve.mirror")
        if self.meta is not None:
            ck, cv = caches["global"]
            slot = self._global_slot(ck, pos)
        else:
            ck, cv = caches["kv"]
            c = ck.shape[2]
            if pos >= c or length > pos + c:
                raise IndexError(
                    f"{self.cfg.name}: slot {pos} of the {c}-slot ring cache "
                    f"does not hold position {pos} (the ring holds positions "
                    f"{max(length - c, 0)}..{length - 1}, position p in slot "
                    "p % C); the paged mirror reads slot = position")
            slot = pos
        self.paged.write_token(req_id, pos, ck[:, 0, slot], cv[:, 0, slot])
        self.mirrored += 1
        if s:
            spans.end(s)

    def _retire(self, req_id: int, decode_s: float) -> None:
        slot = self.slots.pop(req_id)
        if self.paged is not None:
            self.paged.free_sequence(req_id)
        self.completed.append(Completion(
            req_id=req_id, tokens=slot.generated,
            prefill_s=slot.t_prefill, decode_s=decode_s))

    def step(self) -> int:
        """One engine tick: admit + one decode step per active slot."""
        self._admit()
        done = []
        t0 = time.perf_counter()
        for req_id, slot in self.slots.items():
            s = spans.ON and spans.begin("serve.decode")
            t_dec = time.perf_counter()
            tok = torch.tensor([[slot.generated[-1]]], dtype=torch.int64,
                               device=self.device)
            logits, slot.caches = decode_step(
                self.model, tok, slot.caches, slot.position,
                enc_out=slot.caches.get("enc_out"))
            nxt = int(torch.argmax(logits, dim=-1)[0])
            self.decodes += 1
            self.decode_s += time.perf_counter() - t_dec
            slot.generated.append(nxt)
            if self.on_token is not None:
                self.on_token(req_id, nxt, logits)
            if self.paged is not None:
                self._mirror(req_id, slot.caches, slot.position,
                             slot.position + 1)
            slot.position += 1
            req = slot.request
            if (len(slot.generated) >= req.max_new_tokens
                    or (req.eos_token is not None
                        and nxt == req.eos_token)):
                done.append(req_id)
            if s:
                spans.end(s)
        dt = time.perf_counter() - t0
        for rid in done:
            self._retire(rid, dt)
        self.steps += 1
        return len(self.slots)

    def run(self) -> list[Completion]:
        t0 = time.perf_counter()
        while self.queue or self.slots:
            self.step()
        self.run_s += time.perf_counter() - t0
        return self.completed
