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
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

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
    one attention per layer; ``prefill_s`` and ``decode_s`` sum their host
    clock times, argmax included, and ``run_s`` is the time of ``run``.
    Greedy decoding reads every argmax back to the host, so each of these
    clocks stops after the device work it times has finished."""

    def __init__(self, model: LM, *, max_slots: int = 4,
                 cache_len: int = 256, paged_cache=None):
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
        self.queue: deque[Request] = deque()
        self.slots: dict[int, _Slot] = {}
        self.completed: list[Completion] = []
        self.steps = 0
        self.prefills = 0
        self.decodes = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.run_s = 0.0

    def submit(self, request: Request) -> None:
        self.queue.append(request)

    # ----------------------------------------------------------- internals
    def _admit(self) -> None:
        while self.queue and len(self.slots) < self.max_slots:
            req = self.queue.popleft()
            t0 = time.perf_counter()
            tokens = torch.tensor([req.prompt], dtype=torch.int64,
                                  device=self.device)
            logits, caches = prefill(self.model, tokens, self.cache_len)
            first = int(torch.argmax(logits, dim=-1)[0])
            dt = time.perf_counter() - t0
            self.prefills += 1
            self.prefill_s += dt
            slot = _Slot(request=req, caches=caches,
                         position=len(req.prompt), generated=[first],
                         t_prefill=dt)
            if self.paged is not None:
                self._mirror_prompt_kv(req, caches)
            self.slots[req.req_id] = slot

    def _mirror_prompt_kv(self, req: Request, caches: dict) -> None:
        """Mirror prefilled KV into the SiM-paged pool (per token)."""
        for pos in range(len(req.prompt)):
            self._mirror(req.req_id, caches, pos, len(req.prompt))

    def _mirror(self, req_id: int, caches: dict, pos: int,
                length: int) -> None:
        """Page position ``pos``'s k/v from cache slot ``pos``, of a cache
        that holds the sequence's first ``length`` positions."""
        ck, cv = caches["kv"]
        c = ck.shape[2]
        if pos >= c or length > pos + c:
            raise IndexError(
                f"{self.cfg.name}: slot {pos} of the {c}-slot ring cache "
                f"does not hold position {pos} (the ring holds positions "
                f"{max(length - c, 0)}..{length - 1}, position p in slot "
                "p % C); the paged mirror reads slot = position")
        self.paged.write_token(req_id, pos, ck[:, 0, pos], cv[:, 0, pos])

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
            if self.paged is not None:
                self._mirror(req_id, slot.caches, slot.position,
                             slot.position + 1)
            slot.position += 1
            req = slot.request
            if (len(slot.generated) >= req.max_new_tokens
                    or (req.eos_token is not None
                        and nxt == req.eos_token)):
                done.append(req_id)
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
