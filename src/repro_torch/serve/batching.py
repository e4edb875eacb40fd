"""Continuous-batching serving engine.

Slots hold independent sequences with their own caches and positions;
finished sequences retire and waiting requests admit without draining the
batch.  Slots step through ``decode_step`` one at a time (batch 1 each),
as the JAX package's engine does.

With a ``SimPagedKVCache`` the engine also mirrors every token's KV into
SiM-indexed pages: each write is a block-table search on the SiM chip
model, and a retiring sequence frees its pages with one §V-D partition
search.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from repro_torch.models.model import DenseLM, decode_step, prefill


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

    def __init__(self, model: DenseLM, *, max_slots: int = 4,
                 cache_len: int = 256, paged_cache=None):
        self.model = model
        self.cfg = model.cfg
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
        ck, cv = caches["kv"]
        for pos in range(len(req.prompt)):
            self.paged.write_token(req.req_id, pos,
                                   ck[:, 0, pos], cv[:, 0, pos])

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
            logits, slot.caches = decode_step(self.model, tok, slot.caches,
                                              slot.position)
            nxt = int(torch.argmax(logits, dim=-1)[0])
            self.decodes += 1
            self.decode_s += time.perf_counter() - t_dec
            slot.generated.append(nxt)
            if self.paged is not None:
                ck, cv = slot.caches["kv"]
                self.paged.write_token(req_id, slot.position,
                                       ck[:, 0, slot.position],
                                       cv[:, 0, slot.position])
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
