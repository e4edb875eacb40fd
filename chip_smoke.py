"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py              # the full run, from the repo root

Phases, in order; any failure exits non-zero and no phase is skipped:

1. Device: the card's name and power limit, and the time to build the
   CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Kernel checks: each kernel against its plain PyTorch version on the
   card — the SiM kernels bit-exact on inputs with planted hits, flash
   attention within 2e-6 (float32) and 2e-2 (bfloat16) — with CUDA-event
   times per launch for both beside the launch floor (an empty kernel),
   the kernel's bound at the timed shapes and, for attention, PyTorch's
   ``scaled_dot_product_attention`` in its fastest form for each case as
   the library yardstick (timed only; the port never calls it).  The
   mamba heads' ``mamba_conv`` and ``mamba_scan`` at hymba-1.5b-base's
   widths (B 1 and 2, S 1 to 6,144): the conv and its tail bit for bit,
   the state within 1e-5, a bf16 output by the ulp rule of
   ``MAMBA_Y_EXACT``; timed at a decode step, S 1,024 and 6,144.
   ``sim_search``, ``sim_lookup`` and ``sim_gather`` are also checked
   reading their pages in place from an arena of the replay's size
   (32,768 rows, 128 MiB, over the 50 MB L2), and timed cold there, 64
   fresh random rows a launch: the device work of a flush.  The chip-axis
   forms of ``sim_search`` (in place, Q = 64 and R = 64 a chip) and
   ``sim_plan`` (G = 2, P = 16, R = 32 a chip) are checked at C = 1, 3 and
   16 chips, pad chips, pad rows and rows repeated across chips included,
   and timed beside one flat launch of as many cells (chip 0's queries or
   plan groups over every chip's rows).
3. Replays through ``repro_torch.frontend.replay`` on the ``batched``
   backend, each checked against a numpy oracle of serial semantics:
   YCSB-B split and fused (they must also agree), YCSB-E range scans
   (fused, one ``sim_plan`` launch a scan; the first scans are also held
   against the per-pass search path) and YCSB-A through the §VI DRAM write
   buffer (fused).
   Then the sharded SSD (``ShardedSsdBackend``, 8 channels x 2 dies, the
   flash timeline on): YCSB-B split and fused and YCSB-E scans at the same
   size, held to the oracle and to the batched replays' values and
   launches (one chip-axis ``sim_search`` or ``sim_plan`` launch a search
   or plan phase), one simulated burst latency a flush; each chip-axis
   form is timed on the operands of its most frequent launch shape there.
   At the same size, ``RunConfig.event_serial()`` against the serial
   sharded replay; at a quarter of the key pages one open-loop point
   (read_priority, 8 streams), its read values held to the oracle in the
   event loop's dispatch order.
   Then, at 1,024 key pages and 2,000 ops, the timeline on the card
   against the same replay on the CPU, and the open-loop point's simulated
   latencies against the scalar backend's.
   Then bit faults (§IV-C, phase 3c): the JAX BER sweep's own
   configuration (``benchmarks/reliability_sweep.py``: 240 ops, 12 key
   pages, 4 chips, ages 0/45/90 verified with vote_k 3, then sense noise
   unverified at vote_k 1 and 3) on ScalarBackend and on the batched and
   sharded backends on the card, every counter equal to the committed
   ``BENCH_reliability_sweep.baseline.json`` and the card's stats equal to
   device="cpu"; at full size a fused YCSB read-only replay at age 90
   under ``RunConfig.reliable`` (every read the oracle value or a typed
   ``UncorrectableReadError``, the first 8 bursts equal ScalarBackend
   response by response), the same replay on the sharded backend equal op
   by op, and the raw kernel checks at age 45 (a split replay of 5,000
   ops under the tier without verification or noise, every bitmap and
   chunk equal to the chip model's read of the damaged or open-repaired
   page; a fused YCSB-E replay of 5,000 ops without the tier, every
   lookup's bitmap, slot, value and parity flag and every plan's bitmap
   equal to the chip model's over the damaged pages).
   Then device faults (phase 3d): the JAX chaos sweep's own configuration
   (``benchmarks/chaos_sweep.py``: four fault schedules and the overload
   run on replicas 2; every counter and read p99 equal to
   ``BENCH_chaos_sweep.baseline.json``), and the dying-die and dead-chip
   schedules under ``RunConfig.chaos`` on 8 x 2 chips with replicas 2 at
   4,096 key pages (values and scan counts equal the oracle in dispatch
   order, failovers above 0 and each served by a launch over replica
   rows, reads that follow a bad-block remap served by the kernels from
   spare rows).
   Then the contract auditor (phase 3e): ``python -m repro_torch.analysis
   --check`` in-process on the card (the AST lint of ``src/repro_torch``,
   the launch audit and the conservation audit on the batched and sharded
   backends) with zero new findings and ``native.LAUNCHES`` moving once per
   recorded entry in every flush phase, ``sim_search``, ``sim_plan``,
   ``sim_lookup`` and ``sim_gather`` each launched; two doctored entries
   caught on the card (a ``sim_search`` that launches twice trips SIM101,
   a ``sim_gather`` that calls ``.item()`` on its output trips SIM102
   through sync debug mode); and the conservation books (SIM201–SIM203)
   of a sharded YCSB-B split replay at a quarter of the key pages, 8 x 2
   chips, on a metered timeline, its reads equal to the oracle.
4. The §V indexes on the ``batched`` backend, each path against a numpy
   oracle, with the first bursts of each kind also run on
   ``ScalarBackend`` over a copy of the stored pages and held equal
   response by response (and in ``result_bytes``), and every index call
   held to its exact launches: a ``SimBTree`` of 16,384 leaves (64 lookup
   bursts, one ``sim_lookup`` each; 256 ranges of up to 100 keys and 4 of
   2 % of the key space, one ``sim_plan`` and one ``sim_gather`` each), a
   ``SimHashIndex`` with the §VI write buffer (32,768 inserts, 1,024
   updates, 64 probe bursts; each split and each burst one ``sim_search``
   and one ``sim_gather``), a ``SimSecondaryIndex`` of 1,048,576 rows on
   2,081 pages (three selects, one ``sim_plan`` and one ``sim_gather``
   each), then ``repro_torch.database_index.main`` on the card, held
   against the same run on the CPU's plain versions.
5. The quickstart (``repro_torch.quickstart.main``) on the card: the
   ``sim_search`` and cross-product ``sim_fused`` kernels, held against
   the same run on the CPU's plain versions.
6. Serving qwen3-4b at full width and depth with the SiM-paged KV cache
   (``repro_torch.launch.serve.serve``): every attention of prefill and
   decode through the flash attention kernel, the block table's counters
   recounted from the requests, a paged sequence gathered back bit for bit,
   and first-token logits held against the plain attention.  Then the
   launcher's default, the reduced qwen3-4b (16-wide heads), served on the
   card through the kernel, with the same checks but the gather.
7. Training (``repro_torch.launch.train.train``).  olmo-1b at full width
   and depth (16 layers, d_model 2048, 1.18 B bf16 parameters, float32
   moments, remat ``block``), batch 8 x 512 tokens, 5 steps: every loss
   finite, the flash attention kernel launched exactly twice a layer a step
   (the forward and the remat recompute; its gradient is the plain
   ``attend``'s VJP, no launch), step time, tokens/s and peak memory; then
   step 0's loss and every parameter's gradient once more through the
   kernel and through the plain attention (a comparison, not the path):
   all finite, ``wq``/``wk``/``wv`` non-zero in every layer, loss and each
   leaf within 5e-2 relative L2.  The forward kernel and its backward (the
   ``attend`` VJP) are timed at this shape beside SDPA's.  Then the
   launcher's default, the reduced olmo-1b, 30 steps: the loss falls by
   more than 0.3 (the JAX test's bound).  Then crash and bitwise resume:
   olmo-1b at full width with ``n_layers`` cut to 2 (a full-depth
   checkpoint is about 14 GB of npz), 20 steps with a checkpoint every 10,
   straight through and crashed at step 12 then restarted; steps 10-19's
   losses bitwise equal, under ``torch.use_deterministic_algorithms`` and
   ``CUBLAS_WORKSPACE_CONFIG``, set in this phase only and restored.
   Then the int8 error-feedback step, 2 pods stacked, 15 steps of reduced
   olmo-1b in float32 beside the uncompressed step, within the JAX test's
   bounds.
8. Model families, each run's model freed before the next.  hymba-1.5b
   (hybrid) at full width and depth (1.39 B bf16 parameters) through
   ``ServeEngine`` with a 2,048-token cache, a ring of 1,024 slots: the
   launcher's 8 requests and two seeded long ones, a 1,000-token prompt
   with 48 new tokens (decode wraps the ring) and a 1,536-token prompt with
   8 (prefill rolls the last 1,024 positions into place); windowed and
   global layers in one stack, ring decode at q_offset min(index, 1023).
   Layer 0's ring slots after the long prefill hold their positions' k.
   mixtral-8x22b (MoE) at full width with 12 of its 56 layers, the
   launcher's 8 requests, SiM-paged, counters equal to the recount.
   internvl2-26b (VLM) at full width and depth: one 320-token prompt with
   256 seeded stub patch embeddings, 16 decode steps.  whisper-medium
   (audio) at full width and depth: 1,500 seeded stub frames through the
   non-causal encoder, an 8-token prompt, 16 decode steps with
   cross-attention.  xlstm-350m (ssm) at full width served with the
   launcher's 8 requests (no attention), then in float32 prefill and a
   decode step against ``train_logits``.  Then every arch's launcher
   default, reduced, on the card (whisper refused: the engine passes no
   frames).  Every request completes; ``flash_attention`` launches
   exactly once an attention (``n_layers`` a prefill and a decode step;
   whisper 72 a prefill, 48 a decode step), ``mamba_conv`` and
   ``mamba_scan`` once a hymba layer a prefill and a decode step, and
   nothing else launches.  A
   prefill and teacher-forced decode steps run again through the kernel
   and through ``plain_attention`` (an MoE's routing pinned to the kernel
   run's): every attention call of the kernel run within phase 2's bound
   of the plain attention on its own inputs, and every step's logits
   within 5e-2 relative L2 of the plain run's or, at a step beyond it,
   within 1.5x the largest distance between reference runs there
   (``attention_ref``, the float64 attention, seeded dithers of it).
9. The dry run against the card.  Two check cells at their own shapes
   with no mesh, as phases 6-7 run them: olmo-1b's training step (8 x 512
   tokens, remat ``block``) and one qwen3-4b decode step (batch 1, a
   128-slot cache).  Each step is traced on meta tensors by
   ``repro_torch.launch.dryrun.lower_cell``, then built on the card with
   random weights and run once under the same counter: dot FLOPs, bytes
   accessed, result bytes and op count equal exactly, the traced peak
   within 10 % of ``torch.cuda.max_memory_allocated`` (less what lives
   on the card beside the step's inputs), and the median of the timed
   steps no faster than the roofline's bound; the roofline fraction and
   MFU printed.  The attention op's dispatch cost at the decode shape.
   Then ``run_cell`` of olmo-1b ``train_4k`` and qwen3-4b ``decode_32k``
   on the single-pod mesh (256 fake ranks): status ``ok``, the dominant
   term printed.  Then ``repro_torch.range_query_analytics.main()`` equal
   to its CPU run number for number, one ``sim_plan`` and one
   ``sim_gather`` launch a select, and ``repro_torch.serve_lm.main()``
   completing every request with the CPU run's completions, tokens and
   searches.
10. The tensor-parallel training step (``train/train_step.py`` on a
   mesh).  (a) A world of one over NCCL (``tcp://localhost``, a free
   port) on a (1, 1) ``("data", "model")`` mesh: olmo-1b at full width
   with 2 layers in float32, 2 steps of the sharded step, its collectives
   run over groups of one, against the plain step from the same seed:
   losses within 1e-5 and parameters within 1e-4, the flash attention
   kernel twice a layer a step.  (b) Rank 0 of the single-pod 16 x 16 mesh
   over the ``fake`` process group: olmo-1b's ``train_4k`` step at full
   width and depth on the rank's own shards (16 x 4,096 tokens, 1 q head,
   512 MLP columns, 3,152 vocabulary rows), traced on meta tensors by
   ``lower_cell`` and run on the card under the same counter (counts
   equal op for op, peaks as phase 9 holds them), then timed against the
   roofline's compute and memory terms (the fake collectives move nothing,
   and leave gathered buffers unfilled, so the values are meaningless).
11. The sharded serve step (``serve/serve_step.py`` on a mesh: weights
   split over ``model`` with per-layer FSDP gathers, caches in the JAX
   layout, decode attention split along the cache and merged by the
   kernel's log-sum-exp).  (a) A world of one over NCCL on a (1, 1) mesh:
   qwen3-4b and hymba-1.5b (on its 1,024-slot ring, a 1,100-token prompt)
   at full width with 2 layers in float32, a prefill and 4 decode steps
   fed the same tokens, against the plain ``prefill`` and ``decode_step``
   from the same seed: logits and every cache leaf within 1e-5, one
   ``flash_attention`` launch a layer a step (and for hymba one
   ``mamba_conv`` and one ``mamba_scan``) and nothing else.  (b) Rank 0
   of the single-pod 16 x 16 mesh over ``fake``: qwen3-4b and hymba-1.5b
   ``decode_32k`` at full width and depth (8 batch rows, 2,048 and 64
   cache slots), traced by ``lower_cell`` and run on the card under the
   same counter (counts equal op for op, peaks as phase 9 holds them),
   then timed against the compute and memory terms; values not checked.
   Phase 2 also holds the kernel's log-sum-exp output against the plain
   version's at the decode shapes of these ranks.
12. The compressed training step on a pod mesh
   (``parallel/compression.py``: each pod's tensor-parallel gradient, the
   int8 error-feedback stage over the pod group with the scale's maximum
   taken over the leaf's shards).  A world of one over NCCL on a (1, 1, 1)
   ``("pod", "data", "model")`` mesh: olmo-1b at full width with 2 layers
   in float32, ``fsdp=False``, 3 compressed steps beside the stacked form
   with one pod from the same seed and batches: losses, every parameter
   and every residual leaf bitwise equal; ``flash_attention`` launched as
   the training step launches it and nothing else.  The cross-pod stage
   alone timed (the median of 5 runs) beside its memory bound, 16 B a
   parameter.
13. One JSON line of the kernels, their launches and times.
14. The card's ``nvidia-smi`` name and power limit, then the last line:
    ``{"ok": true, "device": {...}}``.

The launch counts are set to 0 just before each path of phases 3–12 and read
just after it; they show which kernels ran on that path. The replay scale
is 20% of the paper's 650 MiB index: 16,384 key pages and 16,384 value
pages of 4 KiB on 16 chips, for every replay path, the sharded and reliable
ones included (the chaos replays hold 4,096 key pages: replicas triple the
host page programs); the B+Tree has as many leaves. ``--key-pages`` and
``--n-ops`` cut them for a quick check (the hash index takes two inserts a
key page, the secondary index 64 rows a key page).
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import (database_index, quickstart,  # noqa: E402
                         range_query_analytics, serve_lm)
from repro_torch.analysis import __main__ as auditor  # noqa: E402
from repro_torch.analysis.conservation import (  # noqa: E402
    audit_books, make_metered_timeline)
from repro_torch.analysis.launch_audit import audit_backend  # noqa: E402
from repro_torch.backend import (BatchedKernelBackend,  # noqa: E402
                                 ScalarBackend, ShardedSsdBackend,
                                 make_backend)
from repro_torch.backend import sharded as sharded_backend  # noqa: E402
from repro_torch.backend.batched import PAGE_BLOCK  # noqa: E402
from repro_torch.backend.planestore import next_pow2, padded_rows  # noqa: E402
from repro_torch.configs import (ARCHS, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.backend import batched as batched_backend  # noqa: E402
from repro_torch.convert import (chip_array_from_numpy,  # noqa: E402
                                 chip_array_to_numpy)
from repro_torch.core.bitweaving import Column, RowCodec  # noqa: E402
from repro_torch.core.bits import (SLOTS_PER_CHUNK,  # noqa: E402
                                   SLOTS_PER_PAGE, unpack_bitmap)
from repro_torch.core.commands import Command, Op  # noqa: E402
from repro_torch.core.ecc import crc32_rows  # noqa: E402
from repro_torch.core.engine import SimChipArray  # noqa: E402
from repro_torch.core.page import mask_header_slots  # noqa: E402
from repro_torch.core.range_query import (RangePlan,  # noqa: E402
                                          approximate_range,
                                          evaluate_plan_on_pages,
                                          evaluate_plan_per_pass, exact_range)
from repro_torch.flash.params import FlashParams  # noqa: E402
from repro_torch.frontend import RunConfig, replay  # noqa: E402
from repro_torch.index.btree import SimBTree  # noqa: E402
from repro_torch.index.hashindex import SimHashIndex  # noqa: E402
from repro_torch.index.secondary import (ROWS_PER_PAGE,  # noqa: E402
                                         SimSecondaryIndex)
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import (mamba_conv,  # noqa: E402
                                                mamba_scan)
from repro_torch.kernels.mamba_scan.ref import (causal_conv_ref,  # noqa: E402
                                               selective_scan_ref)
from repro_torch.kernels.layout import (planes_to_chunk_words,  # noqa: E402
                                        tensor_to_words, words_to_tensor)
from repro_torch.kernels.sim_fused.ops import (sim_fused,  # noqa: E402
                                               sim_fused_lookup)
from repro_torch.kernels.sim_fused.ref import (sim_fused_ref,  # noqa: E402
                                               sim_lookup_ref)
from repro_torch.kernels.sim_gather.ops import sim_gather  # noqa: E402
from repro_torch.kernels.sim_gather.ref import sim_gather_ref  # noqa: E402
from repro_torch.kernels.sim_plan.ops import (sim_plan,  # noqa: E402
                                              sim_plan_chips)
from repro_torch.kernels.sim_plan.ref import (plan_pass_rows,  # noqa: E402
                                              sim_plan_chips_ref,
                                              sim_plan_ref)
from repro_torch.kernels.sim_search.ops import (sim_search,  # noqa: E402
                                                sim_search_chips)
from repro_torch.kernels.sim_search.ref import (  # noqa: E402
    sim_search_chips_ref, sim_search_ref, stream_planes)
from repro_torch.kernels.timing import (ARENA_ROWS,  # noqa: E402
                                        ITERS as COLD_ITERS, cold_ms,
                                        device_ms, planted_lookup_queries,
                                        random_arena, row_sets)
from repro_torch.launch.roofline import (F32_FLOPS, HBM_BW,  # noqa: E402
                                         INT32_OPS, PEAK_FLOPS,
                                         attention_flops, attention_pairs)
from repro_torch.launch.serve import requests, serve  # noqa: E402
from repro_torch.launch.dryrun import (WORLD as DRYRUN_WORLD,  # noqa: E402
                                       build_step, fake_world, lower_cell,
                                       production_mesh, run_cell)
from repro_torch.launch.roofline import analyze, model_flops  # noqa: E402
from repro_torch.launch.trace_analysis import count  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.config import SHAPES, InputShape  # noqa: E402
from repro_torch.convert import nest, param_tree  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models.layers import (block_norm,  # noqa: E402
                                       plain_attention, rope)
from repro_torch.models.model import (LM, decode_step,  # noqa: E402
                                      embed_tokens, init_model, prefill,
                                      train_logits)
from repro_torch.parallel.compression import (  # noqa: E402
    init_error_state, make_compressed_train_step)
from repro_torch.train.data import DataConfig, batch_at_step  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         adamw_update, init_opt_state)
from repro_torch.train.train_step import (make_train_step,  # noqa: E402
                                          value_and_grad)
from repro_torch.reliability import (DegradedReadError,  # noqa: E402
                                     FaultModel, FaultSchedule,
                                     ReliabilityPolicy, ReliabilityState,
                                     UncorrectableReadError, match_bitmap,
                                     plan_bitmap)
from repro_torch.serve.batching import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kvcache import PagedStats, SimPagedKVCache  # noqa: E402
from repro_torch.workload.ycsb import KEYS_PER_PAGE, generate  # noqa: E402

# The open-loop point and the metered conservation replay load a quarter
# of the replays' key pages (their checks do not depend on the size), to
# keep the smoke within its time with phase 11 added.
CUT_LOAD = 4
# The H100's peaks (HBM bytes/s, 32-bit integer ops/s, bf16 and float32
# FLOP/s) come from repro_torch.launch.roofline, with their sources; the
# bound of an attention launch counts its multiply-adds at the rate of its
# type.
# 32-bit operations of the §IV-C1 stream for one slot: counter (3) + two
# mix2_32 of 17 each + XOR into the lo and hi words (2).
STREAM_OPS = 39
# Per (query, slot) match: 2 XOR, 2 AND, 1 OR, 1 compare.
MATCH_OPS = 6
# Per (real plan pass, slot): the match and an OR into its accumulator.
PASS_OPS = MATCH_OPS + 1

SRC = "src/repro_torch/kernels/csrc"
KERNELS = {
    "sim_search": (f"{SRC}/sim_search.cu",
                   "src/repro/kernels/sim_search/sim_search.py:47"),
    "sim_gather": (f"{SRC}/sim_gather.cu",
                   "src/repro/kernels/sim_gather/sim_gather.py:31"),
    "sim_lookup": (f"{SRC}/sim_lookup.cu",
                   "src/repro/kernels/sim_fused/sim_fused.py:175"),
    "sim_plan": (f"{SRC}/sim_plan.cu",
                 "src/repro/kernels/sim_plan/sim_plan.py:49"),
    "sim_fused": (f"{SRC}/sim_fused.cu",
                  "src/repro/kernels/sim_fused/sim_fused.py:95"),
    "flash_attention": (
        f"{SRC}/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:31"),
    # no Pallas kernel: the JAX package's mamba heads run jax.lax.scan
    "mamba_conv": (f"{SRC}/mamba_scan.cu", "src/repro/models/ssm.py:69"),
    "mamba_scan": (f"{SRC}/mamba_scan.cu", "src/repro/models/ssm.py:46"),
}
REPLAY_KERNELS = ("sim_search", "sim_gather", "sim_lookup", "sim_plan")
INDEX_KERNELS = ("sim_lookup", "sim_plan", "sim_gather", "sim_search")
# Bounds of the full serve run: a prompt of 4-16 tokens and at most 12 new
# ones keep every position below 28 of the 128-slot cache.
SERVE_ARCH, SERVE_CACHE_LEN = "qwen3-4b", 128
# Tolerance of the first-token logits of the served model against the same
# prefill with the plain attention: relative L2 error over the real
# vocabulary.  Both sum in float32 (in different orders) and round each
# attention output to bf16; where the two roundings differ (by one bf16 ulp,
# 2^-8 relative) the difference is carried through the bf16 residual stream
# and compounds over 36 layers of random weights.
LOGITS_REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def max_abs_err(kernel_out, plain_out) -> int:
    err = 0
    for k, p in zip(kernel_out, plain_out):
        a = tensor_to_words(k).astype(np.int64)
        b = tensor_to_words(p).astype(np.int64)
        if a.shape != b.shape:
            raise AssertionError(f"shape {a.shape} != plain {b.shape}")
        err = max(err, int(np.abs(a - b).max(initial=0)))
    return err


# --------------------------------------------------------------- phase 2
def stream_np(ids, seeds):
    """The §IV-C1 stream of each page, (N, 512) lo and hi uint32 planes,
    from the plain version's own generator on the CPU."""
    s_lo, s_hi = stream_planes(words_to_tensor(ids, "cpu"),
                               words_to_tensor(seeds, "cpu"))
    return s_lo.numpy().astype(np.uint32), s_hi.numpy().astype(np.uint32)


def search_case(dev, n_pages, n_queries, seed):
    """Random planes and queries with planted hits in the randomized
    domain: even queries match one (page, slot) under a full mask, odd
    ones a 4-bit mask of the lo word (about 1 slot in 16), the last is a
    pad query (q = 0, m = 0) that matches every slot.  Returns the
    operands and the planted ``(query, page, slot)`` cells."""
    rng = np.random.default_rng(seed)
    lo, hi = u32(rng, (n_pages, 512)), u32(rng, (n_pages, 512))
    q, m = u32(rng, (n_queries, 2)), u32(rng, (n_queries, 2))
    ids = rng.integers(0, 2048, n_pages).astype(np.uint32)
    seeds = (7 + rng.integers(0, 16, n_pages)).astype(np.uint32)
    s_lo, s_hi = stream_np(ids, seeds)
    planted = []
    for i in range(n_queries):
        if i % 2 == 0:
            p, s = int(rng.integers(n_pages)), int(rng.integers(512))
            q[i] = [lo[p, s] ^ s_lo[p, s], hi[p, s] ^ s_hi[p, s]]
            m[i] = [0xFFFFFFFF, 0xFFFFFFFF]
            planted.append((i, p, s))
        else:
            m[i] = [0xF, 0]
    if n_queries > 2:
        q[-1], m[-1] = 0, 0
    return ([words_to_tensor(a, dev) for a in (lo, hi, q, m, ids, seeds)],
            planted)


def check_search_hits(plain, planted):
    """The planted cells are set in the plain output, and the masked and
    pad queries match many slots: the comparison is not of empty maps."""
    bm = tensor_to_words(plain)
    for i, p, s in planted:
        if not (int(bm[i, p, s // 32]) >> (s % 32)) & 1:
            raise AssertionError(f"planted search hit {(i, p, s)} missing")
    bits = np.unpackbits(bm.view(np.uint8), axis=-1).sum(axis=(1, 2))
    if bits.min() == 0 or (bm.shape[0] > 2 and bits[-1] != bm.shape[1] * 512):
        raise AssertionError(f"search check has too few hits: {bits}")


def one_chunk_bitmaps(rng, n_pages):
    """(N, 2) uint32 chunk bitmaps selecting one random chunk a row, as a
    replay's gathers do (the chunk of the hit)."""
    j = rng.integers(0, 64, n_pages)
    bm = np.zeros((n_pages, 2), np.uint32)
    bm[np.arange(n_pages), j // 32] = np.uint32(1) << (j % 32).astype(
        np.uint32)
    return bm


def gather_case(dev, n_pages, seed, one_chunk=False):
    """Random page planes (lo, hi) and chunk bitmaps: about 32 of 64 chunks
    a row (overflowing a small ``max_out``), one row empty and one all 64;
    with ``one_chunk``, one random chunk a row, the replay's shape."""
    rng = np.random.default_rng(seed)
    planes = [u32(rng, (n_pages, 512)) for _ in range(2)]
    if one_chunk:
        bm = one_chunk_bitmaps(rng, n_pages)
    else:
        bm = u32(rng, (n_pages, 2))
        bm[1] = 0                             # an empty selection
        bm[2] = 0xFFFFFFFF                    # all 64 chunks
    return [words_to_tensor(a, dev) for a in (*planes, bm)]


def lookup_case(dev, n_rows, seed):
    """Random key and value planes with planted hits in the randomized
    domain.  Row i (by i % 4): 0 — a user slot, a later user slot and a
    header slot all match, the first user slot wins; 1 — only a header
    slot matches, a miss; 2 — one user slot; 3 — a random query, a miss.
    Returns the operands and the expected slot of each row."""
    rng = np.random.default_rng(seed)
    klo, khi, vlo, vhi = (u32(rng, (n_rows, 512)) for _ in range(4))
    q = u32(rng, (n_rows, 2))
    m = np.full((n_rows, 2), 0xFFFFFFFF, np.uint32)
    ids = rng.integers(0, 2048, n_rows).astype(np.uint32)
    seeds = (7 + rng.integers(0, 16, n_rows)).astype(np.uint32)
    s_lo, s_hi = stream_np(ids, seeds)
    want = np.full(n_rows, 512, np.int64)
    for i in range(n_rows):
        kind = i % 4
        if kind == 3:
            continue
        s = int(rng.integers(8, 511)) if kind != 1 else int(rng.integers(8))
        q[i] = [klo[i, s] ^ s_lo[i, s], khi[i, s] ^ s_hi[i, s]]
        extra = [int(rng.integers(8)), int(rng.integers(s + 1, 512))] \
            if kind == 0 else []
        for e in extra:                       # the same stored key again
            klo[i, e] = q[i, 0] ^ s_lo[i, e]
            khi[i, e] = q[i, 1] ^ s_hi[i, e]
        if kind != 1:
            want[i] = s
    return ([words_to_tensor(a, dev)
             for a in (klo, khi, vlo, vhi, q, m, ids, seeds)], want)


def check_lookup_hits(plain, want):
    """The plain version finds exactly the planted first user slots, and
    every planted row (header-only misses too) has a nonzero bitmap."""
    bm, _, slots = (tensor_to_words(t) for t in plain)
    if not np.array_equal(slots.astype(np.int64), want):
        raise AssertionError(f"lookup slots {slots} != planted {want}")
    rows = np.arange(len(want)) % 4 != 3
    if not bm[rows].any(axis=1).all():
        raise AssertionError("a planted lookup row has an empty bitmap")


# ------------------------------------------------ in place, cold arena
def place(arena, rows, planes) -> None:
    """Write a case's operands (lo, hi[, ids, seeds]) into ``rows`` of the
    arena."""
    idx = torch.as_tensor(rows, dtype=torch.int64, device=arena[0].device)
    for a, p in zip(arena, planes):
        a.index_copy_(0, idx, p)


def repeat_and_pad(rows):
    """The rows with row 4 repeated at 5 and the last four pad rows (row 0,
    as ``PlaneStore`` pads)."""
    rows = rows.copy()
    rows[5], rows[-4:] = rows[4], 0
    return rows


def search_in_place(dev, arena, seed) -> int:
    """``sim_search`` reading a case's 64 pages, planted hits included, in
    place from random rows of the replay-sized arena: the plain version
    through the rows equals it on the case's own planes, and the kernel
    equals the plain version, also with a repeated row and pad rows."""
    args, planted = search_case(dev, 64, 64, seed)
    rows = np.random.default_rng(seed).choice(np.arange(1, ARENA_ROWS), 64,
                                              replace=False)
    place(arena, rows, [args[0], args[1], args[4], args[5]])
    lo, hi, ids, seeds = arena
    err = 0
    for launch_rows in (rows, repeat_and_pad(rows)):
        idx = words_to_tensor(launch_rows.astype(np.uint32), dev)
        plain = sim_search_ref(lo, hi, args[2], args[3], ids, seeds,
                               randomized=True, rows=idx)
        err = max(err, max_abs_err(
            [sim_search(lo, hi, args[2], args[3], ids, seeds,
                        randomized=True, rows=idx)], [plain]))
        if launch_rows is rows:
            check_search_hits(plain, planted)
            if max_abs_err([plain], [sim_search_ref(*args,
                                                    randomized=True)]):
                raise AssertionError("search through arena rows differs "
                                     "from the case's planes")
    return err


def lookup_in_place(dev, arena, seed) -> int:
    """``sim_fused_lookup`` reading a case's key and value pages in place
    from random rows of the one arena, as ``search_in_place`` does."""
    args, want = lookup_case(dev, 64, seed)
    pick = np.random.default_rng(seed).choice(np.arange(1, ARENA_ROWS), 128,
                                              replace=False)
    key_rows, value_rows = pick[:64], pick[64:]
    place(arena, key_rows, [args[0], args[1], args[6], args[7]])
    place(arena, value_rows, [args[2], args[3]])
    lo, hi, ids, seeds = arena
    err = 0
    for k, v in ((key_rows, value_rows),
                 (repeat_and_pad(key_rows), repeat_and_pad(value_rows))):
        kw = dict(randomized=True,
                  key_rows=words_to_tensor(k.astype(np.uint32), dev),
                  value_rows=words_to_tensor(v.astype(np.uint32), dev))
        plain = sim_lookup_ref(lo, hi, lo, hi, args[4], args[5], ids, seeds,
                               **kw)
        err = max(err, max_abs_err(sim_fused_lookup(
            lo, hi, lo, hi, args[4], args[5], ids, seeds, **kw), plain))
        if k is key_rows:
            check_lookup_hits(plain, want)
            if max_abs_err(plain, sim_lookup_ref(*args, randomized=True)):
                raise AssertionError("lookup through arena rows differs "
                                     "from the case's planes")
    return err


def gather_in_place(dev, arena, seed) -> int:
    """``sim_gather`` reading a case's 64 pages in place from random rows of
    the replay-sized arena, as ``search_in_place`` does, at max_out 64 and
    4; repeated rows and pad rows (row 0, bitmap 0: they gather nothing)
    too."""
    lo_c, hi_c, bm = gather_case(dev, 64, seed)
    rows = np.random.default_rng(seed).choice(np.arange(1, ARENA_ROWS), 64,
                                              replace=False)
    place(arena, rows, [lo_c, hi_c])
    lo, hi = arena[:2]
    err = 0
    for launch_rows in (rows, repeat_and_pad(rows)):
        idx = words_to_tensor(launch_rows.astype(np.uint32), dev)
        sel = torch.where(idx[:, None] == 0, 0, bm)
        for max_out in (64, 4):
            plain = sim_gather_ref(lo, hi, sel, max_out, rows=idx)
            err = max(err, max_abs_err(
                sim_gather(lo, hi, sel, max_out, rows=idx), plain))
            if launch_rows is rows and max_abs_err(
                    plain, sim_gather_ref(lo_c, hi_c, sel, max_out)):
                raise AssertionError("gather through arena rows differs "
                                     "from the case's planes")
    return err


def search_cold(dev, arena, q, m):
    """Device ms of a search flush (the kernel in place) on 64 fresh random
    arena rows a launch."""
    sets = row_sets(COLD_ITERS + 2, 64, ARENA_ROWS, 11, dev)
    lo, hi, ids, seeds = arena
    return cold_ms(lambda i: sim_search(lo, hi, q, m, ids, seeds,
                                        randomized=True, rows=sets[i]),
                   COLD_ITERS, dev)


def lookup_cold(dev, arena):
    """Device ms of a lookup flush (the kernel in place) of 64 rows, fresh
    random key and value rows a launch, 48 planted hits.  Returns the time
    and one launch's slots."""
    keys = row_sets(COLD_ITERS + 2, 64, ARENA_ROWS, 12, dev)
    values = row_sets(COLD_ITERS + 2, 64, ARENA_ROWS, 13, dev,
                      exclude=keys.cpu().numpy())
    q = planted_lookup_queries(*arena, keys, 14)
    m = torch.full((64, 2), -1, dtype=torch.int32, device=dev)
    lo, hi, ids, seeds = arena

    def in_place(i):
        return sim_fused_lookup(lo, hi, lo, hi, q[i], m, ids, seeds,
                                randomized=True, key_rows=keys[i],
                                value_rows=values[i])
    return cold_ms(in_place, COLD_ITERS, dev), in_place(0)[2]


def gather_cold(dev, arena):
    """Device ms of a gather flush (the kernel in place) of 64 rows, fresh
    random arena rows a launch, one chunk selected a row, max_out = 64.
    Returns the time and one launch's bitmap."""
    sets = row_sets(COLD_ITERS + 2, 64, ARENA_ROWS, 15, dev)
    rng = np.random.default_rng(16)
    bms = words_to_tensor(np.stack([one_chunk_bitmaps(rng, 64)
                                    for _ in range(COLD_ITERS + 2)]), dev)
    lo, hi = arena[:2]
    return cold_ms(lambda i: sim_gather(lo, hi, bms[i], 64, rows=sets[i]),
                   COLD_ITERS, dev), bms[0]


def search_bound(n_pages, n_queries, in_place=False):
    """Work of one launch; ``in_place`` adds the (N,) row indices read."""
    ops = (n_pages * 512 * STREAM_OPS + n_queries * n_pages * 512 * MATCH_OPS
           + n_queries * n_pages * 16)                        # + ballots
    nbytes = (2 * n_pages * 512 * 4 + 2 * n_queries * 2 * 4 + 2 * n_pages * 4
              + n_queries * n_pages * 16 * 4 + in_place * n_pages * 4)
    return ops, nbytes


def gather_bound(bitmap, max_out, in_place=False):
    """Work of one launch: the bitmaps, the kept chunks read once, the
    outputs written once; ``in_place`` adds the (N,) row indices read."""
    bm = tensor_to_words(bitmap).astype(np.uint64)
    counts = np.array([bin(int(lo) | (int(hi) << 32)).count("1")
                       for lo, hi in bm])
    n = bm.shape[0]
    ops = n * 64 * 4                          # shift, test, popcount, compare
    nbytes = (n * 8 + int(np.minimum(counts, max_out).sum()) * 64
              + n * max_out * 64 + n * 4 + in_place * n * 4)
    return ops, nbytes


def lookup_bound(n_rows, slots, in_place=False):
    """Work of one launch: the key planes, one 64 B value chunk a hit (the
    value planes' prefetch into L2 is not counted), the outputs; ``in_place``
    adds the two (B,) row indices read."""
    hits = int((tensor_to_words(slots) < 512).sum())
    ops = n_rows * 512 * (STREAM_OPS + MATCH_OPS) + n_rows * 16
    nbytes = (2 * n_rows * 512 * 4 + 2 * n_rows * 2 * 4 + 2 * n_rows * 4
              + hits * 64 + n_rows * (64 + 64 + 4) + in_place * n_rows * 8)
    return ops, nbytes


def plan_groups(keys, rng, kind):
    """Plan groups over (N, 512) 64-bit domain keys whose page 0 slots
    100..163 hold ``base + 0..63``, and the planted (group, slot) cells on
    page 0 that must be set and cleared.

    ``check``: an exact range around ``base`` with an exclude block on
    slot 102, a group of exclude passes only (no include: all zero), an
    approximate range and an all-PAD group.  ``replay``: one exact range
    of 100 keys, the replay's scan shape.  ``work``: two exact ranges
    2^40 wide, about 90 passes each (exact 64-bit plans)."""
    base = int(keys[0, 100])
    if kind == "check":
        return ([RangePlan(exact_range(base + 1, base + 49).include,
                           exact_range(base + 2, base + 3).include),
                 RangePlan((), exact_range(base, base + 4).include),
                 approximate_range(base, base + 40), RangePlan(())],
                [(0, 101)], [(0, 102), (1, 101)])
    if kind == "replay":
        return [exact_range(base + 1, base + 101)], [(0, 101)], [(0, 100)]
    return ([exact_range(base - int(rng.integers(2**39, 2**40)),
                         base + int(rng.integers(2**39, 2**40)))
             for _ in range(2)], [(0, 101), (1, 101)], [])


def plan_case(dev, n_pages, p_pad, kind, seed):
    """Random domain keys with a planted run on page 0, the ``kind`` plan
    groups as pass rows padded to ``p_pad`` (PASS_PAD rows), and the
    stored planes randomized by the §IV-C1 stream.  Returns the operands,
    the expected bits from direct evaluation of the plans on the keys,
    and the planted set / cleared cells."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**48, (n_pages, 512), dtype=np.uint64)
    keys[0, 100:164] = (int(rng.integers(2**41, 2**47))
                        + np.arange(64, dtype=np.uint64))
    plans, set_cells, clear_cells = plan_groups(keys, rng, kind)
    q = np.zeros((len(plans), p_pad, 2), np.uint32)
    m, f = np.zeros_like(q), np.zeros((len(plans), p_pad), np.uint32)
    for g, plan in enumerate(plans):
        cmd = Command.plan(0, plan.include, plan.exclude)
        q[g], m[g], f[g] = plan_pass_rows(cmd.plan_include, cmd.plan_exclude,
                                          p_pad)
    ids = rng.integers(0, 2048, n_pages).astype(np.uint32)
    seeds = (7 + rng.integers(0, 16, n_pages)).astype(np.uint32)
    s_lo, s_hi = stream_np(ids, seeds)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ s_lo
    hi = (keys >> np.uint64(32)).astype(np.uint32) ^ s_hi
    want = np.stack([plan.evaluate(keys) for plan in plans])
    return ([words_to_tensor(a, dev) for a in (lo, hi, q, m, f, ids, seeds)],
            want, set_cells, clear_cells)


def check_plan_hits(plain, want, set_cells, clear_cells):
    """The plain version's bits equal direct evaluation of the plans, the
    planted include hits are set, the excluded ones cleared, and each
    group with an include pass has hits: not a comparison of empty maps."""
    bits = np.unpackbits(tensor_to_words(plain).view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)
    if not np.array_equal(bits, want):
        raise AssertionError("plain plan bitmaps differ from direct "
                             "evaluation of the plans")
    for g, s in set_cells:
        if not bits[g, 0, s]:
            raise AssertionError(f"planted plan hit {(g, s)} missing")
    for g, s in clear_cells:
        if bits[g, 0, s]:
            raise AssertionError(f"excluded plan cell {(g, s)} is set")


def plan_bound(flags, n_pages):
    """Work of one launch: the stream once per (page, slot), the real
    (non-PAD) passes per slot, the combine and ballots per (group, page)."""
    f = tensor_to_words(flags)
    n_groups, p_pad = f.shape
    real = int((f != 0).sum())
    ops = (n_pages * 512 * STREAM_OPS + real * n_pages * 512 * PASS_OPS
           + n_groups * n_pages * (512 + 16))
    nbytes = (2 * n_pages * 512 * 4 + n_groups * p_pad * 5 * 4
              + 2 * n_pages * 4 + n_groups * n_pages * 16 * 4)
    return ops, nbytes


def fused_case(dev, n_pages, n_queries, seed):
    """Random planes of N pages spread over 16 chips (page i at address
    i % (N / 16) on chip i // (N / 16), seed 7 + chip), with planted hits in
    the randomized domain: even queries match one (page, slot) under a full
    mask, odd ones a 4-bit mask of the lo word (about 26 chunks a page, past
    ``max_out``), and the last has mask 0, which selects all 64 chunks of
    every page.  Returns the operands and the planted cells."""
    rng = np.random.default_rng(seed)
    lo, hi = u32(rng, (n_pages, 512)), u32(rng, (n_pages, 512))
    per_chip = max(n_pages // 16, 1)
    ids = (np.arange(n_pages) % per_chip).astype(np.uint32)
    seeds = (7 + np.arange(n_pages) // per_chip).astype(np.uint32)
    s_lo, s_hi = stream_np(ids, seeds)
    q, m = u32(rng, (n_queries, 2)), u32(rng, (n_queries, 2))
    planted = []
    for i in range(n_queries - 1):
        if i % 2 == 0:
            p, s = int(rng.integers(n_pages)), int(rng.integers(512))
            q[i] = [lo[p, s] ^ s_lo[p, s], hi[p, s] ^ s_hi[p, s]]
            m[i] = [0xFFFFFFFF, 0xFFFFFFFF]
            planted.append((i, p, s))
        else:
            m[i] = [0xF, 0]
    q[-1], m[-1] = 0, 0
    return ([words_to_tensor(a, dev) for a in (lo, hi, q, m, ids, seeds)],
            planted)


def check_fused_hits(plain, args, planted, max_out):
    """The plain version holds the planted hits, their chunks gathered as
    stored; the mask-0 query counts 64 chunks on every page and gathers
    chunks 0..max_out-1 (zero rows past the 64th); the 4-bit masks (about
    26 chunks a page) overflow a ``max_out`` of 16 or less."""
    bm, out, cnt = (tensor_to_words(t) for t in plain)
    cnt = cnt.view(np.int32)
    chunks = tensor_to_words(planes_to_chunk_words(args[0], args[1]))
    for i, p, s in planted:
        if not (int(bm[i, p, s // 32]) >> (s % 32)) & 1:
            raise AssertionError(f"planted fused hit {(i, p, s)} missing")
        rows = out[i, p, :min(int(cnt[i, p]), max_out)]
        if not (rows == chunks[p, s // 8]).all(axis=1).any():
            raise AssertionError(f"planted fused hit {(i, p, s)}: its chunk "
                                 "was not gathered")
    kept = min(max_out, 64)                   # rows past 64 stay zero
    if not ((cnt[-1] == 64).all()
            and np.array_equal(out[-1, :, :kept], chunks[:, :kept])
            and not out[-1, :, kept:].any()):
        raise AssertionError("the mask-0 query did not select and gather "
                             "every chunk")
    if cnt.shape[0] > 2 and max_out <= 16 and not (cnt[1] > max_out).any():
        raise AssertionError("no fused cell overflowed max_out")


def fused_bound(n_pages, n_queries, max_out):
    cells = n_queries * n_pages
    ops = (n_pages * 512 * STREAM_OPS + cells * 512 * MATCH_OPS
           + cells * (16 + 64 * 3))       # ballots; chunk test, rank, compare
    nbytes = (2 * n_pages * 512 * 4 + 2 * n_pages * 4 + 2 * n_queries * 2 * 4
              + cells * (16 * 4 + max_out * 64 + 4))
    return ops, nbytes


# ------------------------------------------------- chip-axis forms
# The sharded backend's launch shapes: C chips, the last a pad chip (rows
# at arena row 0, pad queries or PAD plan rows) when C > 1.
CHIP_COUNTS = (1, 3, 16)


def chip_axis_rows(rows_per_chip, pad):
    """(C, R) arena rows from each chip's own rows; with ``pad``, chip 1
    repeats a row of chip 0, every chip's last four rows are pad rows
    (row 0) and, with C > 1, the last chip is a pad chip."""
    rows = np.stack(rows_per_chip).astype(np.int32)
    if pad:
        rows[:, -4:] = 0
        if len(rows) > 1:
            rows[1, 0] = rows[0, 1]
            rows[-1] = 0
    return rows


def search_chips_checks(dev, arena, floor_ms) -> dict:
    """The chip-axis ``sim_search`` in place at Q = 64 and R = 64 a chip,
    C = 1, 3 and 16: chip c's case (planted hits) in random rows of the
    replay-sized arena.  The plain version through the rows equals each
    case's own planes; the kernel equals the plain version, also with pad
    chips, pad rows and a row repeated across chips.  Timed warm beside one
    flat launch of as many (query, page) cells: chip 0's 64 queries over
    all C * 64 rows."""
    lo, hi, ids, seeds = arena
    out = {}
    for n_chips in CHIP_COUNTS:
        rng = np.random.default_rng(100 + n_chips)
        picks = rng.choice(np.arange(1, ARENA_ROWS), 64 * n_chips,
                           replace=False).reshape(n_chips, 64)
        cases, err = [], 0
        for c in range(n_chips):
            args, planted = search_case(dev, 64, 64, 200 + 17 * n_chips + c)
            place(arena, picks[c], [args[0], args[1], args[4], args[5]])
            cases.append((args, planted))
        q = torch.stack([args[2] for args, _ in cases])
        m = torch.stack([args[3] for args, _ in cases])
        for pad in (False, True):
            idx = torch.from_numpy(chip_axis_rows(list(picks), pad)).to(dev)
            plain = sim_search_chips_ref(lo, hi, q, m, ids, seeds,
                                         randomized=True, rows=idx)
            err = max(err, max_abs_err(
                [sim_search_chips(lo, hi, q, m, ids, seeds, randomized=True,
                                  rows=idx)], [plain]))
            if pad:
                continue
            for c, (args, planted) in enumerate(cases):
                check_search_hits(plain[c], planted)
                if max_abs_err([plain[c]],
                               [sim_search_ref(*args, randomized=True)]):
                    raise AssertionError("chip-axis search through arena "
                                         "rows differs from the case's planes")
        del cases
        ms_chips = device_ms(lambda: sim_search_chips(
            lo, hi, q, m, ids, seeds, randomized=True, rows=idx), 200)
        flat_rows = idx.reshape(-1)
        ms_flat = device_ms(lambda: sim_search(
            lo, hi, q[0], m[0], ids, seeds, randomized=True,
            rows=flat_rows), 200)
        plain_ms = device_ms(lambda: sim_search_chips_ref(
            lo, hi, q, m, ids, seeds, randomized=True, rows=idx),
            20 if n_chips < 16 else 3)
        work = search_bound(64, 64, in_place=True)
        b = bound(n_chips * work[0], n_chips * work[1])
        out[n_chips] = dict(max_abs_err=err, ms=ms_chips, flat_ms=ms_flat,
                            plain_ms=plain_ms, bound=b)
        log(f"kernel sim_search chip axis [C={n_chips}, Q=64 x R=64 a chip, "
            f"in place{', last chip a pad chip' if n_chips > 1 else ''}]: "
            f"bit-exact vs plain; {ms_chips:.6f} ms/launch "
            f"({ms_chips - floor_ms:.6f} above the launch floor), one flat "
            f"launch of as many cells (chip 0's Q=64 x N={64 * n_chips}) "
            f"{ms_flat:.6f} ms, plain {plain_ms:.6f} ms, bound {b[0]:.6f} ms "
            f"({b[1]})")
    return out


def plan_chips_checks(dev, floor_ms) -> dict:
    """The chip-axis ``sim_plan`` at G = 2, P = 16 and R = 32 a chip, C = 1,
    3 and 16, over copied planes (as the sharded flush's ``take2d`` gives
    them): chip c runs the check plan of ``plan_case`` (exact range with an
    exclude) and one of its other groups (exclude only, approximate, all
    PAD).  The plain version equals direct evaluation on each real chip's
    unpadded pages; the kernel equals the plain version, pad chip (PAD
    rows) and pad rows (copies of one page) included.  Timed warm beside
    one flat launch of as many (group, page) cells: chip 0's two groups
    over all C * 32 pages.  That launch runs real passes on the pad chip's
    pages too, where the chip-axis form runs only PAD rows."""
    out = {}
    for n_chips in CHIP_COUNTS:
        parts, direct = [], []
        for c in range(n_chips):
            args, want, _, _ = plan_case(dev, 32, 16, "check",
                                         300 + 17 * n_chips + c)
            groups = [0, 1 + c % 3]
            planes = [t.clone() for t in (args[0], args[1], args[5],
                                          args[6])]
            sel = [args[k][groups] for k in (2, 3, 4)]
            direct.append(sim_plan_ref(*planes[:2], *sel, *planes[2:],
                                       randomized=True))
            check_plan_hits(direct[-1], want[groups], [(0, 101)],
                            [(0, 102)])
            parts.append((planes, sel))
        pad_page = [p[0:1] for p in parts[0][0]]     # the pad rows' page
        for c, (planes, sel) in enumerate(parts):
            for p, pad in zip(planes, pad_page):
                p[-4:] = pad
            if n_chips > 1 and c == n_chips - 1:    # the pad chip
                for p, pad in zip(planes, pad_page):
                    p[:] = pad
                for t in sel:
                    t.zero_()
        lo, hi, ids, seeds = (torch.stack([pl[i] for pl, _ in parts])
                              for i in range(4))
        q, m, f = (torch.stack([sl[i] for _, sl in parts]) for i in range(3))
        chips_args = (lo, hi, q, m, f, ids, seeds)
        plain = sim_plan_chips_ref(*chips_args, randomized=True)
        err = max_abs_err([sim_plan_chips(*chips_args, randomized=True)],
                          [plain])
        for c in range(n_chips - (n_chips > 1)):    # the unpadded pages
            if max_abs_err([plain[c, :, :-4]], [direct[c][:, :-4]]):
                raise AssertionError("chip-axis plan differs from direct "
                                     "evaluation of its chip's plans")
        if n_chips > 1 and (plain[-1] != 0).any():
            raise AssertionError("the pad chip's PAD rows matched")
        ms_chips = device_ms(lambda: sim_plan_chips(*chips_args,
                                                    randomized=True), 200)
        flat = (lo.reshape(-1, 512), hi.reshape(-1, 512), q[0], m[0], f[0],
                ids.reshape(-1), seeds.reshape(-1))
        ms_flat = device_ms(lambda: sim_plan(*flat, randomized=True), 200)
        plain_ms = device_ms(lambda: sim_plan_chips_ref(
            *chips_args, randomized=True), 10 if n_chips < 16 else 3)
        works = [plan_bound(f[c], 32) for c in range(n_chips)]
        b = bound(sum(w[0] for w in works), sum(w[1] for w in works))
        out[n_chips] = dict(max_abs_err=err, ms=ms_chips, flat_ms=ms_flat,
                            plain_ms=plain_ms, bound=b)
        log(f"kernel sim_plan chip axis [C={n_chips}, G=2, P=16, R=32 a chip"
            f"{', last chip a pad chip' if n_chips > 1 else ''}]: bit-exact "
            f"vs plain; {ms_chips:.6f} ms/launch ({ms_chips - floor_ms:.6f} "
            f"above the launch floor), one flat launch of as many cells "
            f"(chip 0's G=2 x N={32 * n_chips}) {ms_flat:.6f} ms, plain "
            f"{plain_ms:.6f} ms, bound {b[0]:.6f} ms ({b[1]})")
    return out


# (label, dtype, (B, Sq, Sk, H, Hkv, D), masks): qwen3-4b's prefill and
# decode shapes on the serve path, the reduced qwen3-4b's (16-wide heads),
# the JAX package's sweep shape, olmo-1b's training forward, and the model
# families' forms: hymba's 25 q heads over 5 kv heads (group 5, head dim
# 64) in windowed and global prefill and in ring decode, whisper's
# non-causal encoder and cross-attention over 1,500 frames, mixtral's
# decode and internvl2's prefill; phase 10's tensor-parallel shapes: rank 0
# of the 16 x 16 mesh in olmo-1b's train_4k (its 1 local q head over 1 kv
# head) and the float32 world of one.
ATTN_CASES = [
    ("qwen3-4b prefill", torch.bfloat16, (1, 16, 16, 32, 8, 128),
     dict(causal=True)),
    ("qwen3-4b decode, q_offset 5", torch.bfloat16, (1, 1, 128, 32, 8, 128),
     dict(causal=True, q_offset=5)),
    ("qwen3-4b decode, q_offset 127", torch.bfloat16,
     (1, 1, 128, 32, 8, 128), dict(causal=True, q_offset=127)),
    ("reduced qwen3-4b prefill", torch.bfloat16, (1, 16, 16, 4, 2, 16),
     dict(causal=True)),
    ("reduced qwen3-4b decode, q_offset 20", torch.bfloat16,
     (1, 1, 128, 4, 2, 16), dict(causal=True, q_offset=20)),
] + [(f"sweep {dt} {name}", dt, (2, 256, 256, 4, 2, 64), kw)
     for dt in (torch.float32, torch.bfloat16)
     for name, kw in (("causal", dict(causal=True)),
                      ("non-causal", dict(causal=False)),
                      ("window 128", dict(causal=True, window=128)))] + [
    ("olmo-1b training forward", torch.bfloat16,
     (8, 512, 512, 16, 16, 128), dict(causal=True)),
    ("hymba-1.5b prefill, window 1024", torch.bfloat16,
     (1, 1536, 1536, 25, 5, 64), dict(causal=True, window=1024)),
    ("hymba-1.5b prefill, global layer", torch.bfloat16,
     (1, 1536, 1536, 25, 5, 64), dict(causal=True)),
    ("hymba-1.5b ring decode, q_offset 1023", torch.bfloat16,
     (1, 1, 1024, 25, 5, 64), dict(causal=True, q_offset=1023)),
    ("hymba-1.5b ring decode, q_offset 300", torch.bfloat16,
     (1, 1, 1024, 25, 5, 64), dict(causal=True, q_offset=300)),
    ("hymba-1.5b float32 window 100", torch.float32,
     (1, 300, 300, 25, 5, 64), dict(causal=True, window=100)),
    ("whisper-medium encoder, non-causal", torch.bfloat16,
     (1, 1500, 1500, 16, 16, 64), dict(causal=False)),
    ("whisper-medium cross-attention prefill", torch.bfloat16,
     (1, 8, 1500, 16, 16, 64), dict(causal=False)),
    ("whisper-medium cross-attention decode", torch.bfloat16,
     (1, 1, 1500, 16, 16, 64), dict(causal=False)),
    ("mixtral-8x22b decode, q_offset 20", torch.bfloat16,
     (1, 1, 128, 48, 8, 128), dict(causal=True, q_offset=20)),
    ("internvl2-26b prefill", torch.bfloat16, (1, 320, 320, 48, 8, 128),
     dict(causal=True)),
    ("olmo-1b train_4k, rank 0 of 16 x 16: 1 q head over 1 kv head",
     torch.bfloat16, (16, 4096, 4096, 1, 1, 128), dict(causal=True)),
    ("olmo-1b tensor-parallel world of one, float32", torch.float32,
     (4, 256, 256, 16, 16, 128), dict(causal=True))]
# Timed for the kernels line: a decode step of the serve path, whose
# positions run from 4 to 27 in a 128-slot cache.
ATTN_TIMED = ("qwen3-4b decode, q_offset 16", torch.bfloat16,
              (1, 1, 128, 32, 8, 128), dict(causal=True, q_offset=16))
ATTN_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


def attn_inputs(dev, dtype, shape, seed):
    b, sq, sk, h, hkv, d = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32))
            .to(dev, dtype) for s, n in ((sq, h), (sk, hkv), (sk, hkv))]


def attn_keep(shape, kw):
    """(Sq, Sk) bool: which keys each query row sees."""
    _, sq, sk = shape[:3]
    q_offset = kw.get("q_offset", sk - sq)
    row = q_offset + np.arange(sq)[:, None]
    col = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if kw.get("causal", True):
        keep &= col <= row
    if kw.get("window") is not None:
        keep &= col > row - kw["window"]
    return keep


def attn_bound(dtype, shape, kw, lse=False):
    """The multiply-adds of the visible (query, key) pairs of QK^T and PV at
    the dtype's peak (the count the kernel's flop formula gives), against q
    and the output once (with ``lse`` the float32 log-sum-exps too) and the
    k/v rows some row sees once."""
    b, sq, sk, h, hkv, d = shape
    masks = dict(causal=kw.get("causal", True), window=kw.get("window"),
                 q_offset=kw.get("q_offset"))
    _, seen = attention_pairs(sq, sk, **masks)
    es = torch.finfo(dtype).bits // 8
    flops = attention_flops(b, sq, sk, h, d, **masks)
    nbytes = es * (2 * b * h * sq * d + 2 * b * hkv * seen * d) \
        + (4 * b * sq * h if lse else 0)
    peak = PEAK_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa(q, k, v, shape, kw):
    """PyTorch's fused attention on the same inputs and masks, in its
    fastest form for the case (the library yardstick; the port never calls
    it): a causal prefill with aligned ends as ``is_causal``; a one-row
    causal decode with k and v cut to the visible keys ``[: q_offset + 1]``
    and no mask, so that SDPA takes its flash path; a boolean mask only
    where neither form fits."""
    sq, sk = shape[1], shape[2]
    causal, window = kw.get("causal", True), kw.get("window")
    q_offset = kw.get("q_offset", sk - sq)
    plain_causal = causal and window is None and q_offset == 0 and sq == sk
    mask = None
    if sq == 1 and causal and window is None and 0 <= q_offset < sk:
        k, v = k[:, :q_offset + 1], v[:, :q_offset + 1]
    elif not plain_causal and not attn_keep(shape, kw).all():
        mask = torch.from_numpy(attn_keep(shape, kw)).to(q.device)
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=plain_causal, enable_gqa=True)


def attention_checks(dev, floor_ms) -> dict:
    """Flash attention against its plain version at every case, within
    ATTN_TOL; times of kernel, plain version and library at each case."""
    err = 0.0
    for i, (label, dtype, shape, kw) in enumerate(ATTN_CASES + [ATTN_TIMED]):
        q, k, v = attn_inputs(dev, dtype, shape, i)
        got = flash_attention(q, k, v, **kw).float()
        plain = attention_ref(q, k, v, **kw).float()
        lib = sdpa(q, k, v, shape, kw).transpose(1, 2).float()
        tol = ATTN_TOL[dtype]
        diff = (got - plain).abs()
        if not (diff <= tol + tol * plain.abs()).all():
            raise AssertionError(f"flash_attention [{label}]: max abs err "
                                 f"{float(diff.max())} beyond {tol}")
        if not torch.isfinite(got).all() or float(plain.abs().max()) == 0:
            raise AssertionError(f"flash_attention [{label}]: bad output")
        err = max(err, float(diff.max()))
        row = dict(
            ms=device_ms(lambda: flash_attention(q, k, v, **kw), 100),
            plain_ms=device_ms(lambda: attention_ref(q, k, v, **kw), 20),
            library_ms=device_ms(lambda: sdpa(q, k, v, shape, kw), 100),
            bound=attn_bound(dtype, shape, kw))
        log(f"kernel flash_attention [{label}, {tuple(shape)}]: max abs err "
            f"{float(diff.max()):.3e} (tol {tol}), library max abs err "
            f"{float((lib - plain).abs().max()):.3e}; {row['ms']:.6f} "
            f"ms/launch ({row['ms'] - floor_ms:.6f} above the launch floor), "
            f"plain {row['plain_ms']:.6f} ms, library "
            f"{row['library_ms']:.6f} ms (kernel/library "
            f"{row['ms'] / row['library_ms']:.3f}), bound "
            f"{row['bound'][0]:.6f} ms ({row['bound'][1]})")
    return dict(max_abs_err=err, shape=ATTN_TIMED[0], **row)


# The kernel's log-sum-exp output, which the sharded decode step merges the
# ranks' partial attentions by (phase 11), at those ranks' decode shapes:
# rank 0 of qwen3-4b decode_32k on the 16 x 16 mesh (8 rows, 32 q heads
# over its 2,048-slot slice of 8 kv heads, every slot seen), slices that
# see half their slots and none, hymba-1.5b's rank 0 (64 ring slots of 5
# kv heads), and phase 11 (a)'s float32 world of one.  The log-sum-exp is
# held at LSE_TOL (absolute, and relative to its size), the output at
# ATTN_TOL and equal bit for bit to the launch without the log-sum-exp.
QWEN_RANK0 = (8, 1, 2048, 32, 8, 128)
ATTN_LSE_CASES = [
    ("qwen3-4b decode_32k, rank 0 of 16 x 16, every slot seen",
     torch.bfloat16, QWEN_RANK0, dict(causal=True, q_offset=32767)),
    ("qwen3-4b decode_32k slice, half its slots seen", torch.bfloat16,
     QWEN_RANK0, dict(causal=True, q_offset=1023)),
    ("qwen3-4b decode_32k slice, no slot seen", torch.bfloat16, QWEN_RANK0,
     dict(causal=True, q_offset=-1)),
    ("hymba-1.5b decode_32k, rank 0 of 16 x 16, 64 ring slots",
     torch.bfloat16, (8, 1, 64, 25, 5, 64), dict(causal=True, q_offset=1023)),
    ("qwen3-4b world of one, float32", torch.float32,
     (2, 1, 128, 32, 8, 128), dict(causal=True, q_offset=67)),
    ("hymba-1.5b world of one ring, float32", torch.float32,
     (2, 1, 1024, 25, 5, 64), dict(causal=True, q_offset=1023))]
LSE_TOL = 1e-5


def attention_lse_checks(dev) -> None:
    """The kernel with ``return_lse`` against ``attention_ref``'s at each of
    ATTN_LSE_CASES; times of the kernel (and of its launch without the
    log-sum-exp), the plain version (with its log-sum-exp) and SDPA
    (output only) beside the bound, which counts the log-sum-exp's float32
    bytes too."""
    for i, (label, dtype, shape, kw) in enumerate(ATTN_LSE_CASES):
        q, k, v = attn_inputs(dev, dtype, shape, 100 + i)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        alone = flash_attention(q, k, v, **kw)
        p_out, p_lse = attention_ref(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, alone):
            raise AssertionError(f"flash_attention [{label}]: the output "
                                 "with the log-sum-exp differs from the one "
                                 "without")
        tol = ATTN_TOL[dtype]
        d_out = float((out.float() - p_out.float()).abs().max())
        if not ((out.float() - p_out.float()).abs()
                <= tol + tol * p_out.float().abs()).all():
            raise AssertionError(f"flash_attention [{label}]: output "
                                 f"{d_out} beyond {tol}")
        d_lse = (lse - p_lse).abs()
        if not (d_lse <= LSE_TOL + LSE_TOL * p_lse.abs()).all() or \
                not torch.isfinite(lse).all():
            raise AssertionError(f"flash_attention [{label}]: log-sum-exp "
                                 f"{float(d_lse.max())} beyond {LSE_TOL}")
        ms = device_ms(lambda: flash_attention(q, k, v, return_lse=True,
                                               **kw), 100)
        alone_ms = device_ms(lambda: flash_attention(q, k, v, **kw), 100)
        plain_ms = device_ms(lambda: attention_ref(q, k, v, return_lse=True,
                                                   **kw), 20)
        lib_ms = device_ms(lambda: sdpa(q, k, v, shape, kw), 100)
        t_bound, by = attn_bound(dtype, shape, kw, lse=True)
        log(f"kernel flash_attention with its log-sum-exp [{label}, "
            f"{tuple(shape)}, q_offset {kw['q_offset']}]: output max abs err "
            f"{d_out:.3e} (tol {tol}), log-sum-exp max abs err "
            f"{float(d_lse.max()):.3e} (tol {LSE_TOL}), the output equal to "
            f"the launch without it; {ms:.6f} ms/launch (without it "
            f"{alone_ms:.6f}), plain "
            f"{plain_ms:.6f} ms, library (SDPA, output only) {lib_ms:.6f} "
            f"ms (kernel/library {ms / lib_ms:.3f}), bound {t_bound:.6f} ms "
            f"({by})")


def bound(ops, nbytes, rate=INT32_OPS):
    t_ops, t_bytes = ops / rate, nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# The mamba heads' kernels at hymba-1.5b-base's widths (e 3,200, N 16,
# K 4, bf16): checked at B 1 and 2 over S 1, 16, 17 and 1,024, and timed
# at B 1 over MAMBA_TIMED: a decode step, chat-long's longest prompt and
# its long sessions' context.  The state is float32 and updated as the
# plain version updates it, so it stays within MAMBA_STATE_TOL relative;
# y's c . h sum runs in another order, so a bf16 output may round an ulp
# apart, which the gate's product scales and rounds again: at least
# MAMBA_Y_EXACT of the outputs bit for bit, the rest within
# MAMBA_Y_ULPS ulps or, where the sum cancels to near 0, within
# MAMBA_Y_NEAR of the largest output (tests/test_torch_gpu.py's rule).
MAMBA_ARCH = "hymba-1.5b-base"
MAMBA_CHECKED = ((1, 1), (1, 16), (1, 17), (1, 1024), (2, 1), (2, 17),
                 (2, 1024))
MAMBA_TIMED = (1, 1024, 6144)
MAMBA_STATE_TOL = 1e-5
MAMBA_Y_EXACT, MAMBA_Y_ULPS, MAMBA_Y_NEAR = 0.999, 3, 1e-6


def mamba_inputs(dev, cfg, b, s, seed):
    """xz, a nonzero conv tail, conv_w, proj, a_log, d_skip and a nonzero
    state on the card at ``cfg``'s widths, in its dtype."""
    e, n, k = cfg.mamba_width, cfg.ssm_state, cfg.ssm_conv
    dt = getattr(torch, cfg.dtype)
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, device=dev, generator=g)
                * scale).to(dtype)
    return dict(xz=randn(b, s, 2 * e, dtype=dt),
                conv_tail=randn(b, k - 1, e, dtype=dt),
                conv_w=randn(k, e, scale=0.5, dtype=dt),
                proj=randn(b, s, 2 * n + 1, dtype=dt),
                a_log=randn(e, n, scale=0.5), d_skip=randn(e),
                state=randn(b, e, n))


def mamba_plain(c):
    """ref.py's conv and scan on ``mamba_inputs``: (u, tail, y, state)."""
    e = c["conv_w"].shape[1]
    u, tail = causal_conv_ref(c["xz"][..., :e], c["conv_tail"], c["conv_w"])
    y, h = selective_scan_ref(u, c["xz"][..., e:], c["proj"].float(),
                              c["a_log"], c["d_skip"], c["state"])
    return u, tail, y, h


def mamba_bounds(b, s, e, n, k, esize):
    """The conv's and the scan's (operations, bytes).  The conv: per
    (position, channel) K products and sums and the SiLU (4); it reads u,
    the tail and the taps and writes y and the tail.  The scan: per
    (position, channel, state) delta a, its exp, the decay's product, the
    drive's product with b, the sum, c h and a step of c . h's sum (7); per
    (position, channel) delta u, the skip's product and sum, silu(z) (4)
    and the gate (9); it reads proj, u, z, a_log, d_skip and the state and
    writes y and the state."""
    conv = (b * s * e * (2 * k + 4),
            (2 * b * s * e + 2 * b * (k - 1) * e + k * e) * esize)
    scan = (b * s * e * (7 * n + 9),
            b * s * (2 * n + 1) * esize + 3 * b * s * e * esize
            + e * n * 4 + e * 4 + 2 * b * e * n * 4)
    return conv, scan


def bf16_ulps(got, want):
    """Each bf16 output's distance from the plain version's, in ulps of the
    plain value (2^(e - 8) for a value of binade 2^(e - 1))."""
    got, want = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    return (got - want).abs() / ulp.clamp_min(2.0 ** -133)


def mamba_checks(dev, floor_ms) -> dict:
    """``mamba_conv`` and ``mamba_scan`` against ref.py on the card at
    MAMBA_CHECKED and MAMBA_TIMED (the module's constants above), a launch
    each a call; device times of each kernel and of the plain version (the
    conv and the scan together) beside each kernel's bound (its float32
    operations over F32_FLOPS, its bytes over HBM_BW) at MAMBA_TIMED.  The
    rows hold the decode step's (B 1, S 1) numbers and each timed
    length's."""
    cfg = get_config(MAMBA_ARCH)
    e, n, k = cfg.mamba_width, cfg.ssm_state, cfg.ssm_conv
    esize = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    y_err = state_err = 0.0
    for i, (b, s) in enumerate(MAMBA_CHECKED
                               + tuple((1, s) for s in MAMBA_TIMED)):
        c = mamba_inputs(dev, cfg, b, s, 100 + i)
        u_ref, tail_ref, y_ref, h_ref = mamba_plain(c)
        tail, state = c["conv_tail"].clone(), c["state"].clone()
        before = dict(native.LAUNCHES)
        u, _ = mamba_conv(c["xz"], tail, c["conv_w"])
        y, _ = mamba_scan(c["xz"], u, c["proj"], c["a_log"], c["d_skip"],
                          state)
        torch.cuda.synchronize()
        label = f"mamba kernels [B={b}, S={s}]"
        if native.LAUNCHES["mamba_conv"] != before["mamba_conv"] + 1 or \
                native.LAUNCHES["mamba_scan"] != before["mamba_scan"] + 1:
            raise AssertionError(f"{label}: not one launch each")
        if not (torch.equal(u, u_ref) and torch.equal(tail, tail_ref)):
            raise AssertionError(f"{label}: the conv differs from ref.py")
        err = float((state - h_ref).norm() / h_ref.norm())
        ulps = bf16_ulps(y, y_ref)
        near = (y.float() - y_ref.float()).abs() <= \
            MAMBA_Y_NEAR * y_ref.float().abs().max()
        exact = float((ulps == 0).float().mean())
        if err >= MAMBA_STATE_TOL or exact < MAMBA_Y_EXACT or \
                not bool(((ulps <= MAMBA_Y_ULPS) | near).all()):
            raise AssertionError(
                f"{label}: state {err:.3e} from ref.py (tol "
                f"{MAMBA_STATE_TOL}), y {exact:.5f} bit for bit, "
                f"{float(ulps[~near].max()) if (~near).any() else 0} ulps")
        state_err = max(state_err, err)
        y_err = max(y_err, float((y.float() - y_ref.float()).abs().max()))
    log(f"mamba kernels at {MAMBA_ARCH}'s widths (e={e}, N={n}, K={k}, "
        f"{cfg.dtype}), B x S in {MAMBA_CHECKED} and B=1 x S in "
        f"{MAMBA_TIMED}: conv and tail bit for bit, state at most "
        f"{state_err:.3e} relative from ref.py, y at most {y_err:.3e} "
        f"(ulp rule)")
    rows = {"mamba_conv": dict(max_abs_err=0, lengths={}),
            "mamba_scan": dict(max_abs_err=y_err, lengths={})}
    for s in MAMBA_TIMED:
        c = mamba_inputs(dev, cfg, 1, s, s)
        u, _ = mamba_conv(c["xz"], c["conv_tail"].clone(), c["conv_w"])
        iters = 200 if s == 1 else max(10, 20_000 // s)
        times = dict(
            mamba_conv=device_ms(lambda: mamba_conv(
                c["xz"], c["conv_tail"], c["conv_w"]), iters),
            mamba_scan=device_ms(lambda: mamba_scan(
                c["xz"], u, c["proj"], c["a_log"], c["d_skip"],
                c["state"]), iters))
        plain_ms = device_ms(lambda: mamba_plain(c), 20 if s == 1 else 2)
        bounds = dict(zip(("mamba_conv", "mamba_scan"), (
            bound(*b, rate=F32_FLOPS)
            for b in mamba_bounds(1, s, e, n, k, esize))))
        for name, r in rows.items():
            r["lengths"][s] = dict(ms=times[name], plain_ms=plain_ms,
                                   bound_ms=bounds[name][0],
                                   bound_by=bounds[name][1])
            if s == 1:
                r.update(ms=times[name], plain_ms=plain_ms,
                         bound=bounds[name],
                         shape=f"decode step: B=1, S=1, e={e}, N={n}, K={k}")
        log(f"kernel mamba_conv, mamba_scan [B=1, S={s}]: "
            f"{times['mamba_conv']:.6f} and {times['mamba_scan']:.6f} "
            f"ms/launch ({floor_ms:.6f} the launch floor), bounds "
            f"{bounds['mamba_conv'][0]:.6f} ({bounds['mamba_conv'][1]}) and "
            f"{bounds['mamba_scan'][0]:.6f} ms ({bounds['mamba_scan'][1]}); "
            f"plain (ref.py's conv and scan) {plain_ms:.6f} ms")
    return rows


def kernel_checks(dev) -> dict:
    """Each kernel against its plain version on the card; times at the
    main path's largest burst shapes (64 queries, 64 pages or rows), beside
    the launch floor: the device time of an empty kernel launched the same
    way (``torch.cuda._sleep(0)``).  The times in the kernels line are warm
    (the same rows launch after launch); the search and lookup are also
    timed cold, on the log only."""
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 200)
    log(f"launch floor: {floor_ms:.6f} ms a launch (an empty kernel, "
        "back to back)")
    rows = {}

    err = 0
    for n_pages, n_queries in ((64, 64), (70, 5)):
        args, planted = search_case(dev, n_pages, n_queries,
                                    n_pages + n_queries)
        plain = sim_search_ref(*args, randomized=True)
        check_search_hits(plain, planted)
        err = max(err, max_abs_err([sim_search(*args, randomized=True)],
                                   [plain]))
    arena = random_arena(dev)                 # the replay's 32,768 rows
    err = max(err, search_in_place(dev, arena, 5))
    args, _ = search_case(dev, 64, 64, 1)
    cold = search_cold(dev, arena, args[2], args[3])
    cold_bound = bound(*search_bound(64, 64, in_place=True))
    log(f"kernel sim_search cold [Q=64 x N=64 fresh random rows a launch of "
        f"a {ARENA_ROWS}-row arena, {COLD_ITERS} launches]: in place "
        f"{cold:.6f} ms/launch (the flush's device work; "
        f"{cold - floor_ms:.6f} above the launch floor); bound "
        f"{cold_bound[0]:.6f} ms ({cold_bound[1]})")
    chips = search_chips_checks(dev, arena, floor_ms)
    err = max([err] + [r["max_abs_err"] for r in chips.values()])
    rows["sim_search"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: sim_search(*args, randomized=True), 200),
        plain_ms=device_ms(lambda: sim_search_ref(*args, randomized=True),
                           20),
        shape="Q=64 x N=64, randomized, planted hits",
        bound=bound(*search_bound(64, 64)))

    err = 0
    for max_out in (64, 4):
        args = gather_case(dev, 64, max_out)
        err = max(err, max_abs_err(sim_gather(*args, max_out),
                                   sim_gather_ref(*args, max_out)))
    args = gather_case(dev, 64, 2)
    ms = device_ms(lambda: sim_gather(*args, 64), 200)
    wide_bound = bound(*gather_bound(args[2], 64))
    log(f"kernel sim_gather [N=64, max_out=64, ~32 chunks selected a row "
        f"(one 0, one 64)]: {ms:.6f} ms/launch ({ms - floor_ms:.6f} above "
        f"the launch floor), bound {wide_bound[0]:.6f} ms ({wide_bound[1]})")
    err = max(err, gather_in_place(dev, arena, 7))
    cold, bm = gather_cold(dev, arena)
    cold_bound = bound(*gather_bound(bm, 64, in_place=True))
    log(f"kernel sim_gather cold [N=64 fresh random rows a launch of a "
        f"{ARENA_ROWS}-row arena, one chunk selected a row, max_out=64, "
        f"{COLD_ITERS} launches]: in place {cold:.6f} ms/launch (the flush's "
        f"device work; {cold - floor_ms:.6f} above the launch floor); bound "
        f"{cold_bound[0]:.6f} ms ({cold_bound[1]})")
    args = gather_case(dev, 64, 3, one_chunk=True)
    err = max(err, max_abs_err(sim_gather(*args, 64),
                               sim_gather_ref(*args, 64)))
    rows["sim_gather"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: sim_gather(*args, 64), 200),
        plain_ms=device_ms(lambda: sim_gather_ref(*args, 64), 20),
        shape="replay burst: N=64, one chunk selected a row, max_out=64",
        bound=bound(*gather_bound(args[2], 64)))

    err = 0
    for n_rows in (64, 13):
        args, want = lookup_case(dev, n_rows, n_rows)
        plain = sim_lookup_ref(*args, randomized=True)
        check_lookup_hits(plain, want)
        err = max(err, max_abs_err(sim_fused_lookup(*args, randomized=True),
                                   plain))
    err = max(err, lookup_in_place(dev, arena, 6))
    cold, slots = lookup_cold(dev, arena)
    cold_bound = bound(*lookup_bound(64, slots, in_place=True))
    log(f"kernel sim_lookup cold [B=64 fresh random key and value rows a "
        f"launch of a {ARENA_ROWS}-row arena, "
        f"{int((tensor_to_words(slots) < 512).sum())} hits, {COLD_ITERS} "
        f"launches]: in place {cold:.6f} ms/launch (the flush's device "
        f"work; {cold - floor_ms:.6f} above the launch floor); bound "
        f"{cold_bound[0]:.6f} ms ({cold_bound[1]})")
    del arena
    args, want = lookup_case(dev, 64, 3)
    slots = sim_fused_lookup(*args, randomized=True)[2]
    rows["sim_lookup"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: sim_fused_lookup(*args, randomized=True), 200),
        plain_ms=device_ms(lambda: sim_lookup_ref(*args, randomized=True),
                           20),
        shape=f"B=64 rows, randomized, {int((want < 512).sum())} hits",
        bound=bound(*lookup_bound(64, slots)))

    err = 0
    for n_pages, p_pad, kind in ((32, 16, "check"), (64, 128, "check"),
                                 (70, 16, "check"), (32, 16, "replay"),
                                 (64, 128, "work")):
        args, want, set_cells, clear_cells = plan_case(
            dev, n_pages, p_pad, kind, n_pages + p_pad)
        plain = sim_plan_ref(*args, randomized=True)
        check_plan_hits(plain, want, set_cells, clear_cells)
        err = max(err, max_abs_err([sim_plan(*args, randomized=True)],
                                   [plain]))
    timed = {}
    for n_pages, p_pad, kind in ((32, 16, "replay"), (64, 128, "work")):
        args, _, _, _ = plan_case(dev, n_pages, p_pad, kind, 5)
        ms = device_ms(lambda: sim_plan(*args, randomized=True), 200)
        timed[kind] = dict(
            ms=ms,
            plain_ms=device_ms(lambda: sim_plan_ref(*args, randomized=True),
                               10),
            bound=bound(*plan_bound(args[4], n_pages)))
        log(f"kernel sim_plan [{kind}: G={args[2].shape[0]}, P={p_pad}, "
            f"N={n_pages}]: {ms:.6f} ms/launch ({ms - floor_ms:.6f} above "
            f"the launch floor), plain {timed[kind]['plain_ms']:.6f} ms, "
            f"bound {timed[kind]['bound'][0]:.6f} ms "
            f"({timed[kind]['bound'][1]})")
    chips = plan_chips_checks(dev, floor_ms)
    err = max([err] + [r["max_abs_err"] for r in chips.values()])
    rows["sim_plan"] = dict(
        max_abs_err=err, **timed["replay"],
        shape="replay scan: G=1, P=16, N=32, randomized, planted hits",
        work=timed["work"])

    err = 0
    for n_pages, n_queries, max_out in ((64, 8, 16), (17, 3, 4), (5, 2, 64),
                                        (33, 17, 16), (7, 5, 80)):
        args, planted = fused_case(dev, n_pages, n_queries,
                                   n_pages + n_queries)
        kw = dict(max_out=max_out, randomized=True, page_ids=args[4],
                  page_seeds=args[5])
        plain = sim_fused_ref(*args, max_out=max_out, randomized=True)
        check_fused_hits(plain, args, planted, max_out)
        err = max(err, max_abs_err(sim_fused(*args[:4], **kw), plain))
    args, _ = fused_case(dev, 4, 2, 4)        # the quickstart's shape
    kw = dict(max_out=4, randomized=True, page_ids=args[4],
              page_seeds=args[5])
    qs = (args[0], args[1], args[2][:1], args[3][:1])
    err = max(err, max_abs_err(sim_fused(*qs, **kw), sim_fused_ref(
        *qs, *args[4:], max_out=4, randomized=True)))
    ms = device_ms(lambda: sim_fused(*qs, **kw), 200)
    plain_ms = device_ms(lambda: sim_fused_ref(*qs, *args[4:], max_out=4,
                                               randomized=True), 20)
    qs_bound = bound(*fused_bound(4, 1, 4))
    log(f"kernel sim_fused [quickstart: Q=1 x N=4, max_out=4, a planted "
        f"hit]: {ms:.6f} ms/launch ({ms - floor_ms:.6f} above the launch "
        f"floor), plain {plain_ms:.6f} ms, bound {qs_bound[0]:.6f} ms "
        f"({qs_bound[1]})")
    args, planted = fused_case(dev, 2048, 64, 11)
    kw = dict(max_out=16, randomized=True, page_ids=args[4],
              page_seeds=args[5])
    plain = sim_fused_ref(*args, max_out=16, randomized=True)
    check_fused_hits(plain, args, planted, 16)
    err = max(err, max_abs_err(sim_fused(*args[:4], **kw), plain))
    del plain
    rows["sim_fused"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: sim_fused(*args[:4], **kw), 20),
        plain_ms=device_ms(lambda: sim_fused_ref(*args, max_out=16,
                                                 randomized=True), 3),
        shape="Q=64 x N=2048 (8 MiB of planes, 16 chips), max_out=16, "
              "randomized, planted hits, one mask-0 query",
        bound=bound(*fused_bound(2048, 64, 16)))
    del args

    for name, r in rows.items():
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {r['max_abs_err']})")
        log(f"kernel {name} [{r['shape']}]: bit-exact vs plain; "
            f"{r['ms']:.6f} ms/launch ({r['ms'] - floor_ms:.6f} above the "
            f"launch floor), plain {r['plain_ms']:.6f} ms, "
            f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]})")
    rows["flash_attention"] = r = attention_checks(dev, floor_ms)
    log(f"kernel flash_attention [{r['shape']}]: within tolerance of plain "
        f"(max abs err {r['max_abs_err']:.3e}); {r['ms']:.6f} ms/launch "
        f"({r['ms'] - floor_ms:.6f} above the launch floor), "
        f"plain {r['plain_ms']:.6f} ms, library {r['library_ms']:.6f} ms, "
        f"bound {r['bound'][0]:.6f} ms ({r['bound'][1]})")
    rows.update(mamba_checks(dev, floor_ms))
    return rows


# --------------------------------------------------------------- phase 3
class TimedLoad:
    """A backend that times the bulk load replay() opens with (its first
    ``n_load`` page programs) apart from the replayed ops."""

    def __init__(self, chips, n_load: int, **kw):
        super().__init__(chips, **kw)
        self.n_load = n_load
        self.load_s = 0.0

    def program_entries(self, page_addr, entries, **kw):
        if self.n_load <= 0:
            return super().program_entries(page_addr, entries, **kw)
        self.n_load -= 1
        t0 = time.perf_counter()
        built = super().program_entries(page_addr, entries, **kw)
        self.load_s += time.perf_counter() - t0
        return built


class TimedBackend(TimedLoad, BatchedKernelBackend):
    pass


class TimedSharded(TimedLoad, ShardedSsdBackend):
    pass


def oracle(wl, n_key_pages, order=None):
    """Serial semantics in plain numpy: reads see the latest write; a scan
    of key ids [k, k + len) counts the stored keys it covers, clipped to
    the index, and leaves values alone.  ``order`` is the order the ops
    execute in (the event loop's dispatch order), by default the
    workload's."""
    n_keys = n_key_pages * KEYS_PER_PAGE
    values = (np.arange(1, n_keys + 1, dtype=np.uint64)
              * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    out = np.zeros(len(wl.ops), np.uint64)
    counts = np.zeros(len(wl.ops), np.int64)
    for qi in range(len(wl.ops)) if order is None else order:
        op, k = wl.ops[qi], wl.keys[qi]
        if op == 0:
            out[qi] = values[k]
        elif op == 1:
            values[k] = np.uint64(qi * 2 + 1)
        else:
            counts[qi] = min(k + 1 + int(wl.scan_lens[qi]), n_keys + 1) \
                - (k + 1)
    return out, counts


def run_replay(label, wl, n_key_pages, n_chips, config,
               backend_cls=TimedBackend, **backend_kw):
    """One path: fresh chips, launch counts and peak device memory set to
    0 just before the replay and read just after it; the memory already
    allocated then (earlier phases' leftovers) is logged apart."""
    pages_per_chip = -(-2 * n_key_pages // n_chips) + 1
    chips = SimChipArray(n_chips=n_chips, pages_per_chip=pages_per_chip,
                         device_seed=7)
    backend = backend_cls(chips, n_load=2 * n_key_pages, **backend_kw)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    rep = replay(wl, backend, config)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ops_s = len(wl.ops) / (wall_s - backend.load_s)
    log(f"replay {label}: wall {wall_s:.3f} s (bulk load of "
        f"{2 * n_key_pages} pages {backend.load_s:.3f} s), {ops_s:.1f} ops/s "
        f"after the load; reads {rep.n_reads}, writes {rep.n_writes}, scans "
        f"{rep.n_scans}; flushes {rep.flushes}, kernel_launches "
        f"{rep.kernel_launches}, launches by kernel {grew}, staged_bytes "
        f"{rep.staged_bytes}, result_bytes {rep.result_bytes}, programs "
        f"{rep.programs}, write_flushes {rep.write_flushes}, "
        f"buffer_read_hits {rep.buffer_read_hits}, resident rows "
        f"{backend.store.resident_rows}, peak device memory {peak} bytes "
        f"({before} allocated before the replay)")
    return rep, grew, backend, peak


def check_replay(label, wl, rep, grew, config, n_key_pages):
    """Values and scan counts equal the oracle; the launches by kernel add
    up to the backend's count; one ``sim_plan`` launch a scan."""
    want, counts = oracle(wl, n_key_pages)
    reads, scans = wl.ops == 0, wl.ops == 2
    if not rep.read_hits[reads].all():
        raise AssertionError(f"{label}: a read missed its key")
    if not np.array_equal(rep.read_values[reads], want[reads]):
        raise AssertionError(f"{label}: read values differ from the oracle")
    if scans.any() and not np.array_equal(rep.scan_counts[scans],
                                          counts[scans]):
        raise AssertionError(f"{label}: scan counts differ from the oracle")
    if (rep.n_scans, grew["sim_plan"]) != (int((counts[scans] > 0).sum()),) * 2:
        raise AssertionError(f"{label}: {grew['sim_plan']} sim_plan launches "
                             f"and {rep.n_scans} scans for "
                             f"{int(scans.sum())} scan ops")
    if sum(grew.values()) != rep.kernel_launches:
        raise AssertionError(f"{label}: launches by kernel {grew} do not add "
                             f"up to kernel_launches {rep.kernel_launches}")
    if config.fused and rep.kernel_launches != rep.flushes:
        raise AssertionError(f"{label}: {rep.kernel_launches} launches for "
                             f"{rep.flushes} flushes")
    if config.write_buffer and not (
            rep.buffer_read_hits > 0 and rep.write_flushes > 0
            and rep.programs < rep.n_writes):
        raise AssertionError(f"{label}: the write buffer neither served "
                             "reads nor coalesced writes")


def check_scan_plans(backend, wl, rep, n_key_pages, n_scans):
    """The first scans again on the replay's backend: the fused PLAN
    bitmaps equal the per-pass searches combined on the host
    (``sim_search`` on the card), and count the replay's scan counts."""
    n_keys = n_key_pages * KEYS_PER_PAGE
    for qi in np.nonzero(wl.ops == 2)[0][:n_scans]:
        lo = int(wl.keys[qi]) + 1
        hi = min(lo + int(wl.scan_lens[qi]), n_keys + 1)
        pages = list(range((lo - 1) // KEYS_PER_PAGE,
                           min((hi - 2) // KEYS_PER_PAGE, n_key_pages - 1)
                           + 1))
        plan = exact_range(lo, hi, width=64)
        fused = evaluate_plan_on_pages(backend, plan, pages)
        if not np.array_equal(fused,
                              evaluate_plan_per_pass(backend, plan, pages)):
            raise AssertionError(f"scan {qi}: PLAN differs from per-pass")
        total = int(np.unpackbits(mask_header_slots(fused).view(np.uint8))
                    .sum())
        if total != rep.scan_counts[qi]:
            raise AssertionError(f"scan {qi}: {total} keys, replay counted "
                                 f"{rep.scan_counts[qi]}")


def ycsb_paths(kp, n_ops) -> list:
    """(label, workload, config) of the replay paths: 20,000 ops, Zipf
    0.9, seed 1, bursts of 64."""
    def ycsb(**kw):
        return generate(n_ops, n_key_pages=kp, alpha=0.9, seed=1, **kw)

    ycsb_b = ycsb(read_ratio=0.95)
    return [
        ("YCSB-B split", ycsb_b, RunConfig(burst=64)),
        ("YCSB-B fused", ycsb_b, RunConfig(burst=64, fused=True)),
        ("YCSB-E scans fused", ycsb(read_ratio=0.0, scan_ratio=0.95,
                                    max_scan_len=100),
         RunConfig(burst=64, fused=True)),
        ("YCSB-A write buffer fused", ycsb(read_ratio=0.5),
         RunConfig(burst=64, fused=True, write_buffer=True,
                   write_high_water=16)),
    ]


def main_path(kp, n_ops):
    """Four replays at full width on 16 chips, each path's launch counts
    set to 0 just before it and read just after it; returns the launches
    by kernel summed over the paths, and each path's report and launches
    by kernel."""
    n_chips = 16
    launches = {k: 0 for k in native.LAUNCHES}
    reports, peaks = {}, []
    for label, wl, config in ycsb_paths(kp, n_ops):
        rep, grew, backend, peak = run_replay(label, wl, kp, n_chips, config)
        peaks.append(peak)
        check_replay(label, wl, rep, grew, config, kp)
        if rep.n_scans:
            check_scan_plans(backend, wl, rep, kp, 200)
        del backend
        reports[label] = rep, grew
        for k in launches:
            launches[k] += grew[k]
    split, fused = reports["YCSB-B split"][0], reports["YCSB-B fused"][0]
    if not (np.array_equal(split.read_values, fused.read_values)
            and np.array_equal(split.read_hits, fused.read_hits)):
        raise AssertionError("YCSB-B split and fused replays disagree")
    for k in REPLAY_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on the replay paths")
    log(f"peak device memory {max(peaks)} bytes (the largest path's)")
    log("replays: read values and scan counts equal the numpy oracle, all "
        "reads hit, YCSB-B split and fused agree, launches by kernel add up "
        "to kernel_launches, one sim_plan launch a scan, fused launches == "
        "flushes, the first 200 scans' PLAN bitmaps equal the per-pass "
        "searches")
    return launches, reports


# ------------------------------------------------ phase 3b: sharded SSD
# FlashParams' default SSD (src/repro_torch/flash/params.py): 8 channels of
# 2 dies, one chip a die.
SSD_CHANNELS, SSD_DIES = 8, 2
# The card-against-CPU timeline check runs at a cut size: the CPU's plain
# versions set its scale.
SMALL_KEY_PAGES, SMALL_N_OPS = 1024, 2000


def timeline_numbers(rep) -> tuple:
    return (rep.burst_latencies_ns.tolist(), rep.write_latencies_ns.tolist(),
            rep.sim_makespan_ns, rep.sim_energy_pj)


class LaunchLog:
    """Inside ``with``, logs the calls the sharded backend makes to one of
    its chip-axis wrappers: the count of each operand shape and the
    operands of its first call of that shape.  The wrapper itself runs,
    and counts its launches, as before."""

    def __init__(self, name, shape):
        self.name, self.shape, self.calls = name, shape, {}

    def __enter__(self):
        self.fn = fn = getattr(sharded_backend, self.name)

        def logged(*args, **kw):
            key = self.shape(args, kw)
            n, first = self.calls.get(key, (0, (args, kw)))
            self.calls[key] = (n + 1, first)
            return fn(*args, **kw)
        setattr(sharded_backend, self.name, logged)
        return self

    def __exit__(self, *exc):
        setattr(sharded_backend, self.name, self.fn)

    def most_common(self):
        """(shape, calls of it, all calls, first operands of it)."""
        key = max(self.calls, key=lambda k: self.calls[k][0])
        n, first = self.calls[key]
        return key, n, sum(c for c, _ in self.calls.values()), first


def flush_shape_times(search_log, plan_log) -> None:
    """Each chip-axis form on the operands of the sharded replay's own most
    frequent launch shape (the arena rows and queries of its first launch
    of that shape): bit-exact against the plain version, and timed."""
    (c, nq, nr), n, total, (args, kw) = search_log.most_common()
    err = max_abs_err([sim_search_chips(*args, **kw)],
                      [sim_search_chips_ref(*args, **kw)])
    ms = device_ms(lambda: sim_search_chips(*args, **kw), 200)
    plain_ms = device_ms(lambda: sim_search_chips_ref(*args, **kw), 20)
    work = search_bound(nr, nq, in_place=True)
    b = bound(c * work[0], c * work[1])
    log(f"kernel sim_search chip axis [the sharded YCSB-B split replay's "
        f"flush shape: C={c}, Q={nq} x R={nr} a chip, in place; {n} of its "
        f"{total} launches]: max abs err {err} vs plain; {ms:.6f} ms/launch, "
        f"plain {plain_ms:.6f} ms, bound {b[0]:.6f} ms ({b[1]})")
    (c, ng, npass, nr), n, total, (args, kw) = plan_log.most_common()
    err = max(err, max_abs_err([sim_plan_chips(*args, **kw)],
                               [sim_plan_chips_ref(*args, **kw)]))
    ms = device_ms(lambda: sim_plan_chips(*args, **kw), 200)
    plain_ms = device_ms(lambda: sim_plan_chips_ref(*args, **kw), 20)
    works = [plan_bound(args[4][i], nr) for i in range(c)]
    b = bound(sum(w[0] for w in works), sum(w[1] for w in works))
    log(f"kernel sim_plan chip axis [the sharded YCSB-E replay's flush "
        f"shape: C={c}, G={ng}, P={npass}, R={nr} a chip; {n} of its {total} "
        f"launches]: max abs err {err} vs plain; {ms:.6f} ms/launch, plain "
        f"{plain_ms:.6f} ms, bound {b[0]:.6f} ms ({b[1]})")
    if err:
        raise AssertionError("a chip-axis form differs from its plain "
                             "version at the sharded replay's flush shape")


def sharded_path(kp, n_ops, batched) -> dict:
    """YCSB-B split and fused and YCSB-E scans on the sharded backend, 8 x 2
    chips with the flash timeline, at the replays' full size: values and
    hits equal the oracle and phase 3's batched replays, each flush phase
    ONE launch (launches by kernel equal the batched replay's), one burst
    latency a flush, one write latency a program, positive energy.  At the
    same size, ``RunConfig.event_serial()`` equals the serial sharded
    fused replay in values and counters.  One open-loop point
    (read_priority, 8 streams) at 1 / CUT_LOAD of the key pages is printed
    with its values held to the oracle in the event loop's dispatch
    order.  At 1,024 key pages and
    2,000 ops, the timeline on the card equals the same replay with
    device="cpu", and the open-loop point's simulated latencies equal the
    scalar backend's.  Returns the launches by kernel summed over the
    card's runs."""
    n_chips = SSD_CHANNELS * SSD_DIES
    geometry = dict(channels=SSD_CHANNELS, dies_per_channel=SSD_DIES,
                    timeline=True)
    launches = {k: 0 for k in native.LAUNCHES}
    reports = {}
    search_log = LaunchLog("sim_search_chips", lambda a, kw: (
        *a[2].shape[:2], kw["rows"].shape[1]))
    plan_log = LaunchLog("sim_plan_chips",
                         lambda a, kw: (*a[2].shape[:3], a[0].shape[1]))
    for label, wl, config in ycsb_paths(kp, n_ops)[:3]:
        with search_log, plan_log:
            rep, grew, backend, _ = run_replay(f"sharded {label}", wl, kp,
                                               n_chips, config, TimedSharded,
                                               **geometry)
        check_replay(label, wl, rep, grew, config, kp)
        ref, ref_grew = batched[label]
        for f in ("read_values", "read_hits", "scan_counts"):
            if not np.array_equal(getattr(rep, f), getattr(ref, f)):
                raise AssertionError(f"sharded {label}: {f} differ from "
                                     "the batched replay's")
        if grew != ref_grew or rep.flushes != ref.flushes:
            raise AssertionError(f"sharded {label}: launches {grew} over "
                                 f"{rep.flushes} flushes, batched {ref_grew} "
                                 f"over {ref.flushes}")
        if not (len(rep.burst_latencies_ns) == rep.flushes
                and len(rep.write_latencies_ns) == rep.programs
                and (rep.burst_latencies_ns > 0).all()
                and rep.sim_energy_pj > 0):
            raise AssertionError(f"sharded {label}: "
                                 f"{len(rep.burst_latencies_ns)} burst "
                                 f"latencies for {rep.flushes} flushes, "
                                 f"{len(rep.write_latencies_ns)} write "
                                 f"latencies for {rep.programs} programs, "
                                 f"energy {rep.sim_energy_pj} pJ")
        lat = rep.burst_latencies_ns
        log(f"sharded {label} timeline: burst latency p50 "
            f"{np.percentile(lat, 50):.1f} ns, p99 "
            f"{np.percentile(lat, 99):.1f} ns over {len(lat)} flushes; "
            f"makespan {rep.sim_makespan_ns:.1f} ns, energy "
            f"{rep.sim_energy_pj:.1f} pJ (simulated SSD time, host numpy)")
        del backend
        reports[label] = rep, grew
        for k in launches:
            launches[k] += grew[k]
    flush_shape_times(search_log, plan_log)
    del search_log, plan_log

    # The event frontend at full size: the degenerate event config against
    # the serial sharded fused replay, then one open-loop point.
    label, wl, _ = ycsb_paths(kp, n_ops)[1]
    event, grew, backend, _ = run_replay(
        f"sharded {label} event_serial", wl, kp, n_chips,
        RunConfig.event_serial(burst=64, fused=True), TimedSharded,
        **geometry)
    del backend
    serial, serial_grew = reports[label]
    for f in ("read_values", "read_hits"):
        if not np.array_equal(getattr(serial, f), getattr(event, f)):
            raise AssertionError(f"event_serial {f} differ from serial")
    for f in ("flushes", "kernel_launches", "staged_bytes", "result_bytes",
              "programs"):
        if getattr(serial, f) != getattr(event, f):
            raise AssertionError(f"event_serial {f} {getattr(event, f)} "
                                 f"against serial {getattr(serial, f)}")
    if grew != serial_grew:
        raise AssertionError(f"event_serial launches {grew} against serial "
                             f"{serial_grew}")
    for k in launches:
        launches[k] += grew[k]

    def open_loop(**kw):
        return RunConfig.open_loop(3e5, concurrency=8,
                                   scheduler="read_priority", burst=64,
                                   write_buffer=True, write_high_water=8,
                                   seed=1, **kw)
    okp = kp // CUT_LOAD
    wl = generate(n_ops, n_key_pages=okp, read_ratio=0.5, alpha=0.9, seed=1)
    point, grew, backend, _ = run_replay(
        "sharded open loop", wl, okp, n_chips, open_loop(record_trace=True),
        TimedSharded, **geometry)
    del backend
    for k in launches:
        launches[k] += grew[k]
    order = [qi for _, kind, qi in point.trace if kind == "dispatch"]
    want, _ = oracle(wl, okp, order)
    reads = wl.ops == 0
    if sorted(order) != list(range(len(wl.ops))) or not (
            point.read_hits[reads].all()
            and np.array_equal(point.read_values[reads], want[reads])):
        raise AssertionError("open-loop read values differ from the oracle "
                             "in dispatch order")
    lat = point.latency
    log(f"sharded open loop [{okp} key pages, {n_ops} ops, read 0.5, Zipf "
        f"0.9, Poisson 300,000 ops/s offered, read_priority, 8 streams, "
        f"write buffer 8]: simulated read p50 {lat.read_p50_ns:.1f} ns, p99 "
        f"{lat.read_p99_ns:.1f} ns, achieved {lat.qps:.1f} ops/s; "
        f"{point.counters.dispatches} dispatches, {point.kernel_launches} "
        "launches; read values equal the oracle in dispatch order")

    # At a cut size: the host-only timeline is the same on the card and on
    # the CPU, and event timing is the same on the scalar backend.
    small = ycsb_paths(SMALL_KEY_PAGES, SMALL_N_OPS)
    small_chips = dict(n_chips=n_chips, device_seed=7, pages_per_chip=-(
        -2 * SMALL_KEY_PAGES // n_chips) + 1)

    def small_backend(device, **kw):
        return ShardedSsdBackend(SimChipArray(**small_chips), device=device,
                                 channels=SSD_CHANNELS,
                                 dies_per_channel=SSD_DIES, **kw)

    def on_card(fn):
        native.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += native.LAUNCHES[k]
        return out

    for label, wl, config in small[:2]:
        card = on_card(lambda: replay(wl, small_backend(None, timeline=True),
                                      config))
        cpu = replay(wl, small_backend("cpu", timeline=True), config)
        if timeline_numbers(card) != timeline_numbers(cpu) or not \
                np.array_equal(card.read_values, cpu.read_values):
            raise AssertionError(f"sharded {label}: the timeline or values "
                                 "on the card differ from device='cpu'")
    wl = generate(SMALL_N_OPS, n_key_pages=SMALL_KEY_PAGES, read_ratio=0.5,
                  alpha=0.9, seed=1)
    card = on_card(lambda: replay(wl, small_backend(None), open_loop()))
    host = replay(wl, ScalarBackend(SimChipArray(**small_chips)), open_loop())
    if not (np.array_equal(card.latency.read_latencies_ns,
                           host.latency.read_latencies_ns)
            and np.array_equal(card.read_values, host.read_values)):
        raise AssertionError("open-loop point on the sharded backend differs "
                             "from the scalar backend's")
    log(f"sharded: 8 x 2 chips; values equal the oracle and the batched "
        f"replays; one launch a flush phase; event_serial equals the serial "
        f"replay; at {SMALL_KEY_PAGES} key pages the timeline on the card "
        "equals device='cpu' and the open-loop latencies equal the scalar "
        "backend's")
    return launches


# ------------------------------------------- phase 3c: bit faults (§IV-C)
BENCH_DIR = Path(__file__).resolve().parent / "benchmarks"
# benchmarks/reliability_sweep.py's configuration (the JAX package's BER
# sweep): 240 read-only ops over 12 key pages on 4 chips, device seed 3.
SWEEP_OPS, SWEEP_KEY_PAGES, SWEEP_CHIPS = 240, 12, 4
SWEEP_AGES = (0, 45, 90)
VERIFIED = dict(verify_hits=True, fallback_on_miss=True, vote_k=3)
# The full-size replays: age 90 (refresh marks, ECC fallbacks and
# uncorrectable pages all occur) verified; the raw check at age 45
# unverified and noise-free, so a response's bitmap is the kernel's own.
FULL_AGE, RAW_AGE = 90.0, 45.0
N_MIRRORED = 8
# Ops of the raw check's split replay (host checks every response).
RAW_OPS = 5000


def baseline(name) -> dict:
    """A committed JAX benchmark baseline, read as data."""
    data = json.loads((BENCH_DIR / f"BENCH_{name}.baseline.json")
                      .read_text())
    return {m["name"]: m["value"] for m in data["metrics"]}


def outcome(ticket):
    """A ticket's response, or its typed error as (name, page)."""
    try:
        return ticket.result()
    except (UncorrectableReadError, DegradedReadError) as e:
        return (type(e).__name__, e.page_addr)


def same_outcome(a, b, cmd, where) -> None:
    """Equal responses, or equal typed errors.  One difference is allowed,
    as in the JAX package: when both pages of a lookup are uncorrectable,
    ScalarBackend names the key page and the kernel backends' finalize the
    value page, so the errors of a lookup may name its two pages."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        both_pages = (cmd.op is Op.LOOKUP and isinstance(a, tuple)
                      and isinstance(b, tuple) and a[0] == b[0]
                      and {a[1], b[1]} == {cmd.page_addr, cmd.value_page})
        if a != b and not both_pages:
            raise AssertionError(f"{where}: {a!r} against the scalar "
                                 f"reference's {b!r}")
    else:
        same_response(a, b, where)


def on_card(fn):
    """Run one path with the launch counts set to 0 just before it; returns
    its result, launches by kernel and wall seconds."""
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(native.LAUNCHES), time.perf_counter() - t0


def add_launches(total, grew) -> None:
    for k in total:
        total[k] += grew[k]


def sweep_replay(name, device, wl, policy, fault):
    arr = SimChipArray(n_chips=SWEEP_CHIPS, pages_per_chip=max(
        wl.n_index_pages // SWEEP_CHIPS + 1, 8), device_seed=3)
    kw = {} if name == "scalar" else {"device": device}
    rel = ReliabilityState(policy, fault)
    rep = replay(wl, make_backend(name, arr, **kw),
                 RunConfig.reliable(rel, burst=64, fused=True))
    return rep, rel


def reliability_sweep_path() -> dict:
    """The JAX BER sweep's own configuration: the verified half at ages
    0/45/90 (base BER 1e-4, sense BER 2e-4, vote_k 3, fault seed 11) on
    ScalarBackend and on the batched and sharded backends on the card, the
    unverified half (sense BER 5e-4, vote_k 1 and 3) likewise.  Every
    ``reliability_*`` counter (ScalarBackend's, as the sweep emits them)
    equals the committed baseline; every op on the card is the oracle
    value or a typed error and equals the scalar run's; the card's
    ``ReliabilityStats`` and counters equal the same backend's with
    device="cpu"."""
    base = baseline("reliability_sweep")
    wl = generate(SWEEP_OPS, n_key_pages=SWEEP_KEY_PAGES, read_ratio=1.0,
                  alpha=0.9, seed=7)
    want, _ = oracle(wl, SWEEP_KEY_PAGES)
    launches = {k: 0 for k in native.LAUNCHES}
    got = {}
    wrong = mismatch = 0
    halves = [(f"age {age}", ReliabilityPolicy(**VERIFIED),
               FaultModel(seed=11, base_ber=1e-4, retention_days=float(age),
                          sense_ber=2e-4)) for age in SWEEP_AGES]
    halves += [(f"unverified vote_k {k}",
                ReliabilityPolicy(verify_hits=False, fallback_on_miss=False,
                                  vote_k=k),
                FaultModel(seed=11, base_ber=0.0, sense_ber=5e-4))
               for k in (1, 3)]
    t0 = time.perf_counter()
    for label, policy, fault in halves:
        ref, ref_rel = sweep_replay("scalar", None, wl, policy, fault)
        if label.startswith("age"):
            age = label.split()[1]
            got[f"reliability_retries_age{age}"] = ref_rel.stats.retries
            got[f"reliability_fallback_reads_age{age}"] = \
                ref_rel.stats.fallback_reads
            got[f"reliability_uncorrectable_age{age}"] = \
                ref_rel.stats.uncorrectable
            got[f"reliability_refreshes_age{age}"] = ref.refreshes
        else:
            k = label.split()[-1]
            got[f"reliability_fp_ops_unverified_k{k}"] = int(np.sum(
                ref.read_hits & (ref.read_values != want)))
            got[f"reliability_fn_ops_unverified_k{k}"] = int(np.sum(
                ~ref.read_hits & ~ref.read_errors))
        for name in ("batched", "sharded"):
            (rep, rel), grew, _ = on_card(lambda: sweep_replay(
                name, None, wl, policy, fault))
            add_launches(launches, grew)
            cpu, cpu_rel = sweep_replay(name, "cpu", wl, policy, fault)
            if label.startswith("age"):
                ok = rep.read_hits & (rep.read_values == want)
                wrong += int(np.sum(~(ok | rep.read_errors)))
            for f in ("read_values", "read_hits", "read_errors"):
                mismatch += int(np.sum(getattr(rep, f) != getattr(ref, f)))
                if not np.array_equal(getattr(rep, f), getattr(cpu, f)):
                    raise AssertionError(f"sweep {label} {name}: {f} on the "
                                         "card differ from device='cpu'")
            if vars(rel.stats) != vars(cpu_rel.stats) or \
                    rep.counters != cpu.counters:
                raise AssertionError(f"sweep {label} {name}: stats on the "
                                     f"card {rel.stats} {rep.counters} "
                                     f"against device='cpu' {cpu_rel.stats} "
                                     f"{cpu.counters}")
            if grew["sim_lookup"] != rep.kernel_launches \
                    or rep.kernel_launches != rep.flushes:
                raise AssertionError(f"sweep {label} {name}: launches "
                                     f"{grew} for {rep.flushes} flushes")
        log(f"reliability sweep {label}: scalar {ref_rel.stats}; batched "
            f"and sharded on the card equal op by op, stats equal "
            f"device='cpu'")
    got["reliability_wrong_results_verified"] = wrong
    got["reliability_backend_mismatch"] = mismatch
    diff = {k: (got.get(k), v) for k, v in base.items() if got.get(k) != v}
    if diff or set(got) != set(base):
        raise AssertionError(f"reliability sweep counters differ from "
                             f"BENCH_reliability_sweep.baseline.json: {diff}")
    log(f"reliability sweep [{SWEEP_OPS} ops, {SWEEP_KEY_PAGES} key pages, "
        f"{SWEEP_CHIPS} chips, fault seed 11, device seed 3]: every "
        f"counter equals the committed baseline {got}; wall "
        f"{time.perf_counter() - t0:.3f} s; launches by kernel {launches}")
    return launches


class TimedState(ReliabilityState):
    """A reliability state that times its installation (the injection)."""
    install_s = 0.0

    def install(self, backend) -> int:
        t0 = time.perf_counter()
        n = super().install(backend)
        self.install_s = time.perf_counter() - t0
        return n


class Mirrored(TimedBackend):
    """The batched backend of the full-size reliable replay.  Its first
    ``N_MIRRORED`` bursts also run on ``ScalarBackend`` over a copy of the
    pages taken at the first flush (after the injection), with a
    reliability state of the same policy and fault model; each response,
    typed error and burst's ``result_bytes`` is held to the reference's.
    The reference's work is timed apart."""

    def __init__(self, chips, *, mirror_state, **kw):
        super().__init__(chips, **kw)
        self.mirror_state = mirror_state
        self.mirror = None
        self.compared = 0
        self.compare_s = 0.0
        self._queued = []

    def _queue(self, kind, cmd, ticket):
        if self.compared < N_MIRRORED:
            self._queued.append((kind, cmd, ticket))
        return ticket

    def submit_search(self, cmd):
        return self._queue("search", cmd, super().submit_search(cmd))

    def submit_gather(self, cmd):
        return self._queue("gather", cmd, super().submit_gather(cmd))

    def submit_lookup(self, cmd):
        return self._queue("lookup", cmd, super().submit_lookup(cmd))

    def flush(self):
        queued, self._queued = self._queued, []
        if queued and self.mirror is None:
            t0 = time.perf_counter()
            self.mirror = ScalarBackend(chip_array_from_numpy(
                chip_array_to_numpy(self.chips)))
            self.mirror.enable_reliability(self.mirror_state)
            self.compare_s += time.perf_counter() - t0
        before = self.stats.result_bytes
        super().flush()
        if not queued:
            return
        got = [outcome(t) for _, _, t in queued]
        card_bytes = self.stats.result_bytes - before
        t0 = time.perf_counter()
        ref = self.mirror
        before = ref.stats.result_bytes
        refs = [getattr(ref, f"submit_{kind}")(cmd) for kind, cmd, _ in queued]
        ref.flush()
        where = f"reliable burst {self.compared}"
        for i, (a, t, (_, cmd, _)) in enumerate(zip(got, refs, queued)):
            same_outcome(a, outcome(t), cmd, f"{where}, command {i}")
        if card_bytes != ref.stats.result_bytes - before:
            raise AssertionError(f"{where}: result_bytes {card_bytes}, the "
                                 "scalar reference's "
                                 f"{ref.stats.result_bytes - before}")
        self.compared += 1
        self.compare_s += time.perf_counter() - t0


RAW_KINDS = ("search", "gather", "lookup", "plan")


def raw_lookup(chips, cmd):
    """The chip model's noise-free lookup over the stored images: key
    bitmap, first user slot, the slot's 8 value bytes and the value
    chunk's inner-parity flag (slot, value and flag None on a miss)."""
    chip, local = chips.route(cmd.page_addr)
    bitmap = match_bitmap(chip, local, cmd.query, cmd.mask)
    slots = np.nonzero(unpack_bitmap(mask_header_slots(bitmap),
                                     SLOTS_PER_PAGE))[0]
    if slots.size == 0:
        return bitmap, None, None, None
    slot = int(slots[0])
    vchip, vlocal = chips.route(cmd.value_page)
    vsp = vchip.pages[vlocal]
    plain = vchip._derandomized_chunk(vsp, vlocal, slot // SLOTS_PER_CHUNK)
    off = (slot % SLOTS_PER_CHUNK) * 8
    parity = bool(crc32_rows(plain[None, :])[0]
                  == vsp.chunk_parities[slot // SLOTS_PER_CHUNK])
    return bitmap, slot, bytes(plain[off:off + 8]), parity


class RawChecked(TimedBackend):
    """The batched backend of the raw kernel checks: after each flush,
    every response equals the chip model's noise-free read of the stored
    image as it stands then (damaged, or repaired by the flush's open
    burst under the reliability tier): a search's bitmap ``match_bitmap``,
    a plan's ``plan_bitmap``, a gather's chunks the de-randomized chunks,
    a lookup's bitmap, slot, value and parity flag ``raw_lookup``'s.  With
    ``inject`` (a FaultModel) the backend runs without the tier and injects
    the damage at its first flush, after the bulk load: the lookups'
    slots and values are then the ``sim_lookup`` kernel's own.  Counts the
    commands checked and those that read a damaged row, by kind, and the
    typed errors; the host's work is timed apart."""

    def __init__(self, chips, *, inject=None, **kw):
        super().__init__(chips, **kw)
        self.inject = inject
        self.inject_s = self.compare_s = 0.0
        self.checked = dict.fromkeys(RAW_KINDS, 0)
        self.on_damaged = dict.fromkeys(RAW_KINDS, 0)
        self.typed = 0
        self._queued = []

    def _queue(self, kind, cmd, ticket):
        self._queued.append((kind, cmd, ticket))
        return ticket

    def submit_search(self, cmd):
        return self._queue("search", cmd, super().submit_search(cmd))

    def submit_gather(self, cmd):
        return self._queue("gather", cmd, super().submit_gather(cmd))

    def submit_lookup(self, cmd):
        return self._queue("lookup", cmd, super().submit_lookup(cmd))

    def submit_plan(self, cmd):
        return self._queue("plan", cmd, super().submit_plan(cmd))

    def flush(self):
        if self.inject is not None:
            t0 = time.perf_counter()
            self.inject.inject(self.chips)
            self.inject, self.inject_s = None, time.perf_counter() - t0
        queued, self._queued = self._queued, []
        super().flush()
        t0 = time.perf_counter()
        for kind, cmd, t in queued:
            got = outcome(t)
            if isinstance(got, tuple):
                self.typed += 1
                continue
            chip, local = self.chips.route(cmd.page_addr)
            sp = chip.pages[local]
            damaged = sp.injected_error_bits > 0
            if kind == "search":
                same = np.array_equal(got.bitmap_words, match_bitmap(
                    chip, local, cmd.query, cmd.mask))
            elif kind == "plan":
                same = np.array_equal(got.bitmap_words, plan_bitmap(
                    chip, local, cmd.plan_include, cmd.plan_exclude))
            elif kind == "gather":
                want = [chip._derandomized_chunk(sp, local, int(c))
                        for c in got.chunk_ids]
                same = all(np.array_equal(a, b)
                           for a, b in zip(got.chunks, want))
            else:
                bitmap, slot, value, parity = raw_lookup(self.chips, cmd)
                same = (np.array_equal(got.search.bitmap_words, bitmap)
                        and got.value_slot == slot and got.value == value
                        and (slot is None or got.parity_ok == parity))
                vchip, vlocal = self.chips.route(cmd.value_page)
                damaged |= vchip.pages[vlocal].injected_error_bits > 0
            if not same:
                raise AssertionError(f"raw check: {kind} of page "
                                     f"{cmd.page_addr} differs from the chip "
                                     "model's read of the stored image")
            self.checked[kind] += 1
            self.on_damaged[kind] += damaged
        self.compare_s += time.perf_counter() - t0


def reliable_replay(label, backend_cls, wl, kp, n_chips, rel, **kw):
    """One full-size replay over damaged pages (bursts of 64; ``kw`` holds
    ``fused`` and the backend's arguments), timed like ``run_replay``;
    ``rel`` is a ``TimedState``, or None for a replay without the tier
    whose ``RawChecked`` backend injects the damage itself.  Returns the
    report, launches by kernel and backend."""
    fused = kw.pop("fused")
    config = (RunConfig(burst=64, fused=fused) if rel is None else
              RunConfig.reliable(rel, burst=64, fused=fused))
    chips = SimChipArray(n_chips=n_chips,
                         pages_per_chip=-(-2 * kp // n_chips) + 1,
                         device_seed=7)
    backend = backend_cls(chips, n_load=2 * kp, **kw)
    rep, grew, wall_s = on_card(lambda: replay(wl, backend, config))
    inject_s = backend.inject_s if rel is None else rel.install_s
    extra = backend.load_s + inject_s + getattr(backend, "compare_s", 0.0)
    log(f"reliable {label}: wall {wall_s:.3f} s (bulk load of {2 * kp} "
        f"pages {backend.load_s:.3f} s, fault injection {inject_s:.3f} s, "
        f"host checks {getattr(backend, 'compare_s', 0.0):.3f} s), "
        f"{len(wl.ops) / (wall_s - extra):.1f} ops/s after them; reads "
        f"{rep.n_reads}, scans {rep.n_scans}, typed errors "
        f"{rep.n_read_errors}, refreshes {rep.refreshes}; flushes "
        f"{rep.flushes}, kernel_launches {rep.kernel_launches}, launches by "
        f"kernel {grew}, staged_bytes {rep.staged_bytes}, result_bytes "
        f"{rep.result_bytes}; "
        f"{'no reliability tier' if rel is None else rel.stats}")
    if sum(grew.values()) != rep.kernel_launches:
        raise AssertionError(f"reliable {label}: launches by kernel {grew} "
                             f"do not add up to {rep.kernel_launches}")
    return rep, grew, backend


def reliability_full_path(kp, n_ops) -> dict:
    """Full size, 16 chips: the fused YCSB read-only replay (Zipf 0.9) at
    age 90 under ``RunConfig.reliable`` on the batched backend, its first
    bursts held to ScalarBackend; every read the oracle value or a typed
    UncorrectableReadError, every verdict but CLEAN seen (all pages are
    past the refresh margin).  The same replay
    on the sharded backend (8 x 2, timeline on) equals it op by op.  Then
    the raw kernel checks at age 45: the split replay under the tier (no
    verification, no sense noise), where ``sim_search`` and ``sim_gather``
    read damaged and open-repaired arena rows as the chip model reads the
    pages, and a fused YCSB-E mix without the tier, where ``sim_lookup``'s
    bitmaps, slots and values and ``sim_plan``'s bitmaps over damaged rows
    equal the chip model's."""
    n_chips = SSD_CHANNELS * SSD_DIES
    launches = {k: 0 for k in native.LAUNCHES}
    wl = generate(n_ops, n_key_pages=kp, read_ratio=1.0, alpha=0.9, seed=1)
    want, _ = oracle(wl, kp)

    policy = ReliabilityPolicy(**VERIFIED)
    fault = FaultModel(seed=11, base_ber=1e-4, retention_days=FULL_AGE,
                       sense_ber=2e-4)
    rel = TimedState(policy, fault)
    rep, grew, backend = reliable_replay(
        "YCSB-C fused, batched", Mirrored, wl, kp, n_chips, rel, fused=True,
        mirror_state=ReliabilityState(policy, fault))
    add_launches(launches, grew)
    if backend.compared < N_MIRRORED:
        raise AssertionError(f"{backend.compared} reliable bursts compared "
                             "with ScalarBackend")
    del backend
    ok = rep.read_hits & (rep.read_values == want)
    if not np.all(ok | rep.read_errors):
        raise AssertionError("reliable replay: a read is neither the oracle "
                             "value nor a typed error")
    # Past the 30-day refresh margin no open is plain CLEAN: the other three
    # verdicts must all occur (the sweep's age 0 shows CLEAN).
    s = rel.stats
    if not (s.refresh_marked and s.fallbacks and s.uncorrectable):
        raise AssertionError(f"reliable replay at age {FULL_AGE}: a verdict "
                             f"did not occur: {s}")

    sharded, grew, backend = reliable_replay(
        "YCSB-C fused, sharded 8 x 2", TimedSharded, wl, kp, n_chips,
        TimedState(policy, fault), fused=True, channels=SSD_CHANNELS,
        dies_per_channel=SSD_DIES, timeline=True)
    add_launches(launches, grew)
    del backend
    for f in ("read_values", "read_hits", "read_errors"):
        if not np.array_equal(getattr(sharded, f), getattr(rep, f)):
            raise AssertionError(f"reliable sharded replay: {f} differ from "
                                 "the batched replay's")

    raw_ops = min(n_ops, RAW_OPS)
    damage = FaultModel(seed=11, base_ber=1e-4, retention_days=RAW_AGE)
    raw_wl = generate(raw_ops, n_key_pages=kp, read_ratio=1.0, alpha=0.9,
                      seed=2)
    rel3 = TimedState(
        ReliabilityPolicy(verify_hits=False, fallback_on_miss=False), damage)
    _, grew, backend = reliable_replay("raw check, split", RawChecked,
                                       raw_wl, kp, n_chips, rel3,
                                       fused=False)
    add_launches(launches, grew)
    split = backend
    if not (split.on_damaged["search"] and split.on_damaged["gather"]
            and rel3.stats.fallbacks):
        raise AssertionError(f"raw check, split: commands on damaged rows "
                             f"{split.on_damaged}, {rel3.stats.fallbacks} "
                             "open repairs")
    # Without the tier the lookups' slots and values are the kernel's.
    raw_wl = generate(raw_ops, n_key_pages=kp, read_ratio=0.5,
                      scan_ratio=0.5, max_scan_len=100, alpha=0.9, seed=3)
    _, grew, backend = reliable_replay("raw check, fused YCSB-E",
                                       RawChecked, raw_wl, kp, n_chips, None,
                                       fused=True, inject=damage)
    add_launches(launches, grew)
    if not (backend.on_damaged["lookup"] and backend.on_damaged["plan"]):
        raise AssertionError(f"raw check, fused: commands on damaged rows "
                             f"{backend.on_damaged}")
    log(f"raw check [{raw_ops} ops each, age {RAW_AGE}]: responses equal to "
        f"the chip model's reads by kind, split under the tier "
        f"{split.checked} ({split.on_damaged} on damaged rows, "
        f"{split.typed} typed errors, {rel3.stats.fallbacks} pages repaired "
        f"at open and restaged in their flush), fused YCSB-E without the "
        f"tier {backend.checked} ({backend.on_damaged} on damaged rows: "
        f"bitmap, slot, value and parity flag of every lookup)")
    del backend, split
    log(f"reliability at full size: every read the oracle value or a typed "
        f"error, three open verdicts, {N_MIRRORED} bursts equal "
        f"ScalarBackend, the sharded replay equals the batched op by op, "
        f"the raw outputs of sim_search, sim_gather, sim_lookup and "
        f"sim_plan over damaged rows, and of the first two over repaired "
        f"rows, equal the chip model's")
    return launches


def reliability_phase(kp, n_ops) -> dict:
    launches = reliability_sweep_path()
    add_launches(launches, reliability_full_path(kp, n_ops))
    return launches


# --------------------------------------- phase 3d: device faults and chaos
# benchmarks/chaos_sweep.py's configuration: 16 key pages, 4 chips,
# replicas 2, 600 ops at read 0.8, seed 11; deadline 500 us, 5 retries,
# backoff 100 us.
CHAOS_OPS, CHAOS_KEY_PAGES, CHAOS_CHIPS, CHAOS_SEED = 600, 16, 4, 11
CHAOS_COUNTERS = ("timeouts", "retries", "backoff_waits", "hedges_won",
                  "failovers", "remapped_blocks", "degraded_ops",
                  "shed_requests", "replica_programs", "program_failures")
# The full-size chaos replays hold 4,096 key pages: replicas triple the
# host page programs of the bulk load.
CHAOS_FULL_KEY_PAGES = 4096


def chaos_backend(n_index_pages, n_chips, cls=ShardedSsdBackend, **kw):
    """Replica-enabled sharded backend with spare headroom for the replica
    copies and grown-bad-block remaps (the sweep's geometry rule)."""
    arr = SimChipArray(n_chips=n_chips, pages_per_chip=(
        n_index_pages // n_chips + 1) * 3, device_seed=3)
    return cls(arr, replicas=2, **kw)


def chaos_sweep_path() -> dict:
    """The JAX chaos sweep's own configuration on the card: the four fault
    schedules under ``event_serial`` and the overload shed run.  Every
    counter and read p99 equals the committed baseline; no completed read
    is wrong; availability under the transient stall is at least 0.99."""
    base = baseline("chaos_sweep")
    launches = {k: 0 for k in native.LAUNCHES}
    got = {}
    wrong = 0
    wl = generate(CHAOS_OPS, n_key_pages=CHAOS_KEY_PAGES, read_ratio=0.8,
                  alpha=0.9, seed=7)
    exp, _ = oracle(wl, CHAOS_KEY_PAGES)
    schedules = (
        ("healthy", FaultSchedule.healthy(seed=CHAOS_SEED)),
        ("transient_stall", FaultSchedule.transient_stall(
            die=0, t_start_ms=0.05, dur_ms=1.0, seed=CHAOS_SEED)),
        ("dying_die", FaultSchedule.dying_die(
            die=1, t_fail_ms=0.5, program_fail_prob=0.05, seed=CHAOS_SEED)),
        ("dead_chip", FaultSchedule.dead_chip(chip=0, seed=CHAOS_SEED)))
    for name, sched in schedules:
        rep, grew, wall_s = on_card(lambda: replay(
            wl, chaos_backend(2 * CHAOS_KEY_PAGES, CHAOS_CHIPS),
            RunConfig.event_serial(fused=True, faults=sched,
                                   deadline_ns=500_000.0, max_retries=5,
                                   backoff_base_ns=100_000.0,
                                   seed=CHAOS_SEED)))
        add_launches(launches, grew)
        f = rep.faults
        ok = (wl.ops == 0) & ~f.op_errors
        wrong += int(np.sum(rep.read_values[ok] != exp[ok]))
        for c in CHAOS_COUNTERS:
            got[f"chaos_{name}_{c}"] = getattr(f, c)
        got[f"chaos_{name}_op_errors"] = f.n_op_errors
        got[f"chaos_{name}_read_p99_us"] = round(
            rep.latency.read_p99_ns / 1e3, 2)
        if name == "transient_stall":
            got["chaos_availability"] = 1.0 - f.n_op_errors / len(wl.ops)
        log(f"chaos {name}: wall {wall_s:.3f} s, launches by kernel {grew}, "
            f"faults {[getattr(f, c) for c in CHAOS_COUNTERS]} "
            f"({', '.join(CHAOS_COUNTERS)}), read p99 "
            f"{rep.latency.read_p99_ns:.1f} ns (simulated)")
    got["chaos_wrong_results"] = wrong
    wl = generate(CHAOS_OPS, n_key_pages=CHAOS_KEY_PAGES, read_ratio=1.0,
                  alpha=0.9, seed=7)
    rep, grew, wall_s = on_card(lambda: replay(
        wl, chaos_backend(2 * CHAOS_KEY_PAGES, CHAOS_CHIPS), RunConfig(
            mode="event", fused=True, arrival="poisson",
            arrival_rate_qps=5e5, concurrency=8, scheduler="read_priority",
            ncq_depth=16, shed_capacity=8, seed=CHAOS_SEED,
            faults=FaultSchedule.healthy(seed=CHAOS_SEED))))
    add_launches(launches, grew)
    ok = ~rep.faults.op_errors
    if np.any(rep.read_values[ok] != oracle(wl, CHAOS_KEY_PAGES)[0][ok]):
        raise AssertionError("overload run: a completed read is wrong")
    got["chaos_overload_shed_requests"] = rep.faults.shed_requests
    got["chaos_overload_completed_ok"] = int(np.sum(ok))
    diff = {k: (got.get(k), v) for k, v in base.items() if got.get(k) != v}
    if diff or set(got) != set(base):
        raise AssertionError(f"chaos sweep counters differ from "
                             f"BENCH_chaos_sweep.baseline.json: {diff}")
    log(f"chaos sweep [{CHAOS_OPS} ops, {CHAOS_KEY_PAGES} key pages, "
        f"{CHAOS_CHIPS} chips, replicas 2, seed {CHAOS_SEED}]: every counter "
        f"and read p99 equals the committed baseline {got}; launches by "
        f"kernel {launches}")
    return launches


class FaultSharded(TimedSharded):
    """Counts the failovers' launches by kernel, their flush phases and
    commands, and the reads that followed a bad-block remap to a spare page
    and stayed in their healthy phase's launch."""

    def __init__(self, chips, **kw):
        super().__init__(chips, **kw)
        self.remapped_on_kernel = self.failover_cmds = 0
        self.failover_phases = 0
        self.failover_launches = dict.fromkeys(native.LAUNCHES, 0)
        self._remapped = set()

    def _remap_cmd(self, cmd):
        out = super()._remap_cmd(cmd)
        if out is not cmd:
            self._remapped.add(id(out))
        return out

    def _failover(self, kind, items, dead, bursts):
        keep, moved = super()._failover(kind, items, dead, bursts)
        kept = {id(c) for c, _ in keep}
        self._remapped -= {id(c) for c, _ in items} - kept
        return keep, moved

    def _flush_failover(self, failover):
        before = dict(native.LAUNCHES)
        super()._flush_failover(failover)
        for k in before:
            self.failover_launches[k] += native.LAUNCHES[k] - before[k]
        self.failover_phases += sum(1 for v in failover.values() if v)
        self.failover_cmds += sum(map(len, failover.values()))

    def flush(self):
        super().flush()
        self.remapped_on_kernel += len(self._remapped)
        self._remapped.clear()


def chaos_full_path(kp, n_ops) -> dict:
    """The dying-die and dead-chip schedules under ``RunConfig.chaos`` on
    the sharded backend, 8 x 2 chips, replicas 2, the timeline on: a YCSB
    mix (read 0.75, scan 0.05, Zipf 0.9) whose read values and scan counts
    equal the oracle in dispatch order, with failovers above 0, each
    served by a launch over replica rows."""
    n_chips = SSD_CHANNELS * SSD_DIES
    launches = {k: 0 for k in native.LAUNCHES}
    wl = generate(n_ops, n_key_pages=kp, read_ratio=0.75, scan_ratio=0.05,
                  max_scan_len=100, alpha=0.9, seed=1)
    for label, sched in (
            ("dying die", FaultSchedule.dying_die(die=1, seed=CHAOS_SEED)),
            ("dead chip", FaultSchedule.dead_chip(chip=0, seed=CHAOS_SEED))):
        backend = chaos_backend(2 * kp, n_chips, FaultSharded, n_load=2 * kp,
                                channels=SSD_CHANNELS,
                                dies_per_channel=SSD_DIES, timeline=True)
        rep, grew, wall_s = on_card(lambda: replay(
            wl, backend, RunConfig.chaos(sched, burst=64, fused=True,
                                         seed=CHAOS_SEED,
                                         record_trace=True)))
        add_launches(launches, grew)
        f = rep.faults
        first = {}
        for _, kind, qi in rep.trace:
            if kind == "dispatch":
                first.setdefault(qi, len(first))
        order = sorted(first, key=first.get)
        want, counts = oracle(wl, kp, order)
        reads, scans = wl.ops == 0, wl.ops == 2
        ok = ~f.op_errors
        if sorted(order) != list(range(len(wl.ops))) or not (
                rep.read_hits[reads & ok].all()
                and np.array_equal(rep.read_values[reads & ok],
                                   want[reads & ok])
                and np.array_equal(rep.scan_counts[scans & ok],
                                   counts[scans & ok])):
            raise AssertionError(f"chaos {label}: values or scan counts "
                                 "differ from the oracle in dispatch order")
        if f.failovers == 0 or sum(grew.values()) != rep.kernel_launches:
            raise AssertionError(f"chaos {label}: {f.failovers} failovers, "
                                 f"launches {grew} for "
                                 f"{rep.kernel_launches}")
        # Every failover rode a launch: one a failover phase of a flush.
        fl = backend.failover_launches
        if backend.failover_cmds != f.degraded_ops or not (
                sum(fl.values()) == backend.failover_phases > 0):
            raise AssertionError(f"chaos {label}: {backend.failover_cmds} "
                                 f"failover commands for {f.degraded_ops} "
                                 f"degraded ops, failover launches {fl} for "
                                 f"{backend.failover_phases} phases")
        lat = rep.latency
        log(f"chaos {label} [{kp} key pages, {len(wl.ops)} ops, 8 x 2 chips, "
            f"replicas 2]: wall {wall_s:.3f} s (bulk load of {2 * kp} pages "
            f"and their replicas {backend.load_s:.3f} s), "
            f"{len(wl.ops) / (wall_s - backend.load_s):.1f} ops/s after the "
            f"load; faults {dataclasses.asdict(f) | {'op_errors': None}}; "
            f"{backend.failover_cmds} failovers served by the kernels from "
            f"replica rows, launches by kernel {fl}; "
            f"{backend.remapped_on_kernel} remapped reads served by the "
            f"kernels from spare rows; flushes {rep.flushes}, kernel_launches "
            f"{rep.kernel_launches}, launches by kernel {grew}; simulated "
            f"read p50 {lat.read_p50_ns:.1f} ns, p99 "
            f"{lat.read_p99_ns:.1f} ns; "
            "values and scan counts equal the oracle in dispatch order")
        del backend
    return launches


def fault_phase(kp, n_ops) -> dict:
    launches = chaos_sweep_path()
    add_launches(launches, chaos_full_path(min(kp, CHAOS_FULL_KEY_PAGES),
                                           n_ops))
    return launches


# ------------------------------------------- phase 3e: the contract auditor
def auditor_cli_path() -> dict:
    """``python -m repro_torch.analysis --check`` in-process on the card:
    zero new findings (its SIM101 holds ``native.LAUNCHES`` to one launch
    per recorded entry in every audited flush phase), and each of the four
    SiM kernels of the flush paths launched."""
    phases = []
    rc, grew, wall_s = on_card(lambda: auditor.main(["--check"],
                                                    phase_log=phases))
    if rc != 0:
        raise AssertionError(f"the auditor exited {rc}: new findings")
    seen = set()
    for ph in phases:
        log(ph.format())
        seen |= {k for k, v in ph.launches.items() if v}
    if seen != set(REPLAY_KERNELS):
        raise AssertionError(f"the launch audit launched {sorted(seen)}")
    log(f"auditor --check on the card: wall {wall_s:.3f} s (lint, launch "
        f"and conservation audits of both backends), 0 new findings, "
        f"{len(phases)} flush phases each one launch a recorded entry; "
        f"launches by kernel {grew}")
    return grew


def doctored_path() -> None:
    """Two doctored entry points must be caught on the card: a
    ``sim_search`` that launches twice (SIM101) and a ``sim_gather`` that
    reads its output back (SIM102, through sync debug mode)."""
    def caught(name, doctored, rule, slug, phases):
        orig = getattr(batched_backend, name)
        setattr(batched_backend, name, doctored(orig))
        try:
            t0 = time.perf_counter()
            findings = audit_backend("batched")
        finally:
            setattr(batched_backend, name, orig)
        got = {f.symbol for f in findings if (f.rule, f.slug) == (rule, slug)}
        if not got >= phases:
            raise AssertionError(f"doctored {name} not caught: "
                                 f"{[f.format() for f in findings]}")
        log(f"doctored {name} caught on the card in "
            f"{time.perf_counter() - t0:.3f} s: {rule} {slug} in "
            f"{sorted(got)}")

    def doubled(orig):
        def run(*args, **kw):
            first = orig(*args, **kw)
            orig(*args, **kw)
            return first
        return run

    def with_item(orig):
        def run(*args, **kw):
            out, counts = orig(*args, **kw)
            counts.sum().item()
            return out, counts
        return run

    caught("sim_search", doubled, "SIM101", "kernel-count:sim_search",
           {"search-cold", "search-warm", "search-after-program"})
    caught("sim_gather", with_item, "SIM102", "host-sync:sim_gather",
           {"gather"})
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("sync debug mode left on after the audit")


def conservation_full_path(kp, n_ops) -> dict:
    """SIM201–SIM203 over a sharded YCSB-B split replay (8 x 2 chips, as
    phase 3b; 1 / CUT_LOAD of the key pages, all the ops) on a metered
    timeline, a run of its own: reads equal the oracle, and the busy-time,
    energy and byte books balance."""
    kp //= CUT_LOAD
    label, wl, config = ycsb_paths(kp, n_ops)[0]
    tl = make_metered_timeline(params=FlashParams(
        channels=SSD_CHANNELS, dies_per_channel=SSD_DIES))
    rep, grew, backend, _ = run_replay(
        f"metered sharded {label}", wl, kp, SSD_CHANNELS * SSD_DIES, config,
        TimedSharded, channels=SSD_CHANNELS, dies_per_channel=SSD_DIES,
        timeline=tl)
    check_replay(label, wl, rep, grew, config, kp)
    t0 = time.perf_counter()
    findings = audit_books("sharded", rep, backend, tl)
    audit_s = time.perf_counter() - t0
    if findings:
        raise AssertionError("conservation books do not balance: "
                             f"{[f.format() for f in findings]}")
    lines = {e.line.split(":")[0] for e in tl.events}
    log(f"conservation, metered sharded {label} [{kp} key pages, "
        f"{len(wl.ops)} ops, 8 x 2 chips]: {len(tl.events)} metered "
        f"intervals on {len({e.line for e in tl.events})} lines "
        f"({sorted(lines)}), {tl.match_queries} match queries; busy time, "
        f"energy ({tl.sim.energy.total_pj:.1f} pJ) and bytes (internal "
        f"{tl.sim.stats.internal_bytes}, PCIe {tl.sim.stats.pcie_bytes}) "
        f"balance, checked in {audit_s:.3f} s; reads equal the oracle")
    del backend
    return grew


def auditor_phase(kp, n_ops) -> dict:
    launches = auditor_cli_path()
    doctored_path()
    add_launches(launches, conservation_full_path(kp, n_ops))
    return launches


# ------------------------------------------------------- phase 4: indexes
# Each index path compares its first bursts of each kind against
# ScalarBackend, response by response.
N_COMPARED = 8
# The B+Tree's leaf fill (the JAX package's default) and YCSB workloade's
# maxscanlength; a wide range covers 2 % of the key space.
LEAF_FILL, MAX_SCAN, WIDE_FRACTION = 404, 100, 0.02
SECONDARY_COLUMNS = (("gender", 1), ("age", 7), ("salary", 20), ("uid", 32))


def same_response(a, b, where) -> None:
    """Two responses equal field for field, arrays by value and dtype."""
    if type(a) is not type(b):
        raise AssertionError(f"{where}: {type(a).__name__} against "
                             f"{type(b).__name__}")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            same_response(x, y, where)
        elif isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{where}: {f.name} differs from the "
                                     "scalar reference")
        elif x != y:
            raise AssertionError(f"{where}: {f.name} {x!r} against the "
                                 f"scalar reference's {y!r}")


class IndexBackend(BatchedKernelBackend):
    """The batched backend of the index phase.

    While ``record`` names a kind of burst, every flush that carries
    commands also runs them on ``ScalarBackend`` over a copy of the stored
    pages (``convert``; made anew after any program), and holds each
    response and the burst's ``result_bytes`` against the reference's.
    Eager programs are timed apart, as the bulk load, and so is the
    reference's work."""

    def __init__(self, chips, **kw):
        super().__init__(chips, **kw)
        self.record = None
        self.compared: dict[str, int] = {}
        self.load_s = self.compare_s = 0.0
        self._queued = []
        self._mirror = None

    def program_entries(self, page_addr, entries, **kw):
        self._mirror = None
        t0 = time.perf_counter()
        built = super().program_entries(page_addr, entries, **kw)
        self.load_s += time.perf_counter() - t0
        return built

    def _execute_programs(self):
        addrs = super()._execute_programs()
        if addrs:
            self._mirror = None
        return addrs

    def _queue(self, kind, cmd, ticket):
        if self.record is not None:
            self._queued.append((kind, cmd, ticket))
        return ticket

    def submit_search(self, cmd):
        return self._queue("search", cmd, super().submit_search(cmd))

    def submit_gather(self, cmd):
        return self._queue("gather", cmd, super().submit_gather(cmd))

    def submit_lookup(self, cmd):
        return self._queue("lookup", cmd, super().submit_lookup(cmd))

    def submit_plan(self, cmd):
        return self._queue("plan", cmd, super().submit_plan(cmd))

    def flush(self):
        queued, self._queued = self._queued, []
        before = self.stats.result_bytes
        super().flush()
        if not queued:
            return
        got = [t.result() for _, _, t in queued]   # this burst's host tails
        card_bytes = self.stats.result_bytes - before
        t0 = time.perf_counter()
        if self._mirror is None:
            self._mirror = ScalarBackend(chip_array_from_numpy(
                chip_array_to_numpy(self.chips)))
        ref = self._mirror
        before = ref.stats.result_bytes
        refs = [getattr(ref, f"submit_{kind}")(cmd) for kind, cmd, _ in queued]
        ref.flush()
        where = f"{self.record} burst {self.compared.get(self.record, 0)}"
        for i, (a, t) in enumerate(zip(got, refs)):
            same_response(a, t.result(), f"{where}, command {i}")
        if card_bytes != ref.stats.result_bytes - before:
            raise AssertionError(f"{where}: result_bytes {card_bytes}, the "
                                 "scalar reference's "
                                 f"{ref.stats.result_bytes - before}")
        self.compared[self.record] = self.compared.get(self.record, 0) + 1
        self.compare_s += time.perf_counter() - t0


def grown(before) -> dict:
    """Launches by kernel since the ``dict(native.LAUNCHES)`` snapshot."""
    return {k: native.LAUNCHES[k] - before[k] for k in before
            if native.LAUNCHES[k] != before[k]}


def counted(label, expect, fn, *args):
    """Call an index method; its launches by kernel must equal ``expect``
    (kernels that should not launch may be left out or given 0)."""
    before = dict(native.LAUNCHES)
    out = fn(*args)
    want = {k: v for k, v in expect.items() if v}
    if grown(before) != want:
        raise AssertionError(f"{label}: launched {grown(before)}, expected "
                             f"{want}")
    return out


def index_path_begin():
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    return before, time.perf_counter()


def index_path_end(label, backend, t0, before, n_ops, extra,
                   compared) -> dict:
    """Log the path; check its launches add up and that each kind of burst
    in ``compared`` was held against ScalarBackend that many times."""
    for kind, n in compared.items():
        if backend.compared.get(kind, 0) < n:
            raise AssertionError(f"{label}: {backend.compared.get(kind, 0)} "
                                 f"{kind} bursts compared, expected {n}")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = {k: v for k, v in native.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    if sum(grew.values()) != backend.stats.kernel_launches:
        raise AssertionError(f"{label}: launches by kernel {grew} do not add "
                             f"up to kernel_launches "
                             f"{backend.stats.kernel_launches}")
    run_s = wall_s - backend.load_s - backend.compare_s
    log(f"index {label}: wall {wall_s:.3f} s (bulk load "
        f"{backend.load_s:.3f} s, ScalarBackend comparisons "
        f"{backend.compare_s:.3f} s), {n_ops} ops, {n_ops / run_s:.1f} ops/s "
        f"after the load and without the comparisons; "
        f"{extra}; flushes {backend.stats.flushes}, kernel_launches "
        f"{backend.stats.kernel_launches}, launches by kernel {grew}, "
        f"staged_bytes {backend.stats.staged_bytes}, result_bytes "
        f"{backend.stats.result_bytes}, resident rows "
        f"{backend.store.resident_rows}, compared with ScalarBackend "
        f"{backend.compared}, peak device memory {peak} bytes ({before} "
        f"allocated before the path)")
    return grew


def plan_flush_ms(label, backend, pages, plan) -> None:
    """Device time of one plan flush over ``pages`` (resident), apart: the
    ``take`` of its padded rows, then the ``sim_plan`` kernel on them.
    Called after the path's launches are read; its launches count
    nowhere."""
    rows = backend.store.rows_for(pages)
    n_pad = padded_rows(len(rows), PAGE_BLOCK)
    cmd = Command.plan(0, plan.include, plan.exclude)
    p_pad = next_pow2(cmd.n_passes)
    q, m, f = (words_to_tensor(a[None], backend.device) for a in
               plan_pass_rows(cmd.plan_include, cmd.plan_exclude, p_pad))
    taken = backend.store.take(rows, n_pad)
    take_ms = device_ms(lambda: backend.store.take(rows, n_pad), 25)
    kernel_ms = device_ms(lambda: sim_plan(*taken[:2], q, m, f, *taken[2:],
                                           randomized=True), 25)

    def flush():
        lo, hi, ids, seeds = backend.store.take(rows, n_pad)
        return sim_plan(lo, hi, q, m, f, ids, seeds, randomized=True)
    flush_ms = device_ms(flush, 25)
    log(f"plan flush {label} [G=1, P={p_pad} ({cmd.n_passes} passes), "
        f"N={n_pad} ({len(rows)} pages)]: take {take_ms:.6f} ms "
        f"({n_pad * 4096} bytes of planes copied), sim_plan {kernel_ms:.6f} "
        f"ms, take + sim_plan {flush_ms:.6f} ms a flush (device time)")


def btree_path(n_leaves) -> dict:
    """SimBTree over ``n_leaves`` leaves of 404 random keys on 16 chips:
    64 lookup bursts (48 present, 16 absent keys, some below the smallest),
    256 ranges of up to 100 keys and 4 of 2 % of the key space, each
    against a sorted-array oracle."""
    rng = np.random.default_rng(17)
    n_keys = n_leaves * LEAF_FILL
    keys = np.unique(rng.integers(1, 2**64 - 1, n_keys + n_keys // 64,
                                  dtype=np.uint64))
    keys = rng.permutation(keys)[:n_keys]
    sk = np.sort(keys)
    values = (keys * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    sv = (sk * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    chips = SimChipArray(n_chips=16, pages_per_chip=-(-2 * n_leaves // 16)
                         + 1, device_seed=7)
    backend = IndexBackend(chips)
    before, t0 = index_path_begin()
    bt = SimBTree(backend, leaf_fill=LEAF_FILL)
    bt.bulk_load(keys, values)
    del keys, values
    if len(bt.leaves) != n_leaves:
        raise AssertionError(f"{len(bt.leaves)} leaves for {n_leaves}")

    def oracle(q):
        q = np.asarray(q, np.uint64)
        pos = np.minimum(np.searchsorted(sk, q), len(sk) - 1)
        return [int(sv[p]) if sk[p] == k else None for k, p in zip(q, pos)]

    for b in range(64):
        present = rng.choice(sk, 48, replace=False)
        absent = rng.integers(1, 2**64 - 1, 16, dtype=np.uint64)
        absent[:4] = rng.integers(1, int(sk[0]), 4, dtype=np.uint64)
        probe = [int(k) for k in rng.permutation(np.concatenate(
            [present, absent]))]
        backend.record = "btree lookup" if b < N_COMPARED else None
        got = counted("lookup_batch", {"sim_lookup": 1}, bt.lookup_batch,
                      probe)
        if got != oracle(probe):
            raise AssertionError(f"lookup burst {b} differs from the oracle")
    backend.record = None
    below = [int(k) for k in rng.integers(1, int(sk[0]), 8, dtype=np.uint64)]
    if counted("lookup_batch below", {}, bt.lookup_batch, below) != \
            [None] * 8:
        raise AssertionError("keys below the smallest key hit")
    wide = int(WIDE_FRACTION * len(sk))
    ranges = []
    for _ in range(256):
        i = int(rng.integers(0, len(sk) - MAX_SCAN))
        ranges.append((i, i + int(rng.integers(1, MAX_SCAN + 1)), "short"))
    for _ in range(4):
        i = int(rng.integers(0, len(sk) - wide))
        ranges.append((i, i + wide, "wide"))
    leaves_of = {"short": [], "wide": []}
    passes = []
    for n, (i, j, kind) in enumerate(ranges):
        lo, hi = int(sk[i]), int(sk[j - 1]) + 1
        backend.record = (f"btree {kind} range"
                          if n < N_COMPARED or kind == "wide" else None)
        rows = counted("range_query", {"sim_plan": 1, "sim_gather": 1},
                       bt.range_query, lo, hi)
        if sorted(rows) != list(zip(sk[i:j].tolist(), sv[i:j].tolist())):
            raise AssertionError(f"range {n} ({kind}) differs from the "
                                 "oracle")
        passes.append(exact_range(lo, hi).n_passes)
        i0 = max(bisect.bisect_right(bt._separators, lo) - 1, 0)
        leaves_of[kind].append(sum(1 for leaf in bt.leaves[i0:]
                                   if leaf.low_key < hi))
    backend.record = None
    n_ops = 64 * 64 + 8 + len(ranges)
    grew = index_path_end(
        "B+Tree", backend, t0, before, n_ops,
        f"{n_leaves} leaves ({2 * n_leaves} pages, {len(sk)} keys), 64 "
        f"lookup bursts of 64 + 1 of 8 below the smallest key, 256 ranges "
        f"of 1-{MAX_SCAN} keys ({min(leaves_of['short'])}-"
        f"{max(leaves_of['short'])} leaves), 4 of {wide} keys "
        f"({min(leaves_of['wide'])}-{max(leaves_of['wide'])} leaves); "
        f"{max(passes)} plan passes at most",
        {"btree lookup": N_COMPARED, "btree short range": N_COMPARED,
         "btree wide range": 4})
    want = {"sim_lookup": 64, "sim_plan": len(ranges),
            "sim_gather": len(ranges)}
    if grew != want:
        raise AssertionError(f"B+Tree path launched {grew}, expected {want}")
    i, j, _ = ranges[-1]
    lo, hi = int(sk[i]), int(sk[j - 1]) + 1
    i0 = max(bisect.bisect_right(bt._separators, lo) - 1, 0)
    plan_flush_ms("B+Tree wide range", backend,
                  [leaf.key_page for leaf in bt.leaves[i0:]
                   if leaf.low_key < hi], exact_range(lo, hi))
    return grew


def hash_path(n_inserts) -> dict:
    """SimHashIndex with its defaults (the §VI write buffer at 16 pages) on
    its own chips: ``n_inserts`` inserts, 1,024 updates (at most one a
    key), then 64 probe
    bursts of 48 present and 16 absent keys, against a dict.  Every split
    is one ``sim_search`` and one ``sim_gather``."""
    rng = np.random.default_rng(23)
    keys = np.unique(rng.integers(1, 2**64 - 1, n_inserts + 64 * 16 + 64,
                                  dtype=np.uint64))
    keys = [int(k) for k in rng.permutation(keys)]
    keys, absent = keys[:n_inserts], keys[n_inserts:n_inserts + 64 * 16]
    chips = SimChipArray(n_chips=16, pages_per_chip=64, device_seed=11)
    backend = IndexBackend(chips)
    before, t0 = index_path_begin()
    h = SimHashIndex(backend)
    oracle = {}

    def insert(k, v):
        backend.record = "hash split" if h.splits < N_COMPARED else None
        launches, splits = dict(native.LAUNCHES), h.splits
        h.insert(k, v)
        n = h.splits - splits
        if grown(launches) != ({"sim_search": n, "sim_gather": n} if n
                               else {}):
            raise AssertionError(f"insert with {n} splits launched "
                                 f"{grown(launches)}")
        oracle[k] = v

    for i, k in enumerate(keys):
        insert(k, i + 1)
    backend.load_s = insert_s = time.perf_counter() - t0   # the load
    n_updates = min(1024, len(keys))
    for j in rng.choice(len(keys), n_updates, replace=False):
        insert(keys[j], oracle[keys[j]] * 7)
    update_s = time.perf_counter() - t0 - insert_s
    backend.record = None
    for b in range(64):
        present = [keys[j] for j in rng.choice(len(keys), 48, replace=False)]
        probe = present + absent[16 * b:16 * (b + 1)]
        h.flush_writes()
        backend.record = "hash probe" if b < N_COMPARED else None
        got = counted("lookup_batch", {"sim_search": 1, "sim_gather": 1},
                      h.lookup_batch, probe)
        if got != [oracle.get(k) for k in probe]:
            raise AssertionError(f"probe burst {b} differs from the dict")
    backend.record = None
    grew = index_path_end(
        "hash", backend, t0, before, n_updates + 64 * 64,
        f"the load: {len(keys)} inserts, {len(keys) / insert_s:.1f} a "
        f"second; {n_updates} updates in "
        f"{update_s:.3f} s, 64 probe bursts of 64; {h.splits} splits, "
        f"global depth {h.global_depth}, {len(h.buckets)} buckets, "
        f"write buffer {dataclasses.asdict(h.write_buffer.stats)}",
        {"hash split": 2 * min(h.splits, N_COMPARED),
         "hash probe": 2 * N_COMPARED})
    want = {"sim_search": h.splits + 64, "sim_gather": h.splits + 64}
    if grew != want:
        raise AssertionError(f"hash path launched {grew}, expected {want}")
    return grew


def secondary_path(n_rows) -> dict:
    """SimSecondaryIndex over ``n_rows`` rows of the range-query example's
    codec (gender 1, age 7, salary 20, uid 32 bits): gender == 1, then
    2001 <= salary < 7000 exact and approximate, each one ``sim_plan``
    flush over every page and one ``sim_gather`` flush, against the
    decoded predicate."""
    rng = np.random.default_rng(29)
    codec = RowCodec([Column(*c) for c in SECONDARY_COLUMNS])
    rows = {"gender": rng.integers(0, 2, n_rows),
            "age": rng.integers(18, 96, n_rows),
            "salary": rng.integers(0, 200_000, n_rows),
            "uid": np.arange(n_rows)}
    n_pages = -(-n_rows // ROWS_PER_PAGE)
    chips = SimChipArray(n_chips=16, pages_per_chip=-(-n_pages // 16) + 1,
                         device_seed=13)
    backend = IndexBackend(chips)
    before, t0 = index_path_begin()
    si = SimSecondaryIndex(backend, codec)
    si.load_rows(rows)
    sal = rows["salary"]
    cases = [("equals", si.select_equals, ("gender", 1),
              rows["gender"] == 1),
             ("exact range", si.select_range, ("salary", 2001, 7000),
              (sal >= 2001) & (sal < 7000)),
             ("approximate range",
              lambda *a: si.select_range(*a, exact=False),
              ("salary", 2001, 7000), (sal >= 2001) & (sal < 7000))]
    times = []
    for label, fn, args, want in cases:
        t1, c1 = time.perf_counter(), backend.compare_s
        backend.record = f"secondary {label}"
        got = counted(f"select {label}", {"sim_plan": 1, "sim_gather": 1},
                      fn, *args)
        run_s = time.perf_counter() - t1 - (backend.compare_s - c1)
        times.append(f"{label} {run_s:.3f} s, {got.size} rows")
        if not np.array_equal(np.sort(codec.decode_rows(got, "uid")),
                              np.nonzero(want)[0]):
            raise AssertionError(f"select {label} differs from the decoded "
                                 "predicate")
    backend.record = None
    grew = index_path_end(
        "secondary", backend, t0, before, len(cases),
        f"{n_rows} rows on {si.n_pages} pages; {'; '.join(times)}; "
        f"plan passes {[codec.range('salary', 2001, 7000, exact=e).n_passes for e in (True, False)]} "
        f"(exact, approximate)",
        {f"secondary {label}": 2 for label, *_ in cases})
    want = {"sim_plan": 3, "sim_gather": 3}
    if grew != want:
        raise AssertionError(f"secondary path launched {grew}, expected "
                             f"{want}")
    plan_flush_ms("secondary exact range", backend, si._page_addrs(),
                  codec.range("salary", 2001, 7000, exact=True))
    return grew


def database_index_path() -> dict:
    """The slice's entry point on the card, its launch counts set to 0 just
    before and read just after; its numbers must equal the CPU run's (the
    plain versions)."""
    native.reset_launches()
    card = database_index.main()
    torch.cuda.synchronize()
    grew = {k: v for k, v in native.LAUNCHES.items() if v}
    cpu = database_index.main(device="cpu")
    if card != cpu:
        raise AssertionError("database_index on the card differs from the "
                             "plain versions on the CPU")
    want = {"sim_lookup": 1, "sim_plan": 1, "sim_search": card["splits"] + 1,
            "sim_gather": card["splits"] + 2}
    if grew != want or not card["hash_ok"]:
        raise AssertionError(f"database_index launched {grew}, expected "
                             f"{want}")
    log(f"database_index: {card['lookups_agreed']} lookups agree with the "
        f"baseline ({card['sim_io_bytes']} B against "
        f"{card['baseline_io_bytes']} B), range {len(card['range_rows'])} "
        f"rows, {card['splits']} splits, directory depth "
        f"{card['global_depth']}; equal to the plain versions; launches "
        f"{grew}")
    return grew


def index_phase(kp) -> dict:
    """The §V indexes on the batched backend, each path's launch counts set
    to 0 just before it and read just after it: the B+Tree at ``kp``
    leaves, the hash index at ``2 * kp`` inserts, the secondary index at
    ``64 * kp`` rows, then ``repro_torch.database_index``.  Returns the
    launches by kernel summed over the paths."""
    launches = {k: 0 for k in native.LAUNCHES}
    for grew in (btree_path(kp), hash_path(2 * kp), secondary_path(64 * kp),
                 database_index_path()):
        for k, v in grew.items():
            launches[k] += v
    for k in INDEX_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on the index paths")
    log("indexes: every lookup, range, probe and select equals its numpy "
        "oracle, the first bursts of each kind equal ScalarBackend response "
        "by response with equal result_bytes, every call made its exact "
        "launches")
    return launches


def quickstart_path() -> dict:
    """The quickstart on the card, its launch counts set to 0 just before
    and read just after; its outputs must equal the CPU run's (the plain
    versions) and the known hit and counts."""
    native.reset_launches()
    card = quickstart.main()
    torch.cuda.synchronize()
    grew = dict(native.LAUNCHES)
    if (grew["sim_search"], grew["sim_fused"]) != (1, 1) or \
            sum(grew.values()) != 2:
        raise AssertionError(f"quickstart launched {grew}")
    cpu = quickstart.main(device="cpu")
    if card["hits"] != [(1, 8 + 119)] or \
            card["fused"][2].tolist() != [0, 1, 0, 0]:
        raise AssertionError(f"quickstart: hits {card['hits']}, fused "
                             f"counts {card['fused'][2].tolist()}")
    same = (card["slot"] == cpu["slot"] and card["key"] == cpu["key"]
            and np.array_equal(card["search"], cpu["search"])
            and all(np.array_equal(a, b)
                    for a, b in zip(card["fused"], cpu["fused"])))
    if not same:
        raise AssertionError("quickstart on the card differs from the plain "
                             "versions on the CPU")
    log(f"quickstart: search hit {card['hits']}, fused chunk counts "
        f"{card['fused'][2].tolist()}, equal to the plain versions; "
        f"launches {grew}")
    return grew


def paged_recount(reqs, completions, page_tokens) -> PagedStats:
    """The block table's counters from the requests alone: every written
    position (the prompt, then each decode step's input token) is one lookup
    search; a new 16-token block is one allocation and one table program;
    retiring is one search, one program and frees every block."""
    tokens = {c.req_id: len(c.tokens) for c in completions}
    want = PagedStats()
    for r in reqs:
        written = len(r.prompt) + tokens[r.req_id] - 1
        blocks = -(-written // page_tokens)
        want.searches += written + 1
        want.programs += blocks + 1
        want.pages_allocated += blocks
        want.pages_freed += blocks
    return want


def check_gather(model, dev) -> None:
    """A second, small run on the served model and a fresh paged cache: a
    sequence of 18 positions (two pages) is gathered from the pool and must
    equal its slot's contiguous cache bit for bit."""
    cache = SimPagedKVCache(model.cfg, n_pages=256, page_tokens=16,
                            device=dev)
    eng = ServeEngine(model, max_slots=1, cache_len=SERVE_CACHE_LEN,
                      paged_cache=cache)
    eng.submit(Request(req_id=0, prompt=list(range(100, 114)),
                       max_new_tokens=8))
    for _ in range(4):
        eng.step()
    slot = eng.slots[0]
    k, v = cache.gather_sequence(0, slot.position)
    ck, cv = slot.caches["kv"]
    if not (slot.position == 18 and torch.equal(k, ck[:, 0, :18])
            and torch.equal(v, cv[:, 0, :18])):
        raise AssertionError("gather_sequence differs from the slot cache")
    eng.run()


def check_logits(model, reqs, completions, dev) -> float:
    """First-token logits of two prompts through the kernel path and through
    the same prefill with the plain attention; returns the larger relative
    L2 error, which must be within LOGITS_REL_TOL."""
    first = {c.req_id: c.tokens[0] for c in completions}
    worst = 0.0
    for r in reqs[:2]:
        tokens = torch.tensor([r.prompt], device=dev)
        got = prefill(model, tokens, SERVE_CACHE_LEN)[0][0]
        plain = prefill(model, tokens, SERVE_CACHE_LEN,
                        attention=attention_ref)[0][0]
        real = slice(0, model.cfg.vocab_size)
        if not (torch.isfinite(got[real]).all()
                and torch.isfinite(plain[real]).all()):
            raise AssertionError("non-finite first-token logits")
        rel = float((got[real] - plain[real]).norm() / plain[real].norm())
        worst = max(worst, rel)
        log(f"serve check: request {r.req_id} first-token logits vs plain "
            f"attention: rel L2 err {rel:.3e}, argmax {int(got.argmax())} "
            f"(served {first[r.req_id]}), plain argmax "
            f"{int(plain.argmax())}")
        if int(got.argmax()) != first[r.req_id]:
            raise AssertionError("the recomputed first token differs from "
                                 "the served one")
    if worst > LOGITS_REL_TOL:
        raise AssertionError(f"first-token logits differ from the plain "
                             f"attention by {worst:.3e} > {LOGITS_REL_TOL}")
    return worst


def serve_path(dev) -> dict:
    """qwen3-4b at full width and depth served from the SiM-paged cache with
    the settings of the JAX package's launch/serve.py, its launch counts
    set to 0 just before and read just after."""
    cfg = get_config(SERVE_ARCH)
    reqs = requests(8, cfg.vocab_size, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    completions, engine, cache = serve(SERVE_ARCH, reduced=False, paged=True,
                                       cache_len=SERVE_CACHE_LEN)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    model = engine.model
    n_params = sum(p.numel() for p in model.parameters())
    tokens = sum(len(c.tokens) for c in completions)
    log(f"serve {SERVE_ARCH} (full: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} parameters, {cfg.dtype}), paged: wall "
        f"{wall_s:.3f} s (init and run), run {engine.run_s:.3f} s, "
        f"{tokens} tokens, {tokens / engine.run_s:.2f} tokens/s; "
        f"{engine.prefills} prefills, "
        f"{1e3 * engine.prefill_s / engine.prefills:.3f} ms each; "
        f"{engine.decodes} decode steps, "
        f"{1e3 * engine.decode_s / engine.decodes:.3f} ms each; paged "
        f"{cache.stats}; launches {grew}; peak device memory {peak} bytes")

    done = {c.req_id: c for c in completions}
    if sorted(done) != [r.req_id for r in reqs] or any(
            len(done[r.req_id].tokens) != r.max_new_tokens for r in reqs):
        raise AssertionError("a request did not complete with its "
                             "max_new_tokens")
    if grew["flash_attention"] != cfg.n_layers * (engine.prefills
                                                  + engine.decodes) or \
            sum(grew.values()) != grew["flash_attention"]:
        raise AssertionError(f"launches {grew} for {engine.prefills} "
                             f"prefills and {engine.decodes} decode steps")
    want = paged_recount(reqs, completions, cache.page_tokens)
    if cache.stats != want or want.pages_freed != want.pages_allocated:
        raise AssertionError(f"paged counters {cache.stats}, recount {want}")
    check_gather(model, dev)
    rel = check_logits(model, reqs, completions, dev)
    log(f"serve: every request completed with its max_new_tokens, "
        f"flash_attention launches = {cfg.n_layers} x (prefills + decode "
        f"steps), paged counters equal the recount and every page was freed, "
        f"a gathered sequence equals its slot cache, first-token logits "
        f"within {rel:.3e} <= {LOGITS_REL_TOL} of the plain attention")
    return grew


def reduced_serve_path(dev) -> dict:
    """``python -m repro_torch.launch.serve --arch qwen3-4b --paged`` as a
    user runs it: the reduced config (16-wide heads) on the default device,
    the card, its launch counts set to 0 just before and read just after.
    Every attention runs the kernel; the block table's counters equal the
    recount from the requests, and the first-token logits are held against
    the same prefill with the plain attention."""
    torch.cuda.synchronize()
    native.reset_launches()
    completions, engine, cache = serve(SERVE_ARCH, paged=True, verbose=False)
    torch.cuda.synchronize()
    grew = dict(native.LAUNCHES)
    cfg = engine.model.cfg
    if cfg.head_dim != 16:
        raise AssertionError(f"the reduced config has head dim {cfg.head_dim}")
    if grew["flash_attention"] != cfg.n_layers * (engine.prefills
                                                  + engine.decodes) or \
            sum(grew.values()) != grew["flash_attention"]:
        raise AssertionError(f"reduced serve: launches {grew} for "
                             f"{engine.prefills} prefills and "
                             f"{engine.decodes} decode steps")
    reqs = requests(len(completions), cfg.vocab_size, 0)
    want = paged_recount(reqs, completions, cache.page_tokens)
    if cache.stats != want or want.pages_freed != want.pages_allocated:
        raise AssertionError(f"reduced serve: paged counters {cache.stats}, "
                             f"recount {want}")
    rel = check_logits(engine.model, reqs, completions, dev)
    log(f"reduced serve {SERVE_ARCH} ({cfg.n_layers} layers, {cfg.n_heads} q "
        f"/ {cfg.n_kv_heads} kv heads of {cfg.head_dim}, {cfg.dtype}) on the "
        f"card: {sum(len(c.tokens) for c in completions)} tokens, "
        f"{engine.prefills} prefills, {engine.decodes} decode steps, "
        f"launches {grew}, paged {cache.stats} (equal to the recount); "
        f"first-token logits within {rel:.3e} <= {LOGITS_REL_TOL} of the "
        f"plain attention")
    return grew


# ------------------------------------------------------ phase 7: training
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 5
TRAIN_LR = 3e-4     # AdamW's default; at 3e-3 the full model's loss rises
# Tolerance of step 0's loss and of each parameter's gradient through the
# kernel against the same step through the plain attention: relative L2
# error.  The backward is the same ``attend`` VJP in both, but at
# activations that differ where the kernel's bf16 attention output rounds
# otherwise than the plain one's (the serve path's bound, LOGITS_REL_TOL).
GRAD_REL_TOL = LOGITS_REL_TOL
RESUME_LAYERS = 2
CKPT_ROOT = Path(__file__).resolve().parent / "build" / "train_ckpt"


def launches_per_step(cfg) -> int:
    """Flash attention launches of one train step: one a layer in the
    forward and, under remat, one a layer when the backward recomputes the
    block; the backward itself (the ``attend`` VJP) launches nothing."""
    return cfg.n_layers * (1 if cfg.remat == "none" else 2)


def step0_gradients(cfg, dev) -> float:
    """Step 0 of the full run once more, through the kernel and through the
    plain attention (this run's launches are a comparison, not the path):
    every gradient finite, wq/wk/wv non-zero in every layer, the loss and
    each leaf within GRAD_REL_TOL.  Returns the worst relative error."""
    model = init_model(cfg, seed=0, device=dev)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    b = batch_at_step(data, 0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, _), grads = value_and_grad(model, b["tokens"], b["labels"])
    torch.cuda.synchronize()
    grad_ms = 1e3 * (time.perf_counter() - t0)
    for name, g in grads.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"train: non-finite gradient of {name}")
    for name in ("wq", "wk", "wv"):
        per_layer = grads[f"blocks.attn.{name}"].float().abs().sum(
            dim=(1, 2, 3))
        if not (per_layer > 0).all():
            raise AssertionError(f"train: a zero {name} gradient: "
                                 f"{per_layer.tolist()}")
    (ploss, _), pgrads = value_and_grad(model, b["tokens"], b["labels"],
                                        attention=plain_attention)
    worst = abs(float(loss) - float(ploss)) / abs(float(ploss))
    where = "loss"
    for name, g in grads.items():
        ref = pgrads[name].float()
        rel = float((g.float() - ref).norm() / ref.norm())
        if rel > worst:
            worst, where = rel, name
    log(f"train check: step 0 through the kernel vs the plain attention: "
        f"loss {float(loss):.6f} vs {float(ploss):.6f}; {len(grads)} "
        f"gradients finite, wq/wk/wv non-zero in all {cfg.n_layers} layers; "
        f"worst rel L2 err {worst:.3e} ({where}), tol {GRAD_REL_TOL}")
    if worst > GRAD_REL_TOL:
        raise AssertionError(f"train: step 0 differs from the plain "
                             f"attention by {worst:.3e} ({where})")
    del pgrads
    # Where a step's time goes, host clock ending in a synchronize: the
    # loss and gradient under each remat policy, then one AdamW update.
    times = {f"value_and_grad, remat {cfg.remat}": grad_ms}
    for remat in ("none", "full"):
        del grads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = value_and_grad(model, b["tokens"], b["labels"],
                                  remat=remat)
        torch.cuda.synchronize()
        times[f"value_and_grad, remat {remat}"] = \
            1e3 * (time.perf_counter() - t0)
    opt_cfg = AdamWConfig(moment_dtype=cfg.optimizer_dtype)
    state = init_opt_state(param_tree(model), opt_cfg)
    grads = nest(grads)
    for i in range(2):          # the first update's time holds allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adamw_update(grads, state, param_tree(model), opt_cfg)
        torch.cuda.synchronize()
        times[f"adamw_update {i}"] = 1e3 * (time.perf_counter() - t0)
    log("train step parts (ms, host clock to a synchronize): " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    return worst


def profile_steps(dev) -> None:
    """Device time by kernel over two full-size steps (``torch.profiler``,
    after one unprofiled step), against their wall time: the device's
    busy share of a step."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(TRAIN_ARCH)
    model = init_model(cfg, seed=0, device=dev)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, moment_dtype=cfg.optimizer_dtype)
    state = init_opt_state(param_tree(model), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    model, state, m = step(model, state, batch_at_step(data, 0, device=dev))
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in (1, 2):
            model, state, m = step(model, state,
                                   batch_at_step(data, s, device=dev))
            float(m["loss"])
        wall_ms = 1e3 * (time.perf_counter() - t0) / 2
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 2e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"train profile (olmo-1b full, 2 steps under torch.profiler): wall "
        f"{wall_ms:.3f} ms a step, device kernels {busy_ms:.3f} ms a step "
        f"(busy {busy_ms / wall_ms:.3f}); top kernels, ms a step: " +
        "; ".join(f"{e.key[:60]} {e.self_device_time_total / 2e3:.3f} "
                  f"({e.count // 2} calls)" for e in top))


def attention_backward_times(dev) -> None:
    """The gradient of one attention at the training shape: the kernel's
    Function (forward launch, then the ``attend`` VJP recomputed) beside
    SDPA's forward and backward (timed only; the port never calls it)."""
    shape = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 128)
    q, k, v = (t.requires_grad_() for t in attn_inputs(
        dev, torch.bfloat16, shape, 99))
    g = torch.ones_like(q)
    kw = dict(causal=True)
    fa = device_ms(lambda: torch.autograd.grad(
        flash_attention(q, k, v, **kw), (q, k, v), g), 20)
    bwd = device_ms(lambda: torch.autograd.grad(
        plain_attention(q, k, v, **kw), (q, k, v), g), 20)
    lib = device_ms(lambda: torch.autograd.grad(
        sdpa(q, k, v, shape, kw), (q, k, v), g.transpose(1, 2)), 20)
    log(f"attention gradient [olmo-1b training, {shape}, bf16, causal]: "
        f"kernel forward + attend VJP {fa:.6f} ms; the attend forward + VJP "
        f"alone {bwd:.6f} ms; SDPA forward + backward {lib:.6f} ms")


def full_train_path(dev, smi) -> dict:
    """olmo-1b at full width and depth through ``train(reduced=False)``,
    its launch counts set to 0 just before and read just after."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    run = train(TRAIN_ARCH, steps=TRAIN_STEPS, reduced=False,
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, lr=TRAIN_LR,
                verbose=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN_STEPS * launches_per_step(cfg)
    if grew["flash_attention"] != want or sum(grew.values()) != want:
        raise AssertionError(f"train: launches {grew}, expected {want} "
                             f"flash_attention")
    if not all(np.isfinite(run.losses)) or run.steps_run != TRAIN_STEPS:
        raise AssertionError(f"train: losses {run.losses}")
    steady = sorted(run.step_s[1:])[len(run.step_s[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in LM(
        cfg, torch.device("meta")).parameters())
    log(f"train {TRAIN_ARCH} (full: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} parameters, {cfg.dtype}, moments "
        f"{cfg.optimizer_dtype}, remat {cfg.remat}), batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: wall {wall_s:.3f} s (init and {TRAIN_STEPS} steps); "
        f"step ms {[round(1e3 * t, 3) for t in run.step_s]}, median of "
        f"steps 1-{TRAIN_STEPS - 1} {1e3 * steady:.3f} ms, "
        f"{tokens / steady:.1f} tokens/s; losses {run.losses}; launches "
        f"{grew} ({launches_per_step(cfg)} a step); peak device memory "
        f"{peak} bytes; card {smi}")
    step0_gradients(cfg, dev)
    attention_backward_times(dev)
    profile_steps(dev)
    return grew


def reduced_train_path() -> dict:
    """``python -m repro_torch.launch.train --arch olmo-1b`` at the JAX
    test's settings on the card: the loss must fall by more than 0.3."""
    torch.cuda.synchronize()
    native.reset_launches()
    run = train(TRAIN_ARCH, steps=30, batch=8, seq_len=32, lr=3e-3,
                verbose=False)
    torch.cuda.synchronize()
    grew = dict(native.LAUNCHES)
    cfg = reduced_config(get_config(TRAIN_ARCH))
    early, late = np.mean(run.losses[:5]), np.mean(run.losses[-5:])
    want = 30 * launches_per_step(cfg)
    if grew["flash_attention"] != want or sum(grew.values()) != want:
        raise AssertionError(f"reduced train: launches {grew}, expected "
                             f"{want}")
    if not late < early - 0.3:
        raise AssertionError(f"reduced train: loss {early} -> {late}")
    log(f"reduced train {TRAIN_ARCH} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}) on the card: 30 steps, mean loss of the first five "
        f"{early:.4f}, of the last five {late:.4f} (fell "
        f"{early - late:.4f} > 0.3); launches {grew}")
    return grew


def resume_path() -> dict:
    """Crash and bitwise resume at full width, ``n_layers`` cut to
    RESUME_LAYERS: the run straight through and the run crashed at step 12
    and restarted from its step-10 checkpoint give bitwise equal losses
    for steps 10-19.  Deterministic algorithms and the cuBLAS workspace
    setting they require are switched on here and restored after."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    kw = dict(steps=20, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, lr=1e-3,
              verbose=False, ckpt_every=10)
    env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    det_before = torch.are_deterministic_algorithms_enabled()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    try:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        full = train(cfg, ckpt_root=CKPT_ROOT / "a", **kw)
        try:
            train(cfg, ckpt_root=CKPT_ROOT / "b", crash_at=12, **kw)
        except RuntimeError as err:
            if "injected failure at step 12" not in str(err):
                raise
        else:
            raise AssertionError("resume: the injected crash did not fire")
        resumed = train(cfg, ckpt_root=CKPT_ROOT / "b", **kw)
    finally:
        torch.use_deterministic_algorithms(det_before)
        if env_before is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    torch.cuda.synchronize()
    grew = dict(native.LAUNCHES)
    want = (20 + 12 + 10) * launches_per_step(cfg)
    if grew["flash_attention"] != want or sum(grew.values()) != want:
        raise AssertionError(f"resume: launches {grew}, expected {want}")
    if resumed.resumed_from != 10 or full.losses[10:] != resumed.losses:
        raise AssertionError(f"resume: from {resumed.resumed_from}; losses "
                             f"{full.losses[10:]} vs {resumed.losses}")
    log(f"resume ({TRAIN_ARCH} full width, {RESUME_LAYERS} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}): crashed at step 12, resumed from "
        f"step 10, steps 10-19 bitwise equal ({resumed.losses[0]!r} ... "
        f"{resumed.losses[-1]!r}); {time.perf_counter() - t0:.3f} s with "
        f"four checkpoints; launches {grew}")
    return grew


def compressed_path(dev) -> dict:
    """The int8 error-feedback step (2 pods, stacked) beside the exact
    step: reduced olmo-1b in float32, remat none, fsdp off, 15 steps, the
    configuration and bounds of the JAX ``tests/test_distribution.py``."""
    cfg = dataclasses.replace(reduced_config(get_config(TRAIN_ARCH)),
                              dtype="float32", remat="none", fsdp=False)
    opt_cfg = AdamWConfig(lr=5e-3, warmup_steps=1)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
                      seed=1)
    mc, mr = (init_model(cfg, seed=0, device=dev) for _ in range(2))
    oc = init_opt_state(param_tree(mc), opt_cfg)
    orr = init_opt_state(param_tree(mr), opt_cfg)
    err = init_error_state(param_tree(mc), n_pods=2)
    step_c = make_compressed_train_step(cfg, opt_cfg)
    step_r = make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    native.reset_launches()
    losses, ref = [], []
    for s in range(15):
        batch = batch_at_step(data, s, device=dev)
        mc, oc, err, m = step_c(mc, oc, err, batch)
        mr, orr, r = step_r(mr, orr, batch)
        losses.append(float(m["loss"]))
        ref.append(float(r["loss"]))
    torch.cuda.synchronize()
    grew = dict(native.LAUNCHES)
    want = 15 * 3 * cfg.n_layers        # two pods' passes + the exact step
    if grew["flash_attention"] != want or sum(grew.values()) != want:
        raise AssertionError(f"compressed: launches {grew}, expected {want}")
    if not (losses[-1] < losses[0] - 0.2
            and abs(losses[-1] - ref[-1]) < 0.15):
        raise AssertionError(f"compressed: losses {losses}, exact {ref}")
    log(f"compressed step (2 pods, int8 error feedback) on the card: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, exact step's last "
        f"{ref[-1]:.4f} (|diff| {abs(losses[-1] - ref[-1]):.4f} < 0.15); "
        f"launches {grew}")
    return grew


def training_phase(dev, smi) -> dict:
    t0 = time.perf_counter()
    total = dict.fromkeys(native.LAUNCHES, 0)
    for grew in (full_train_path(dev, smi), reduced_train_path(),
                 resume_path(), compressed_path(dev)):
        add_launches(total, grew)
    log(f"phase 7 (training) took {time.perf_counter() - t0:.3f} s; "
        f"launches {total}")
    return total


# ------------------------------------------------- phase 8: model families
# hymba-1.5b serves with a 2,048-token cache, which its window of 1,024
# makes a ring of 1,024 slots.  Beside the launcher's 8 requests, two long
# ones: a 1,000-token prompt whose 48 new tokens decode across the ring's
# wrap, and a 1,536-token prompt whose prefill takes the s > C roll.
HYMBA_ARCH, HYMBA_CACHE_LEN = "hymba-1.5b", 2048
HYMBA_LONG = ((1000, 48), (1536, 8))
# mixtral-8x22b is cut to 12 of its 56 layers: 56 layers are 281.3 GB of
# bf16 weights, and 14 would leave under 9 GB of the 80 for the init's
# float32 chunk, activations and the allocator.
MOE_ARCH, MOE_LAYERS, MOE_CACHE_LEN = "mixtral-8x22b", 12, 128
VLM_ARCH, VLM_PROMPT, VLM_STEPS = "internvl2-26b", 320, 16
AUDIO_ARCH, AUDIO_PROMPT, AUDIO_STEPS = "whisper-medium", 8, 16
SSM_ARCH = "xlstm-350m"
# The xlstm check of tests/test_models_smoke.py: float32 prefill of S - 1
# tokens then one decode step against train_logits at the last two
# positions, within 2e-4 (absolute and relative).
SSM_TOL = 2e-4
# A ring slot against its position's k recomputed from the embeddings:
# relative L2 error.  Both are bf16 projections of the same input, by
# products of other shapes (the prefill projects the last C positions at
# once), so they may round apart by a bf16 ulp (2^-8); another position's
# k is a different vector, at a relative distance near sqrt(2).
RING_K_TOL, RING_K_OTHER = 2e-2, 0.5


def family_launches(cfg, prefills, decodes) -> dict:
    """The kernels' launches of a run: ``flash_attention`` once a decoder
    layer a prefill and a decode step (whisper adds a cross-attention a
    layer and, in prefill, an encoder layer each: 72 and 48 at full depth;
    xlstm has none), and where the layers have mamba heads ``mamba_conv``
    and ``mamba_scan`` as often; no other kernel."""
    want = dict.fromkeys(native.LAUNCHES, 0)
    if cfg.family == "ssm":
        return want
    if cfg.encoder_layers:
        want["flash_attention"] = (
            prefills * (2 * cfg.n_layers + cfg.encoder_layers)
            + decodes * 2 * cfg.n_layers)
        return want
    want["flash_attention"] = cfg.n_layers * (prefills + decodes)
    if cfg.family == "hybrid":
        want["mamba_conv"] = want["mamba_scan"] = want["flash_attention"]
    return want


def check_family_launches(label, grew, want) -> None:
    if grew != want:
        raise AssertionError(f"{label}: launches {grew}, expected {want}")


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm())


class PinnedRouting:
    """Pins the MoE's routing across two runs: every top-k and top-C choice
    (``models.moe.top_k_one_hot``) of the first run is recorded in call
    order and taken again by the second, which counts in ``flips`` the
    choices it would have made otherwise.  A routing choice is discrete: a
    router logit a bf16 rounding apart can swap two experts and change a
    token's output wholesale, which no bound on the attention's rounding
    covers; pinned, the two runs differ by the attention alone."""

    def __init__(self):
        self.recorded, self.replay, self.flips = [], None, 0

    def __enter__(self):
        self.original = moe_module.top_k_one_hot
        moe_module.top_k_one_hot = self.top_k_one_hot
        return self

    def __exit__(self, *exc):
        moe_module.top_k_one_hot = self.original

    def top_k_one_hot(self, scores, k):
        values, idx, one_hot = self.original(scores, k)
        if self.replay is None:
            self.recorded.append(idx)
            return values, idx, one_hot
        pinned = self.replay.pop(0)
        self.flips += int((pinned.sort(-1).values != idx.sort(-1).values)
                          .any(-1).sum())
        one_hot = (pinned[..., None] == torch.arange(
            scores.shape[-1], device=scores.device)).to(scores.dtype)
        return (torch.einsum("...kn,...n->...k", one_hot, scores), pinned,
                one_hot)

    def start_replay(self) -> None:
        self.replay = list(self.recorded)


class CheckedAttention:
    """The kernel's wrapper, each call also held to ``plain_attention`` on
    the same inputs within ATTN_TOL (phase 2's per-launch bound, here at
    the path's own inputs); ``worst`` is the largest absolute error."""

    def __init__(self, label):
        self.label, self.calls, self.worst = label, 0, 0.0

    def __call__(self, q, k, v, **kw):
        out = flash_attention(q, k, v, **kw)
        plain = plain_attention(q, k, v, **kw).float()
        diff = (out.float() - plain).abs()
        tol = ATTN_TOL[q.dtype]
        if not (diff <= tol + tol * plain.abs()).all():
            raise AssertionError(f"{self.label}: attention call {self.calls} "
                                 f"({kw}) differs from plain_attention by "
                                 f"{float(diff.max())}")
        self.calls += 1
        self.worst = max(self.worst, float(diff.max()))
        return out


# A teacher-forced step whose kernel logits stray past LOGITS_REL_TOL from
# the plain run's passes only within WITNESS_FACTOR of the largest distance
# between two reference runs at that step: plain_attention,
# attention_ref, the float64 attention rounded once to q's dtype, and
# WITNESS_DITHERS seeded dithers of it (each output scaled by 1 + u 2^-9,
# u uniform in [-1, 1], before the rounding: perturbations of the size of
# the rounding itself).  On hymba-1.5b, a step can amplify rounding-sized
# differences of the attention outputs to logits 0.1-0.27 apart between
# any two of these (one seed's 1,000-token request: decode step 32, where
# layer 16's mamba branch output has an RMS of 0.0021, 100x below the other
# layers', and hymba's block RMS-normalizes that branch before adding it).
WITNESS_FACTOR, WITNESS_DITHERS, DITHER = 1.5, 2, 2.0 ** -9


def float64_attention(q, k, v, **kw):
    """``attention_ref`` on q, k, v's values in float64."""
    return attention_ref(q.double(), k.double(), v.double(), **kw)


def rounded_attention(seed=None):
    """The float64 attention rounded once to q's dtype; with a ``seed``,
    each output is first scaled by 1 + u DITHER, u uniform in [-1, 1]
    drawn from a generator seeded so."""
    gen = None

    def call(q, k, v, **kw):
        nonlocal gen
        out = float64_attention(q, k, v, **kw)
        if seed is not None:
            if gen is None:
                gen = torch.Generator(device=q.device).manual_seed(seed)
            u = torch.rand(out.shape, generator=gen, device=q.device,
                           dtype=torch.float64)
            out = out * (1 + (2 * u - 1) * DITHER)
        return out.to(q.dtype)
    return call


def forced_logits(model, prompt, feed, cache_len, fe, attention) -> list:
    """The real vocabulary's logits of the prefill of ``prompt`` and of
    the decode steps fed ``feed``, through ``attention``."""
    dev = model.embed.device
    v = model.cfg.vocab_size
    logits, caches = prefill(model, torch.tensor([prompt], device=dev),
                             cache_len, frontend_embeds=fe,
                             attention=attention)
    out = [logits[0, :v]]
    for i, tok in enumerate(feed):
        logits, caches = decode_step(
            model, torch.tensor([[tok]], device=dev), caches,
            len(prompt) + i, enc_out=caches.get("enc_out"),
            attention=attention)
        out.append(logits[0, :v])
    return out


def teacher_forced(label, model, prompt, served, cache_len, steps=None,
                   fe=None) -> float:
    """The logits of a prefill and of decode steps fed the served tokens,
    through the kernel and through ``plain_attention`` (an MoE's routing
    pinned to the kernel run's: ``PinnedRouting``).  Every attention call
    of the kernel run is held to the plain attention on its own inputs
    (``CheckedAttention``).  End to end, every step's logits (the first
    token's included) must be within LOGITS_REL_TOL relative L2 of the
    plain run's or, at a step beyond it, within WITNESS_FACTOR of the
    largest distance between two reference runs there (run only when a
    step needs them).  Checks that the kernel's first token is the served
    one; returns the worst step's error."""
    feed = served[:-1] if steps is None else served[:steps]
    checked = CheckedAttention(label)
    with PinnedRouting() as pin:
        def run(attention):
            out = forced_logits(model, prompt, feed, cache_len, fe,
                                attention)
            pin.start_replay()
            return out

        kernel = run(checked)
        plain = run(plain_attention)
        flips = pin.flips
        rels = [rel_l2(a, b) for a, b in zip(kernel, plain)]
        over = [i for i, r in enumerate(rels) if r > LOGITS_REL_TOL]
        refs = [plain]
        if over:
            refs += [run(attention_ref), run(rounded_attention())] + [
                run(rounded_attention(seed))
                for seed in range(WITNESS_DITHERS)]
    witness = {i: max(rel_l2(a[i], b[i])
                      for a, b in itertools.combinations(refs, 2))
               for i in over}
    if not all(torch.isfinite(t).all() for run_ in refs + [kernel]
               for t in run_):
        raise AssertionError(f"{label}: non-finite logits")
    agree = sum(int(t.argmax()) == tok for t, tok in zip(kernel, served))
    if int(kernel[0].argmax()) != served[0]:
        raise AssertionError(f"{label}: the recomputed first token differs "
                             "from the served one")
    worst = max(rels)
    routing = f"; MoE routing pinned ({len(pin.recorded)} choices, " \
        f"{flips} rows the plain run would have routed otherwise)" \
        if pin.recorded else ""
    log(f"{label}: prompt {len(prompt)}, {len(feed)} teacher-forced decode "
        f"steps; {checked.calls} attention calls each within ATTN_TOL of "
        f"plain_attention on their inputs (max abs err {checked.worst:.3e}); "
        f"kernel vs plain_attention logits rel L2 first token "
        f"{rels[0]:.3e}, median {float(np.median(rels)):.3e}, worst "
        f"{worst:.3e}; steps over {LOGITS_REL_TOL} (step: kernel vs plain, "
        f"largest distance between the {len(refs)} reference runs): "
        f"{[(i, round(rels[i], 4), round(witness[i], 4)) for i in over]}; "
        f"kernel argmax equals the served token at {agree} of {len(kernel)} "
        f"positions{routing}")
    bad = [i for i in over if rels[i] > WITNESS_FACTOR * witness[i]]
    if bad:
        raise AssertionError(
            f"{label}: logits differ from the plain attention beyond "
            f"{LOGITS_REL_TOL} and beyond {WITNESS_FACTOR} x the references' "
            f"own spread at steps "
            f"{[(i, rels[i], witness[i]) for i in bad]}")
    return worst


def engine_report(label, cfg, engine, completions, wall_s, grew) -> None:
    n_params = sum(p.numel() for p in engine.model.parameters())
    tokens = sum(len(c.tokens) for c in completions)
    log(f"{label} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters, {cfg.dtype}): wall {wall_s:.3f} s (init "
        f"and run), run {engine.run_s:.3f} s, {tokens} tokens, "
        f"{tokens / engine.run_s:.2f} tokens/s; {engine.prefills} prefills, "
        f"{1e3 * engine.prefill_s / engine.prefills:.3f} ms each; "
        f"{engine.decodes} decode steps, "
        f"{1e3 * engine.decode_s / max(engine.decodes, 1):.3f} ms each; "
        f"launches {grew}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")


def check_completed(label, reqs, completions) -> None:
    done = {c.req_id: c for c in completions}
    if sorted(done) != sorted(r.req_id for r in reqs) or any(
            len(done[r.req_id].tokens) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{label}: a request did not complete with "
                             "its max_new_tokens")


def start_run() -> float:
    """Free the previous run's memory, zero the peak and the launch counts;
    the run's start on the host clock."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    return time.perf_counter()


def check_ring(model, prompt, cache_len) -> None:
    """After a prefill longer than the ring, layer 0's ring slot p % C
    holds position p's roped k, recomputed here from the embeddings (layer
    0's k depends on them alone), for sampled p of the last C positions,
    and not the k of position p - C, which the ring evicted."""
    cfg = model.cfg
    dev = model.embed.device
    tokens = torch.tensor([prompt], device=dev)
    s = len(prompt)
    with torch.no_grad():
        _, caches = prefill(model, tokens, cache_len)
        ck = caches["kv"][0][0, 0]                  # layer 0: (C, Hkv, hd)
        c = ck.shape[0]
        bp = model.blocks.layer(0)
        h = block_norm(embed_tokens(model, tokens), bp["norms"], 0, cfg)
        k = rope(torch.einsum("bsd,dhk->bshk", h, bp["attn"]["wk"]),
                 torch.arange(s, device=dev)[None], cfg.rope_theta)[0]
    checked = []
    for p in sorted({s - c, s - c + 1, c - 1, c, s - c // 2, s - 1}
                    & set(range(s - c, s))):
        rel = rel_l2(ck[p % c], k[p])
        other = rel_l2(ck[p % c], k[p - c]) if p >= c else None
        if rel > RING_K_TOL or (other is not None and other < RING_K_OTHER):
            raise AssertionError(f"ring: slot {p % c} vs position {p}: rel "
                                 f"{rel:.3e}, vs position {p - c}: {other}")
        checked.append((p, p % c, round(rel, 6)))
    log(f"ring check ({s}-token prefill, {c}-slot ring): (position, slot, "
        f"rel L2 vs its k) {checked}; every sampled slot holds its position "
        f"and not the evicted one")


def hymba_path(dev) -> dict:
    """hymba-1.5b at full width and depth through ``ServeEngine``, unpaged,
    both ring paths taken; launch counts, logits against the plain
    attention, the ring layout."""
    cfg = get_config(HYMBA_ARCH)
    rng = np.random.default_rng(8)
    reqs = requests(8, cfg.vocab_size, 0) + [
        Request(req_id=8 + i, max_new_tokens=n,
                prompt=rng.integers(0, cfg.vocab_size, s).tolist())
        for i, (s, n) in enumerate(HYMBA_LONG)]
    t0 = start_run()
    model = init_model(cfg, seed=0, device=dev)
    engine = ServeEngine(model, cache_len=HYMBA_CACHE_LEN)
    for r in reqs:
        engine.submit(r)
    completions = engine.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = dict(native.LAUNCHES)
    engine_report(f"serve {HYMBA_ARCH} (full, ring of "
                  f"{min(HYMBA_CACHE_LEN, cfg.sliding_window)} slots, "
                  f"{len(reqs)} requests incl. prompts {HYMBA_LONG})", cfg,
                  engine, completions, wall_s, grew)
    check_completed(HYMBA_ARCH, reqs, completions)
    check_family_launches(HYMBA_ARCH, grew, family_launches(
        cfg, engine.prefills, engine.decodes))
    log(f"{HYMBA_ARCH} prefill ms by prompt length: " + ", ".join(
        f"{len(r.prompt)}: {1e3 * c.prefill_s:.3f}"
        for r, c in zip(reqs, sorted(completions, key=lambda c: c.req_id))))
    served = {c.req_id: c.tokens for c in completions}
    for r in (reqs[0], reqs[8], reqs[9]):
        teacher_forced(f"{HYMBA_ARCH} request {r.req_id}", model, r.prompt,
                       served[r.req_id], HYMBA_CACHE_LEN)
    check_ring(model, reqs[9].prompt, HYMBA_CACHE_LEN)
    return grew


def moe_path(dev) -> dict:
    """mixtral-8x22b at full width, 12 layers, the launcher's 8 requests
    through ``ServeEngine`` with the launcher's SiM-paged cache (within its
    128-slot ring: positions stay below 28)."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    reqs = requests(8, cfg.vocab_size, 0)
    t0 = start_run()
    model = init_model(cfg, seed=0, device=dev)
    cache = SimPagedKVCache(cfg, n_pages=256, page_tokens=16, device=dev)
    engine = ServeEngine(model, cache_len=MOE_CACHE_LEN, paged_cache=cache)
    for r in reqs:
        engine.submit(r)
    completions = engine.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = dict(native.LAUNCHES)
    engine_report(f"serve {MOE_ARCH} (full width, n_layers cut 56 -> "
                  f"{MOE_LAYERS}, paged)", cfg, engine, completions, wall_s,
                  grew)
    check_completed(MOE_ARCH, reqs, completions)
    check_family_launches(MOE_ARCH, grew, family_launches(
        cfg, engine.prefills, engine.decodes))
    want = paged_recount(reqs, completions, cache.page_tokens)
    if cache.stats != want or want.pages_freed != want.pages_allocated:
        raise AssertionError(f"{MOE_ARCH}: paged counters {cache.stats}, "
                             f"recount {want}")
    log(f"{MOE_ARCH}: paged counters {cache.stats} equal the recount, every "
        "page freed")
    served = {c.req_id: c.tokens for c in completions}
    for r in reqs[:2]:
        teacher_forced(f"{MOE_ARCH} request {r.req_id}", engine.model,
                       r.prompt, served[r.req_id], MOE_CACHE_LEN)
    return grew


def direct_path(label, cfg, dev, prompt_len, steps, frontend_len) -> dict:
    """``prefill`` of one seeded prompt with seeded stub embeddings, then
    greedy decode steps, timed; then the same steps teacher-forced through
    the plain attention."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).tolist()
    t0 = start_run()
    model = init_model(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    fe = torch.randn(1, frontend_len, cfg.d_model, device=dev,
                     generator=gen).to(getattr(torch, cfg.dtype))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, caches = prefill(model, torch.tensor([prompt], device=dev),
                             prompt_len + steps, frontend_embeds=fe)
    served = [int(logits.argmax(-1)[0])]
    t2 = time.perf_counter()
    for i in range(steps):
        logits, caches = decode_step(
            model, torch.tensor([[served[-1]]], device=dev), caches,
            prompt_len + i, enc_out=caches.get("enc_out"))
        served.append(int(logits.argmax(-1)[0]))
    t3 = time.perf_counter()
    grew = dict(native.LAUNCHES)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{label} ({cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} "
        f"parameters, {cfg.dtype}): wall {t3 - t0:.3f} s (init and run); "
        f"prefill of {prompt_len} tokens with {frontend_len} stub "
        f"embeddings {1e3 * (t2 - t1):.3f} ms; {steps} decode steps "
        f"{1e3 * (t3 - t2) / steps:.3f} ms each, "
        f"{(steps + 1) / (t3 - t1):.2f} tokens/s; launches {grew}; peak "
        f"device memory {torch.cuda.max_memory_allocated()} bytes")
    check_family_launches(label, grew, family_launches(cfg, 1, steps))
    del caches
    teacher_forced(label, model, prompt, served, prompt_len + steps, fe=fe)
    return grew


def ssm_path(dev) -> dict:
    """xlstm-350m at full width through ``launch.serve.serve`` with the
    launcher's 8 requests (no attention: no launch); then, in float32,
    prefill of 15 tokens and one decode step against ``train_logits``, the
    check of tests/test_models_smoke.py."""
    cfg = get_config(SSM_ARCH)
    reqs = requests(8, cfg.vocab_size, 0)
    t0 = start_run()
    completions, engine, _ = serve(SSM_ARCH, reduced=False, verbose=False,
                                   device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    grew = dict(native.LAUNCHES)
    engine_report(f"serve {SSM_ARCH} (full)", cfg, engine, completions,
                  wall_s, grew)
    check_completed(SSM_ARCH, reqs, completions)
    check_family_launches(SSM_ARCH, grew, family_launches(cfg, 0, 0))
    del engine, completions
    start_run()
    model = init_model(dataclasses.replace(cfg, dtype="float32"), seed=0,
                       device=dev)
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 16))).to(dev)
    with torch.no_grad():
        full = train_logits(model, tokens)[0]
    lp, caches = prefill(model, tokens[:, :15], 16)
    ld = decode_step(model, tokens[:, 15:], caches, 15)[0]
    worst = 0.0
    for got, want in ((lp, full[:, 14]), (ld, full[:, 15])):
        diff = (got - want).abs()
        if not (diff <= SSM_TOL + SSM_TOL * want.abs()).all():
            raise AssertionError(f"{SSM_ARCH}: prefill/decode vs "
                                 f"train_logits: max abs err "
                                 f"{float(diff.max())}")
        worst = max(worst, float(diff.max()))
    log(f"{SSM_ARCH} float32 on the card: prefill of 15 tokens and one "
        f"decode step equal train_logits at positions 14 and 15 within "
        f"{SSM_TOL} (max abs err {worst:.3e})")
    return grew


def launcher_defaults_path() -> dict:
    """``python -m repro_torch.launch.serve --arch <arch>`` for every arch,
    as a user runs it: the reduced config on the card, the launcher's 8
    requests through the kernel, kimi-k2's shared expert included; whisper
    refused (the engine passes no frames), as the JAX engine fails."""
    total = dict.fromkeys(native.LAUNCHES, 0)
    served = []
    for arch in sorted(ARCHS):
        cfg = reduced_config(get_config(arch))
        start_run()
        if cfg.encoder_layers:
            try:
                serve(arch, verbose=False)
            except ValueError as err:
                served.append(f"{arch}: refused ({err})")
                continue
            raise AssertionError(f"{arch}: the engine served an audio "
                                 "config")
        completions, engine, _ = serve(arch, verbose=False)
        torch.cuda.synchronize()
        grew = dict(native.LAUNCHES)
        check_completed(arch, requests(8, cfg.vocab_size, 0), completions)
        check_family_launches(f"reduced {arch}", grew, family_launches(
            cfg, engine.prefills, engine.decodes))
        add_launches(total, grew)
        first = next(c for c in completions if c.req_id == 0)
        teacher_forced(f"reduced {arch} request 0", engine.model,
                       requests(1, cfg.vocab_size, 0)[0].prompt,
                       first.tokens, engine.cache_len)
        served.append(f"{arch}: {sum(len(c.tokens) for c in completions)} "
                      f"tokens, {grew['flash_attention']} launches")
    log(f"launcher defaults (reduced, on the card): {'; '.join(served)}")
    return total


def families_phase(dev) -> dict:
    t0 = time.perf_counter()
    total = dict.fromkeys(native.LAUNCHES, 0)
    vlm, audio = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    for grew in (hymba_path(dev), moe_path(dev),
                 direct_path(f"{VLM_ARCH} (full)", vlm, dev, VLM_PROMPT,
                             VLM_STEPS, vlm.frontend_tokens),
                 direct_path(f"{AUDIO_ARCH} (full)", audio, dev,
                             AUDIO_PROMPT, AUDIO_STEPS, audio.encoder_seq),
                 ssm_path(dev), launcher_defaults_path()):
        add_launches(total, grew)
    start_run()
    log(f"phase 8 (model families) took {time.perf_counter() - t0:.3f} s; "
        f"launches {total}")
    return total


# ------------------------------------ phase 9: the dry run against the card
# The check cells, each at its own shape with no mesh, as phases 6-7 run
# them: olmo-1b's training step (8 x 512, remat block) and one qwen3-4b
# decode step of the serve path (batch 1, a 128-slot cache, position 127).
CHECK_CELLS = (("olmo-1b", InputShape("check_train", "train", TRAIN_SEQ,
                                      TRAIN_BATCH)),
               (SERVE_ARCH, InputShape("check_decode", "decode",
                                       SERVE_CACHE_LEN, 1)))
CHECK_STEPS = {"train": 3, "decode": 20}     # timed steps after the counted
PEAK_TOL = 0.10
# The production cells traced on the single-pod mesh.
PRODUCTION_CELLS = (("olmo-1b", "train_4k"), ("qwen3-4b", "decode_32k"))


def check_cell(arch, shape, dev) -> dict:
    """One check cell: its step traced on meta tensors (``lower_cell``),
    then the same step built on the card with random weights and run once
    under the same counter, then timed.  The counts must be equal, the
    traced peak within PEAK_TOL of the allocator's peak (less what was
    live on the card beside the step's inputs), and the median step no
    faster than the roofline's bound."""
    cfg = get_config(arch)
    traced, report = lower_cell(cfg, shape)
    rl = analyze(traced, 1)
    start_run()
    cell = build_step(cfg, shape, device=dev)
    cell.inputs[0].reset_parameters(
        torch.Generator(device=dev).manual_seed(0))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    before = torch.cuda.memory_allocated()
    _, ran = count(cell.step, *cell.inputs, device_type="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counted = dict(native.LAUNCHES)
    if ran.key() != traced.key():
        raise AssertionError(f"{arch} {shape.mode}: the trace counts "
                             f"{traced} but the card's run {ran}")
    if ran.peak_bytes != traced.peak_bytes:
        raise AssertionError(f"{arch} {shape.mode}: traced peak "
                             f"{traced.peak_bytes}, the run's storages "
                             f"{ran.peak_bytes}")
    beside = before - ran.start_bytes
    card_peak = peak - beside
    if abs(card_peak - traced.peak_bytes) > PEAK_TOL * traced.peak_bytes:
        raise AssertionError(f"{arch} {shape.mode}: traced peak "
                             f"{traced.peak_bytes}, the allocator's "
                             f"{card_peak} ({peak} less {beside} beside)")
    want = cfg.n_layers * (2 if shape.mode == "train" else 1)
    if counted["flash_attention"] != want or sum(counted.values()) != want:
        raise AssertionError(f"{arch} {shape.mode}: launches {counted}")
    times = []
    for _ in range(CHECK_STEPS[shape.mode]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sorted(times)[len(times) // 2]
    grew = dict(native.LAUNCHES)
    if step_s < rl.bound_s:
        raise AssertionError(f"{arch} {shape.mode}: a step of {step_s} s "
                             f"beats its bound {rl.bound_s} s")
    mflops = model_flops(cfg, shape)
    log(f"dry run check {arch} {shape.mode} (B={shape.global_batch}, "
        f"S={shape.seq_len}): traced in {report['trace_s']} s on meta "
        f"tensors; trace = card run: {traced.n_ops} ops, dot FLOPs "
        f"{traced.dot_flops}, bytes accessed {traced.bytes_accessed}, result "
        f"bytes {traced.result_bytes}; peak traced {traced.peak_bytes} B, "
        f"allocator {card_peak} B ({peak} less {beside} live beside the "
        f"step's inputs; {card_peak / traced.peak_bytes - 1:+.4f}); terms "
        f"compute {rl.compute_s * 1e3:.6f} ms, memory "
        f"{rl.memory_s * 1e3:.6f} ms, bound {rl.bound_s * 1e3:.6f} ms "
        f"({rl.dominant}); median step ({len(times)}) "
        f"{step_s * 1e3:.3f} ms; launches {counted} counted, {grew} "
        f"with the timed steps")
    log(f"dry run check {arch} {shape.mode}: roofline_fraction "
        f"{rl.roofline_fraction(mflops):.6f} (model FLOPs {mflops}); MFU "
        f"{mflops / (step_s * PEAK_FLOPS):.6f}; step / bound "
        f"{step_s / rl.bound_s:.3f}")
    del cell
    return grew


def dispatch_cost(dev) -> None:
    """Host time of the attention op's dispatch: the custom op beside its
    Python body called directly, at the serve path's decode shape (a
    launch-bound call, timed on the host clock to a synchronize)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    _, dtype, shape, kw = ATTN_TIMED
    q, k, v = attn_inputs(dev, dtype, shape, 3)
    args = (q, k, v, True, None, shape[5] ** -0.5, kw["q_offset"])
    body = flash_ops.launch_kernel
    out = {}
    for label in ("op", "body", "op", "body"):
        fn = flash_ops._launch if label == "op" else body
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*args)
        torch.cuda.synchronize()
        out.setdefault(label, []).append((time.perf_counter() - t0) / 200)
    op_us, body_us = (1e6 * min(out[k]) for k in ("op", "body"))
    cfg = get_config(SERVE_ARCH)
    log(f"attention dispatch [{shape}]: the custom op {op_us:.3f} us a "
        f"call, its body alone {body_us:.3f} us (in turns, best of two); "
        f"{op_us - body_us:.3f} us more a call, "
        f"{cfg.n_layers * (op_us - body_us) / 1e3:.4f} ms a "
        f"{cfg.n_layers}-layer decode step")


def production_cells() -> None:
    """``run_cell`` of the production cells on the single-pod mesh (a fake
    world of 256 ranks, meta tensors): each must report ``ok``."""
    for arch, shape in PRODUCTION_CELLS:
        rep = run_cell(arch, shape, "single")
        if rep.get("status") != "ok":
            raise AssertionError(f"dry run {arch} {shape}: {rep}")
        rl = rep["roofline"]
        log(f"dry run {arch} {shape} single ({rep['mesh']}): dominant "
            f"{rl['dominant']}; compute {rl['compute_s']:.6f} s, memory "
            f"{rl['memory_s']:.6f} s, collective {rl['collective_s']:.6f} s; "
            f"peak {rl['peak_bytes']} B a device (fits "
            f"{rep['memory_analysis']['fits']}); roofline_fraction "
            f"{rep['roofline_fraction']:.6f}; traced in {rep['trace_s']} s")


def range_example_path() -> dict:
    """``range_query_analytics.main()`` on the card against the CPU run,
    number for number; one ``sim_plan`` and one ``sim_gather`` launch a
    select."""
    native.reset_launches()
    card = range_query_analytics.main()
    torch.cuda.synchronize()
    grew = dict(native.LAUNCHES)
    cpu = range_query_analytics.main(device="cpu")
    if card != cpu:
        raise AssertionError(f"range example: card {card}, cpu {cpu}")
    if (grew["sim_plan"], grew["sim_gather"]) != (3, 3) or \
            sum(grew.values()) != 6:
        raise AssertionError(f"range example launched {grew}")
    log(f"range_query_analytics on the card equals the CPU run; launches "
        f"{grew} (one sim_plan and one sim_gather a select)")
    return grew


def serve_example_path() -> dict:
    """``serve_lm.main()`` on the card: every request completes, and the
    completions, tokens generated and block-table searches equal the CPU
    run's."""
    native.reset_launches()
    card = serve_lm.main([])
    torch.cuda.synchronize()
    grew = dict(native.LAUNCHES)
    cpu = serve_lm.main(["--device", "cpu"])
    reqs = requests(12, reduced_config(get_config(SERVE_ARCH)).vocab_size, 0)
    check_completed("serve_lm", reqs, card["completions"])
    shape = {c.req_id: len(c.tokens) for c in card["completions"]}
    if shape != {c.req_id: len(c.tokens) for c in cpu["completions"]} or \
            (card["tokens"], card["searches"]) != (cpu["tokens"],
                                                   cpu["searches"]):
        raise AssertionError(f"serve_lm: card {card}, cpu {cpu}")
    if grew["flash_attention"] == 0:
        raise AssertionError(f"serve_lm launched {grew}")
    log(f"serve_lm on the card: {len(card['completions'])} completions, "
        f"{card['tokens']} tokens, {card['searches']} searches, equal to "
        f"the CPU run; launches {grew}")
    return grew


def roofline_phase(dev) -> dict:
    t0 = time.perf_counter()
    total = dict.fromkeys(native.LAUNCHES, 0)
    for arch, shape in CHECK_CELLS:
        add_launches(total, check_cell(arch, shape, dev))
    dispatch_cost(dev)
    production_cells()
    for grew in (range_example_path(), serve_example_path()):
        add_launches(total, grew)
    start_run()
    log(f"phase 9 (dry run against the card, examples) took "
        f"{time.perf_counter() - t0:.3f} s; launches {total}")
    return total


# ------------------------- phase 10: the tensor-parallel training step
# (a) A world of one over NCCL: olmo-1b at full width with TP_LAYERS layers
# in float32, the sharded step beside the plain one, TP_STEPS steps.
TP_LAYERS, TP_BATCH, TP_SEQ, TP_STEPS = 2, 4, 256, 2
TP_LOSS_TOL, TP_PARAM_TOL = 1e-5, 1e-4     # tests/test_distribution.py's
# (b) Rank 0 of the single-pod mesh over the fake group, on the card.
TP_CELL = ("olmo-1b", "train_4k")
TP_CELL_STEPS = 3                          # timed after the counted one


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def nccl_world_of_one_path(dev) -> dict:
    """The sharded step on a (1, 1) ``("data", "model")`` mesh over NCCL,
    whose collectives run over groups of one, against the plain step from
    the same seed: the loss within TP_LOSS_TOL and every parameter within
    TP_PARAM_TOL after TP_STEPS steps.  The launch counts are the sharded
    run's."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                               shard_model)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TP_LAYERS,
                              dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TP_SEQ,
                      global_batch=TP_BATCH, seed=0)
    step = make_train_step(cfg, opt_cfg)
    start_run()
    plain = init_model(cfg, seed=0, device=dev)
    state = init_opt_state(param_tree(plain), opt_cfg)
    losses = []
    for i in range(TP_STEPS):
        plain, state, m = step(plain, state, batch_at_step(data, i,
                                                           device=dev))
        losses.append(float(m["loss"]))
    want = {n: p.detach().clone() for n, p in plain.named_parameters()}
    del plain, state
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        model = init_model(cfg, seed=0, device=dev)
        shard_model(model, mesh, fsdp=cfg.fsdp)
        ostate = init_opt_state(param_tree(model), opt_cfg)
        tp_losses = []
        start_run()
        for i in range(TP_STEPS):
            batch = {k: distribute(v, mesh, batch_sharding(mesh))
                     for k, v in batch_at_step(data, i, device=dev).items()}
            model, ostate, m = step(model, ostate, batch)
            tp_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        grew = dict(native.LAUNCHES)
        err = max(float((p.full_tensor() - want[n]).abs().max())
                  for n, p in model.named_parameters())
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    d_loss = max(abs(a - b) for a, b in zip(tp_losses, losses))
    if d_loss >= TP_LOSS_TOL or err >= TP_PARAM_TOL:
        raise AssertionError(f"world of one: losses {tp_losses} vs plain "
                             f"{losses}, parameters {err} apart")
    n_launch = TP_STEPS * launches_per_step(cfg)
    if grew["flash_attention"] != n_launch or sum(grew.values()) != n_launch:
        raise AssertionError(f"world of one: launches {grew}")
    log(f"tensor-parallel step, a world of one over {backend} ({TRAIN_ARCH} "
        f"full width, {TP_LAYERS} layers, float32, batch {TP_BATCH} x "
        f"{TP_SEQ}, {TP_STEPS} steps): losses {tp_losses}, the plain step's "
        f"{losses} (largest difference {d_loss}); parameters at most {err} "
        f"apart (bounds {TP_LOSS_TOL}, {TP_PARAM_TOL}); launches {grew}")
    return grew


def fake_rank_path(dev, smi) -> dict:
    """Rank 0 of the single-pod (16 x 16) mesh over the ``fake`` process
    group runs TP_CELL's training step at full width and depth on its own
    shards: traced on meta tensors by ``lower_cell``, then built on the card
    and run once under the same counter (dot FLOPs, bytes, op count and
    collective bytes equal, the counter's peaks equal, the allocator's
    within PEAK_TOL), then timed.  The fake collectives move nothing and
    leave gathered buffers unfilled: the values are meaningless, and the
    step time holds no communication, so it is held to the roofline's
    compute and memory terms, not to its collective one."""
    arch, shape_name = TP_CELL
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = start_run()
    with fake_world(DRYRUN_WORLD["single"]):
        mesh = production_mesh(multi_pod=False)
        traced, report = lower_cell(cfg, shape, mesh)
        rl = analyze(traced, mesh.size())
        cell = build_step(cfg, shape, mesh, device=dev)
        model = cell.inputs[0]
        local = {n: tuple(p.to_local().shape) for n, p in
                 model.named_parameters()}
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        before = torch.cuda.memory_allocated()
        _, ran = count(cell.step, *cell.inputs, device_type="cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counted = dict(native.LAUNCHES)
        times = []
        for _ in range(TP_CELL_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cell.run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        del cell, model
    if ran.key() != traced.key():
        raise AssertionError(f"{arch} {shape_name} rank 0: the trace counts "
                             f"{traced} but the card's run {ran}")
    if ran.peak_bytes != traced.peak_bytes:
        raise AssertionError(f"{arch} {shape_name} rank 0: traced peak "
                             f"{traced.peak_bytes}, the run's storages "
                             f"{ran.peak_bytes}")
    beside = before - ran.start_bytes
    card_peak = peak - beside
    if abs(card_peak - traced.peak_bytes) > PEAK_TOL * traced.peak_bytes:
        raise AssertionError(f"{arch} {shape_name} rank 0: traced peak "
                             f"{traced.peak_bytes}, the allocator's "
                             f"{card_peak}")
    want = launches_per_step(cfg)
    if counted["flash_attention"] != want or sum(counted.values()) != want:
        raise AssertionError(f"{arch} {shape_name} rank 0: launches "
                             f"{counted}, expected {want}")
    step_s = sorted(times)[len(times) // 2]
    device_bound = max(rl.compute_s, rl.memory_s)
    if step_s < device_bound:
        raise AssertionError(f"{arch} {shape_name} rank 0: a step of "
                             f"{step_s} s beats its device bound "
                             f"{device_bound} s")
    grew = dict(native.LAUNCHES)
    h = local["blocks.attn.wq"]
    log(f"tensor-parallel step, rank 0 of {report['mesh']} over the fake "
        f"group ({arch} {shape_name} full width and depth, "
        f"{report['n_devices']} ranks): local wq {h} ({h[2]} q head), "
        f"mlp.wi_gate {local['blocks.mlp.wi_gate']}, embed "
        f"{local['embed']}; trace = card run: {traced.n_ops} ops, dot FLOPs "
        f"{traced.dot_flops}, bytes accessed {traced.bytes_accessed}, "
        f"collective bytes {traced.collective_bytes}; peak traced "
        f"{traced.peak_bytes} B, allocator {card_peak} B "
        f"({card_peak / traced.peak_bytes - 1:+.4f}; {peak} less {beside} "
        f"beside); terms compute {rl.compute_s * 1e3:.6f} ms, memory "
        f"{rl.memory_s * 1e3:.6f} ms, collective "
        f"{rl.collective_s * 1e3:.6f} ms, bound {rl.bound_s * 1e3:.6f} ms "
        f"({rl.dominant}); step ms {[round(1e3 * t, 3) for t in times]}, "
        f"median {step_s * 1e3:.3f} ms = {step_s / device_bound:.3f} x the "
        f"device bound (no communication on the card); flash_attention "
        f"launches {counted['flash_attention']} a step at H_local {h[2]}; "
        f"{time.perf_counter() - t0:.1f} s with the trace; card {smi}")
    return grew


def tp_training_phase(dev, smi) -> dict:
    t0 = time.perf_counter()
    total = dict.fromkeys(native.LAUNCHES, 0)
    for grew in (nccl_world_of_one_path(dev), fake_rank_path(dev, smi)):
        add_launches(total, grew)
    start_run()
    log(f"phase 10 (tensor-parallel training) took "
        f"{time.perf_counter() - t0:.3f} s; launches {total}")
    return total


# ---------------------------- phase 11: the sharded serve step
# (a) A world of one over NCCL: each arch at full width with SERVE_TP_LAYERS
# layers in float32, a prefill and SERVE_TP_STEPS decode steps of the
# sharded step beside the plain one (hymba on its ring: the prompt passes
# the 1,024 slots, so prefill rolls).
SERVE_TP_LAYERS, SERVE_TP_STEPS, SERVE_TP_BATCH = 2, 4, 2
SERVE_TP_RUNS = (("qwen3-4b", 64, 128), (HYMBA_ARCH, 1100, HYMBA_CACHE_LEN))
SERVE_TP_TOL = 1e-5
# (b) Rank 0 of the single-pod mesh over the fake group, on the card.
SERVE_TP_CELLS = (("qwen3-4b", "decode_32k"), (HYMBA_ARCH, "decode_32k"))
SERVE_TP_CELL_STEPS = 5                    # timed after the counted one


def _leaf_list(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaf_list(tree[k])]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaf_list(x)]
    return [tree]


def nccl_serve_world_of_one_path(dev) -> dict:
    """The sharded serve steps (``serve_prefill``, ``serve_decode_step``)
    on a (1, 1) ``("data", "model")`` mesh over NCCL, whose collectives run
    over groups of one (the cache split along its slots over an axis of
    one, decode merging its one partial softmax), against the plain
    ``prefill`` and ``decode_step`` from the same seed, fed the same
    tokens: logits and every cache leaf within SERVE_TP_TOL.  The launch
    counts are the sharded runs': ``family_launches``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                               shard_model)
    from repro_torch.serve.serve_step import (serve_decode_step,
                                              serve_prefill)
    total = dict.fromkeys(native.LAUNCHES, 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        for arch, prompt_len, cache_len in SERVE_TP_RUNS:
            cfg = dataclasses.replace(get_config(arch),
                                      n_layers=SERVE_TP_LAYERS,
                                      dtype="float32")
            rng = np.random.default_rng(11)
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (SERVE_TP_BATCH, prompt_len))).to(dev)
            fed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
                SERVE_TP_STEPS, SERVE_TP_BATCH, 1))).to(dev)
            start_run()
            plain = init_model(cfg, seed=0, device=dev)
            logits, caches = prefill(plain, prompt, cache_len)
            want = [logits]
            for i in range(SERVE_TP_STEPS):
                logits, caches = decode_step(plain, fed[i], caches,
                                             prompt_len + i)
                want.append(logits)
            want += _leaf_list(caches)
            del plain, caches
            model = init_model(cfg, seed=0, device=dev)
            shard_model(model, mesh, fsdp=cfg.fsdp)
            rows = batch_sharding(mesh)
            native.reset_launches()
            logits, caches = serve_prefill(
                model, distribute(prompt, mesh, rows), cache_len)
            got = [logits.to_local()]
            for i in range(SERVE_TP_STEPS):
                _, logits, caches = serve_decode_step(
                    model, distribute(fed[i], mesh, rows), caches,
                    prompt_len + i)
                got.append(logits.to_local())
            torch.cuda.synchronize()
            grew = dict(native.LAUNCHES)
            got += [t.to_local() for t in _leaf_list(caches)]
            errs = [float((g.double() - w.double()).abs().max())
                    for g, w in zip(got, want)]
            bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
            slots = caches["kv"][0].to_local().shape[2]
            del model, caches, got, want
            if max(errs) >= SERVE_TP_TOL:
                raise AssertionError(f"serve world of one {arch}: logits and "
                                     f"caches {errs} apart")
            check_family_launches(f"serve world of one {arch}", grew,
                                  family_launches(cfg, 1, SERVE_TP_STEPS))
            add_launches(total, grew)
            log(f"sharded serve, a world of one over {dist.get_backend()} "
                f"({arch} full width, {SERVE_TP_LAYERS} layers, float32, "
                f"batch {SERVE_TP_BATCH}, prompt {prompt_len}, cache_len "
                f"{cache_len} = {slots} slots, {SERVE_TP_STEPS} decode "
                f"steps): logits and {len(errs) - 1 - SERVE_TP_STEPS} cache "
                f"leaves at most {max(errs)} from the plain steps' (bound "
                f"{SERVE_TP_TOL}; bitwise {bitwise}); launches {grew}")
    finally:
        dist.destroy_process_group()
    return total


def fake_rank_serve_path(arch, shape_name, smi) -> dict:
    """Rank 0 of the single-pod (16 x 16) mesh over the ``fake`` process
    group runs the cell's sharded decode step at full width and depth on
    its own shards and cache slots: traced on meta tensors by
    ``lower_cell``, then built on the card and run once under the same
    counter (every count equal, the counter's peaks equal, the allocator's
    within PEAK_TOL), then timed against the roofline's compute and memory
    terms (the fake collectives move nothing and leave gathered buffers
    unfilled: values are not checked)."""
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = start_run()
    with fake_world(DRYRUN_WORLD["single"]):
        mesh = production_mesh(multi_pod=False)
        traced, report = lower_cell(cfg, shape, mesh)
        rl = analyze(traced, mesh.size())
        cell = build_step(cfg, shape, mesh, device=dev)
        caches = cell.inputs[1]
        kv = tuple(caches["kv"][0].to_local().shape)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        before = torch.cuda.memory_allocated()
        _, ran = count(cell.step, *cell.inputs, device_type="cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counted = dict(native.LAUNCHES)
        times = []
        for _ in range(SERVE_TP_CELL_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cell.run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        del cell, caches
    label = f"{arch} {shape_name} rank 0"
    if ran.key() != traced.key():
        raise AssertionError(f"{label}: the trace counts {traced} but the "
                             f"card's run {ran}")
    if ran.peak_bytes != traced.peak_bytes:
        raise AssertionError(f"{label}: traced peak {traced.peak_bytes}, "
                             f"the run's storages {ran.peak_bytes}")
    beside = before - ran.start_bytes
    card_peak = peak - beside
    if abs(card_peak - traced.peak_bytes) > PEAK_TOL * traced.peak_bytes:
        raise AssertionError(f"{label}: traced peak {traced.peak_bytes}, "
                             f"the allocator's {card_peak}")
    check_family_launches(label, counted, family_launches(cfg, 0, 1))
    step_s = sorted(times)[len(times) // 2]
    device_bound = max(rl.compute_s, rl.memory_s)
    if step_s < device_bound:
        raise AssertionError(f"{label}: a step of {step_s} s beats its "
                             f"device bound {device_bound} s")
    grew = dict(native.LAUNCHES)
    log(f"sharded serve, {label} of {report['mesh']} over the fake group "
        f"(full width and depth, {report['n_devices']} ranks): local k cache "
        f"{kv}; trace = card run: {traced.n_ops} ops, dot FLOPs "
        f"{traced.dot_flops}, bytes accessed {traced.bytes_accessed}, "
        f"collective bytes {traced.collective_bytes}; peak traced "
        f"{traced.peak_bytes} B, allocator {card_peak} B "
        f"({card_peak / traced.peak_bytes - 1:+.4f}; {peak} less {beside} "
        f"beside); terms compute {rl.compute_s * 1e3:.6f} ms, memory "
        f"{rl.memory_s * 1e3:.6f} ms, collective "
        f"{rl.collective_s * 1e3:.6f} ms, bound {rl.bound_s * 1e3:.6f} ms "
        f"({rl.dominant}); step ms {[round(1e3 * t, 3) for t in times]}, "
        f"median {step_s * 1e3:.3f} ms = {step_s / device_bound:.3f} x the "
        f"device bound (no communication on the card); flash_attention "
        f"launches {counted['flash_attention']} a step; "
        f"{time.perf_counter() - t0:.1f} s with the trace; card {smi}")
    return grew


def tp_serve_phase(dev, smi) -> dict:
    t0 = time.perf_counter()
    total = dict.fromkeys(native.LAUNCHES, 0)
    add_launches(total, nccl_serve_world_of_one_path(dev))
    for arch, shape_name in SERVE_TP_CELLS:
        add_launches(total, fake_rank_serve_path(arch, shape_name, smi))
    start_run()
    log(f"phase 11 (the sharded serve step) took "
        f"{time.perf_counter() - t0:.3f} s; launches {total}")
    return total


# ---------------------- phase 12: the compressed step on a pod mesh
# A world of one over NCCL on a (1, 1, 1) ("pod", "data", "model") mesh:
# olmo-1b at full width with TP_LAYERS layers in float32, fsdp off,
# POD_STEPS compressed steps beside the stacked form with one pod, from
# the same seed and batches; bitwise equal.
POD_STEPS = 3
POD_OPT = dict(lr=5e-3, warmup_steps=1)     # tests/test_distribution.py's
POD_STAGE_RUNS = 5


def pod_stage_bound(model) -> tuple:
    """(parameters, the cross-pod stage's memory bound in ms): each
    parameter's float32 gradient and residual read once, its new residual
    and mean written once, 16 B a parameter at the HBM rate."""
    n = sum(p.numel() for p in model.parameters())
    return n, 16 * n / HBM_BW * 1e3


def pod_compression_path(dev, smi) -> dict:
    """The compressed step on a pod mesh of one (its pod, scale and data
    all-reduces run over groups of one) against the stacked form with one
    pod: losses, every parameter and every residual leaf equal bit for
    bit; one ``flash_attention`` launch a layer a step (remat's recompute
    too) and nothing else.  Then the cross-pod stage alone
    (``compress_over_pods`` on one step's gradients: the scale's MAX
    all-reduce, the quantize, the residual, the all-reduce of the
    dequantized payload, over every leaf), the median of POD_STAGE_RUNS
    runs by CUDA events, beside its memory bound."""
    import torch.distributed as dist
    from repro_torch.convert import tree_items
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.compression import compress_over_pods
    from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                               shard_model)
    from repro_torch.train.train_step import _sharded_grads
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TP_LAYERS,
                              dtype="float32", fsdp=False)
    opt_cfg = AdamWConfig(**POD_OPT)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TP_SEQ,
                      global_batch=TP_BATCH, seed=0)
    start_run()
    stacked = init_model(cfg, seed=0, device=dev)
    state = init_opt_state(param_tree(stacked), opt_cfg)
    err = init_error_state(param_tree(stacked), 1)
    step = make_compressed_train_step(cfg, opt_cfg)
    losses = []
    for i in range(POD_STEPS):
        stacked, state, err, m = step(stacked, state, err,
                                      batch_at_step(data, i, device=dev))
        losses.append(float(m["loss"]))
    want = {n: p.detach() for n, p in stacked.named_parameters()}
    want.update({"residual " + ".".join(k): e for k, e in tree_items(err)})
    n_params, bound_ms = pod_stage_bound(stacked)
    del stacked, state, err
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
        model = init_model(cfg, seed=0, device=dev)
        shard_model(model, mesh, fsdp=False)
        ostate = init_opt_state(param_tree(model), opt_cfg)
        perr = init_error_state(param_tree(model), 1, mesh)
        pstep = make_compressed_train_step(cfg, opt_cfg, mesh)
        pod_losses = []
        start_run()
        for i in range(POD_STEPS):
            batch = {k: distribute(v, mesh, batch_sharding(mesh))
                     for k, v in batch_at_step(data, i, device=dev).items()}
            model, ostate, perr, m = pstep(model, ostate, perr, batch)
            pod_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        grew = dict(native.LAUNCHES)
        got = {n: p.full_tensor() for n, p in model.named_parameters()}
        got.update({"residual " + ".".join(k): e.full_tensor()
                    for k, e in tree_items(perr)})
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        worst = max((float((got[k] - want[k]).abs().max()) for k in differ),
                    default=0.0)
        # the stage alone, on the last batch's gradients
        _, grads = _sharded_grads(model, batch, mesh, 1, flash_attention,
                                  mean_axes=("data",))
        grads = nest(grads)
        compress_over_pods(grads, perr, mesh)
        times = []
        for _ in range(POD_STAGE_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            compress_over_pods(grads, perr, mesh)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    if pod_losses != losses or differ:
        raise AssertionError(
            f"pod mesh of one: losses {pod_losses} vs the stacked form's "
            f"{losses}; {len(differ)} leaves differ, the first {differ[:1]}, "
            f"at most {worst}")
    n_launch = POD_STEPS * launches_per_step(cfg)
    if grew["flash_attention"] != n_launch or sum(grew.values()) != n_launch:
        raise AssertionError(f"pod mesh of one: launches {grew}, expected "
                             f"{n_launch} flash_attention")
    stage_ms = float(np.median(times))
    log(f"compressed step on a pod mesh of one over {backend} ({TRAIN_ARCH} "
        f"full width, {TP_LAYERS} layers, float32, fsdp off, batch "
        f"{TP_BATCH} x {TP_SEQ}, {POD_STEPS} steps): losses {pod_losses}, "
        f"bitwise the stacked form's with one pod (every parameter and "
        f"residual leaf); launches {grew}")
    log(f"cross-pod stage alone ({n_params:,} parameters, {len(want) // 2} "
        f"leaves): median {stage_ms:.6f} ms of {POD_STAGE_RUNS} runs "
        f"{[round(t, 6) for t in times]}, memory bound {bound_ms:.6f} ms "
        f"(16 B a parameter at {HBM_BW / 1e12} TB/s), "
        f"{stage_ms / bound_ms:.2f}x; {smi}")
    return grew


def pod_compression_phase(dev, smi) -> dict:
    t0 = time.perf_counter()
    grew = pod_compression_path(dev, smi)
    start_run()
    log(f"phase 12 (the compressed step on a pod mesh) took "
        f"{time.perf_counter() - t0:.3f} s; launches {grew}")
    return grew


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--key-pages", type=int, default=16_384)
    ap.add_argument("--n-ops", type=int, default=20_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. Device and build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    log(f"kernels built in {time.perf_counter() - t0:.3f} s -> {lib.name}")

    # 2. Kernel checks (these launches are not the main paths').
    rows = kernel_checks(dev)
    attention_lse_checks(dev)

    # 3.-12. The main paths.
    launches, reports = main_path(args.key_pages, args.n_ops)
    for grew in (sharded_path(args.key_pages, args.n_ops, reports),
                 reliability_phase(args.key_pages, args.n_ops),
                 fault_phase(args.key_pages, args.n_ops),
                 auditor_phase(args.key_pages, args.n_ops),
                 index_phase(args.key_pages), quickstart_path(),
                 serve_path(dev), reduced_serve_path(dev),
                 training_phase(dev, smi), families_phase(dev),
                 roofline_phase(dev), tp_training_phase(dev, smi),
                 tp_serve_phase(dev, smi), pod_compression_phase(dev, smi)):
        for k in launches:
            launches[k] += grew[k]
    for k in KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k} never launched on the main paths")

    # 13. Kernels line.
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
         **({"lengths": r["lengths"]} if "lengths" in r else {})}
        for k, r in rows.items()]}), flush=True)
    # 14. The card, then the result.
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
