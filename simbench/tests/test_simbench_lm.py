"""The ``lm`` cell (hymba-1.5b-base.chat-long) end to end at a tiny size on
the CPU, against its reference; its traffic's draw; its roofline's frozen
bound; and the check failing what it must fail."""
import json
import time

import pytest
import torch

from simbench import runner
from simbench.reference import lm as reference
from simbench.yardstick import bounds
from simbench.yardstick import traffic as traffic_gen

CELL = "hymba-1.5b-base.chat-long"
BENCH = runner.load_benchmark()
# Every kind of layer of the published structure, in float32: global
# layers 0 and 4, layers 1-2 sharing a cache, 8 meta tokens, a window of 8
# that the long sessions' 24-token context passes.
TINY = {"config": {"n_layers": 5, "d_model": 64, "n_heads": 4,
                   "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                   "vocab_size": 256, "ssm_state": 4, "sliding_window": 8,
                   "global_layers": [0, 4], "meta_tokens": 8,
                   "kv_groups": [[1, 2]], "dtype": "float32",
                   "cache_len": 128, "kv_pages": 256},
        "traffic": {"long_context": 24, "long_new_tokens": 96,
                    "short_prompt_min": 4, "short_prompt_max": 20,
                    "short_answer_min": 2, "short_answer_max": 6,
                    "short_requests": 64, "warmup_prompt": 6,
                    "warmup_answer": 3}}
SEED = 2**31 + 9
SERVE_METRICS = {"client.ops_per_s", "backend.host_us_per_op",
                 "serve.admit_share", "model.mamba_us_per_token",
                 "serve.table_us_per_token"}
CHECKS = {"logit_sequences_beyond", "logit_steps_beyond",
          "logit_rel_l2_median", "kv_positions_off", "kv_pages_off",
          "kv_pages_unaccounted"}


def run(seconds=0.6, trace=False):
    return runner.run_cell(BENCH, CELL, SEED, seconds, trace,
                           torch.device("cpu"), started=time.perf_counter(),
                           overrides=TINY)


def test_untraced_run_is_correct_and_reports_its_end_to_end_metrics():
    line, numbers = run()
    assert line["correct"], line
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"op_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert {k: (v["value"], v["limit"]) for k, v in
            line["checks"].items()} == numbers
    assert set(numbers) == CHECKS
    assert all(numbers[k] == (0, 0) for k in CHECKS - {"logit_rel_l2_median"})
    assert numbers["logit_rel_l2_median"][0] < 1e-4     # float32
    json.dumps(line)


def test_traced_run_reads_the_program_s_serve_spans():
    line, _ = run(seconds=1.2, trace=True)
    assert line["correct"], line
    assert set(line["metrics"]) == SERVE_METRICS
    assert 0 <= line["metrics"].pop("serve.admit_share")["value"] < 1
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["window_s"] > 0


class Steps:
    """A window of a fixed number of engine steps, untimed: the system's
    ``window`` reads ``tracer``, ``open``, ``tick`` and ``close``."""
    tracer = None

    def __init__(self, steps: int):
        self.steps = steps

    def open(self):
        pass

    def tick(self, done: int) -> bool:
        self.steps -= 1
        return self.steps >= 0

    def close(self, done: int):
        pass


def test_global_layers_on_the_ring_are_refused(monkeypatch):
    """Today's paper-table layout put in the program's place: the check
    fails the long sessions, whose context has passed the ring."""
    from repro_torch.models import hymba
    from simbench.systems import lm
    monkeypatch.setattr(hymba, "RING_KINDS", ("window", "global"))
    config, inputs = _inputs(SEED)
    sut = lm.System(config, inputs, torch.device("cpu"))
    sut.warm_up()
    sut.window(Steps(reference.MIN_STEPS + 2))
    numbers, failed, _ = reference.check(config, inputs, *sut.results())
    assert numbers["logit_sequences_beyond"][0] >= 2 and failed > 0


def _inputs(seed):
    _, config, mix = runner.cell_inputs(BENCH, CELL, TINY)
    return config, traffic_gen.make(config, mix, seed)


def test_a_seed_gives_the_same_traffic_and_weights():
    _, a = _inputs(2**31 + 77)
    _, b = _inputs(2**31 + 77)
    _, c = _inputs(2**31 + 78)
    assert a.long_prompts == b.long_prompts != c.long_prompts
    assert a.short == b.short != c.short
    assert torch.equal(a.weights["layers"][3]["in_proj"],
                       b.weights["layers"][3]["in_proj"])
    assert not torch.equal(a.weights["embed"], c.weights["embed"])
    # a layer that reads its group's cache has no k/v projection
    assert "wk" not in a.weights["layers"][2] and "wk" in a.weights[
        "layers"][1]
    lengths = [len(p) for p, _ in a.short]
    assert min(lengths) >= 4 and max(lengths) <= 20


def test_lower_precision_than_the_configuration_s_fails_the_check():
    """The reference computed with float8 products in the program's place:
    its steps stray far beyond the references' spread (the median's limit
    is set for the cell's full size, where float8 reads above it)."""
    config, inputs = _inputs(SEED)
    config = dict(config, dtype="float32")
    gen = torch.Generator().manual_seed(1)
    seqs, logits = [], []
    for s in (9, 30):
        prompt = torch.randint(0, 256, (s,), generator=gen).tolist()
        served = torch.randint(0, 256, (5,), generator=gen).tolist()
        seqs.append({"prompt": prompt, "served": served, "window_from": 0})
        logits.append(reference.forward(config, inputs.weights,
                                        prompt + served[:-1], 5,
                                        products=reference._float8))
    numbers, failed, _ = reference.check(
        config, inputs, {"sequences": seqs},
        {"logits": logits, "kv": [None, None],
         "pages_free": config["kv_pages"]})
    assert numbers["logit_sequences_beyond"] == (1, 0) and failed == 10
    assert numbers["logit_steps_beyond"][0] > 0


def test_the_float8_rounding_is_e4m3_s():
    f8 = getattr(torch, "float8_e4m3fn")
    x = torch.randn(20000, generator=torch.Generator().manual_seed(4)) * 30
    x = torch.cat([x, torch.tensor([0.0, 1e-4, -3e-3, 447.9, 500.0])])
    want = x.clamp(-448, 448).to(f8).float()
    assert torch.equal(reference._float8(x), want)


CONTROL_NUMBERS = {
    "float8_products": {"logit_sequences_beyond", "logit_steps_beyond"},
    "global_ring": {"logit_sequences_beyond", "logit_steps_beyond",
                    "kv_pages_off"},
    "unwritten_decodes": {"kv_positions_off"},
    "unfreed_pages": {"kv_pages_unaccounted"}}


@pytest.mark.parametrize("seed", [2**33 + 1])
def test_every_control_comes_out_not_correct(seed):
    """Each control (``simbench/control.py``), the reference in the
    program's place with one guarantee broken, fails the check on the
    numbers that read that guarantee."""
    from simbench import control
    runs = control.control_runs(BENCH, CELL, seed, 60, TINY)
    assert set(runs) == set(CONTROL_NUMBERS)
    for name, (correct, numbers) in runs.items():
        assert not correct, (name, numbers)
        beyond = {k for k, (v, lim) in numbers.items() if v > lim}
        assert CONTROL_NUMBERS[name] <= beyond, (name, numbers)
        if name in ("unwritten_decodes", "unfreed_pages"):
            assert beyond == CONTROL_NUMBERS[name], (name, numbers)


def test_the_roofline_reads_the_attention_kernel_s_launches():
    specs = runner.kernel_specs(BENCH, CELL)
    assert [k.name for k in specs] == ["flash_attention"]
    spec = specs[0]
    from repro_torch.kernels.flash_attention import ops
    assert getattr(ops, spec.wrapper) is ops._run
    q = torch.zeros(1, 3, 25, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 200, 5, 64, dtype=torch.bfloat16)
    rec = spec.record(0, (q, k, k, True, 1024, 0.125, 197, None), {}, None)
    assert rec == (2, (1, 3, 200, 25, 5, 64), True, 1024, 197, False)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", [
    ((1, 1, 8320, 25, 5, 64), dict(causal=True, q_offset=6400), False),
    ((1, 600, 600, 25, 5, 64), dict(causal=True, window=1024, q_offset=0),
     True),
    ((1, 600, 128, 25, 5, 64), dict(causal=False), True),
    ((1, 1, 1152, 25, 5, 64), dict(causal=True, q_offset=1151), False)])
def test_frozen_attention_bound_equals_the_smoke_s(case, dtype):
    smoke = pytest.importorskip("chip_smoke")
    reader = runner.metric_module("flash_attention_roofline")
    shape, kw, lse = case
    dt = getattr(torch, dtype)
    rec = (dt.itemsize, shape, kw["causal"], kw.get("window"),
           kw.get("q_offset", shape[2] - shape[1]), lse)
    want, _ = smoke.attn_bound(dt, shape, kw, lse)
    got, _ = bounds.bound(*reader.KERNEL.bound(rec))
    assert got == pytest.approx(want, rel=1e-12)
