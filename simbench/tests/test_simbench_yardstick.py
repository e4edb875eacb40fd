"""The frozen yardstick against the program's originals as they stand."""
import numpy as np
import pytest
import torch

from simbench import runner
from simbench.yardstick import bounds, traffic, ycsb

MIXES = [dict(read_ratio=0.95), dict(read_ratio=0.5),
         dict(read_ratio=0.0, scan_ratio=0.95, max_scan_len=100)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
@pytest.mark.parametrize("mix", MIXES, ids=["b", "a", "e"])
def test_frozen_generator_equals_the_program_s(seed, mix):
    from repro_torch.workload import ycsb as program
    want = program.generate(3000, n_key_pages=40, alpha=0.99, seed=seed,
                            **mix)
    got = ycsb.generate(3000, n_key_pages=40, alpha=0.99, seed=seed, **mix)
    for name in ("ops", "keys", "key_pages", "value_pages", "scan_lens"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None)
        if w is not None:
            assert w.dtype == g.dtype and np.array_equal(w, g), name
    assert np.array_equal(ycsb.zipf_probs(1000, 0.99),
                          program.zipf_probs(1000, 0.99))


def _smoke():
    return pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("n_rows", [8, 64])
def test_frozen_lookup_bound_equals_the_smoke_s(n_rows):
    smoke = _smoke()
    slots = torch.tensor([3, 512, 100, 511, 512, 7, 0, 9] * (n_rows // 8),
                         dtype=torch.int32)
    for in_place in (False, True):
        assert bounds.lookup_bound(n_rows, slots.numpy().view(np.uint32),
                                   in_place) == smoke.lookup_bound(
                                       n_rows, slots, in_place)


@pytest.mark.parametrize("n_rows", [32, 64])
def test_frozen_gather_bound_equals_the_smoke_s(n_rows):
    smoke = _smoke()
    rng = np.random.default_rng(n_rows)
    bm = rng.integers(0, 2**32, (n_rows, 2), dtype=np.uint64).astype(
        np.uint32)
    bm[::3] = 0
    t = torch.from_numpy(bm.view(np.int32))
    for max_out in (16, 64):
        for in_place in (False, True):
            assert bounds.gather_bound(bm, max_out, in_place) == \
                smoke.gather_bound(t, max_out, in_place)


@pytest.mark.parametrize("shape", [(1, 16, 32), (2, 128, 64)])
def test_frozen_plan_bound_equals_the_smoke_s(shape):
    smoke = _smoke()
    g, p, n = shape
    f = np.zeros((g, p), np.uint32)
    f[:, : p // 2] = 1
    f[0, 1] = 2
    t = torch.from_numpy(f.view(np.int32))
    assert bounds.plan_bound(f, n) == smoke.plan_bound(t, n)
    ops, nbytes = bounds.plan_bound(f, n)
    assert bounds.bound(ops, nbytes) == smoke.bound(ops, nbytes)


def test_frozen_peaks_equal_the_program_s():
    from repro_torch.launch import roofline
    assert bounds.HBM_BW == roofline.HBM_BW
    assert bounds.INT32_OPS == roofline.INT32_OPS == 132 * 64 * 1.98e9


def test_a_mix_s_kind_is_found_by_name():
    from simbench.yardstick.kinds import ycsb as kind
    bench = runner.load_benchmark()
    _, config, mix = runner.cell_inputs(
        bench, "kv16k.ycsb-b", {"config": {"n_key_pages": 8},
                                "traffic": {"stream_ops": 500}})
    a, b = traffic.make(config, mix, 5), kind.make(config, mix, 5)
    assert np.array_equal(a.keys, b.keys) and np.array_equal(a.ops, b.ops)


@pytest.mark.parametrize("kind", ["no_such_kind", "../ycsb", "ycsb.x"])
def test_an_unknown_kind_is_refused(kind):
    with pytest.raises(ValueError):
        traffic.make({}, {"kind": kind}, 1)
