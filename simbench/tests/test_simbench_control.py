"""The comparison fails what it must: the control (the reference with one
guarantee broken, in the program's place) on three seeds, and a run with
the timed path broken underneath, once for each fault the cell can have."""
import contextlib

import numpy as np
import pytest

from simbench import control, runner
from simbench.tests.sizes import CELLS, TINY, run

BENCH = runner.load_benchmark()


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**33 + 1])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell, seed):
    runs = control.control_runs(BENCH, cell, seed, 3000, TINY[cell])
    assert "lost_writes" in runs
    assert ("first_page_scans" in runs) == cell.endswith("ycsb-e")
    for name, (correct, numbers) in runs.items():
        assert not correct, (name, numbers)
        assert any(v > lim for v, lim in numbers.values())


@pytest.mark.parametrize("seed", [2, 2**32 + 7])
def test_the_scan_control_fails_the_scans_alone(seed):
    runs = control.control_runs(BENCH, "kv16k.ycsb-e", seed, 3000,
                                TINY["kv16k.ycsb-e"])
    _, numbers = runs["first_page_scans"]
    assert numbers["scan_mismatches"][0] > 0
    assert numbers.get("read_mismatches", (0, 0))[0] == 0
    assert numbers["readback_mismatches"][0] == 0


def _wrap(monkeypatch, module, name, after):
    """Replace ``module.name`` and every alias of it in the port by a
    version whose outputs ``after`` alters."""
    import sys
    orig = getattr(module, name)

    def broken(*args, **kw):
        return after(orig(*args, **kw))
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").split(".")[0] == "repro_torch"
                and getattr(mod, name, None) is orig):
            monkeypatch.setattr(mod, name, broken)


def _lookup_half(out):
    bm, val, slots = out
    slots[1::2] = 512                       # every other row left out
    return bm, val, slots


def _lookup_altered(out):
    bm, val, slots = out
    val[:, 0] ^= 1                          # the value chunk's first word
    return bm, val, slots


def _plan_half(out):
    out[..., 1::2, :] = 0                   # every other page left out
    return out


def _plan_altered(out):
    out[..., 0, 1] ^= 1 << 5                # one bit of the first page's map
    return out


@contextlib.contextmanager
def _fault(monkeypatch, kind, cell):
    from repro_torch.kernels.sim_fused import ops as lookup
    from repro_torch.kernels.sim_plan import ops as plan
    scans = cell.endswith("ycsb-e")
    if kind == "state_unchanged":
        from repro_torch.frontend.replay import ReplayCore

        def lost_write(self, qi):           # acknowledged, never programmed
            self.resolve_burst()
            self.n_writes += 1
            return "program", []
        monkeypatch.setattr(ReplayCore, "write", lost_write)
    elif kind == "half_batch":
        if scans:
            _wrap(monkeypatch, plan, "sim_plan", _plan_half)
        else:
            _wrap(monkeypatch, lookup, "sim_fused_lookup", _lookup_half)
    elif scans:
        _wrap(monkeypatch, plan, "sim_plan", _plan_altered)
    else:
        _wrap(monkeypatch, lookup, "sim_fused_lookup", _lookup_altered)
    yield


# The cells run on one card and exchange nothing between cards, so the
# fault "the exchange between chips left out" has no place to be planted.
@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, cell, kind):
    with _fault(monkeypatch, kind, cell):
        line, numbers = run(cell, seconds=0.8)
    assert not line["correct"], line
    assert line["failed"] > 0 or any(v > lim for v, lim in numbers.values())
    assert np.isfinite(line["attempted"])
