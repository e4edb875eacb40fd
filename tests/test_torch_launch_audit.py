"""The port's launch auditor (repro_torch.analysis.launch_audit) on the CPU:
the recorder, the clean audits, phase-for-phase parity with the JAX
auditor's scenario, and each gate tripping on a doctored entry point."""
import pytest
import torch

import repro_torch.backend.batched as batched_mod
import repro_torch.backend.sharded as sharded_mod
import repro_torch.kernels.sim_search.ops as search_ops
from repro_torch.kernels import native
from repro.analysis import launch_audit as jax_audit
from repro_torch.analysis.launch_audit import (SYNC_METHODS, _Auditor,
                                               audit_backend,
                                               record_launches, summarize)

KINDS = ("batched", "sharded")
SEARCH_ENTRY = {"batched": "sim_search", "sharded": "sim_search_chips"}
# The JAX sharded backend's jitted vmaps are the port's chip-axis wrappers.
JAX_ENTRY = {"_stacked_search": "sim_search_chips",
             "_stacked_plan": "sim_plan_chips"}


def _search_module(kind):
    return batched_mod if kind == "batched" else sharded_mod


# -------------------------------------------------------------- the recorder
def test_summary_bytes_and_signature():
    params = {"lo": torch.zeros((64, 512), dtype=torch.int32),
              "queries": torch.zeros((4, 2), dtype=torch.int32),
              "rows": torch.zeros((32,), dtype=torch.int32),
              "randomized": True}
    out = (torch.zeros((4, 32, 16), dtype=torch.int32),
           torch.zeros((4,), dtype=torch.int64))
    s = summarize(params, out)
    assert s.in_bytes == 4 * (64 * 512 + 8 + 32)
    assert s.out_bytes == 4 * 4 * 32 * 16 + 8 * 4
    # the arena plane is residency, not part of the launch signature
    assert s.signature == (("queries", (4, 2), "torch.int32"),
                           ("rows", (32,), "torch.int32"))
    assert s.shape_of("lo") == (64, 512) and s.shape_of("masks") is None


@pytest.mark.parametrize("kind", KINDS)
def test_recorder_restores_entry_points(kind):
    entry = SEARCH_ENTRY[kind]
    mod = _search_module(kind)
    saved = (getattr(mod, entry), batched_mod.sim_gather,
             search_ops.sim_search_ref, search_ops.sim_search_chips_ref)
    with record_launches(kind) as records:
        assert getattr(mod, entry) is not saved[0]
        assert batched_mod.sim_gather is not saved[1]
    assert (getattr(mod, entry), batched_mod.sim_gather,
            search_ops.sim_search_ref,
            search_ops.sim_search_chips_ref) == saved
    assert records == []
    assert not any(n in torch.Tensor.__dict__ for n in SYNC_METHODS)


def test_unknown_backend_kind_rejected():
    with pytest.raises(KeyError):
        with record_launches("scalar"):
            pass
    with pytest.raises(KeyError):
        audit_backend("scalar", device="cpu")


# ----------------------------------------------------------- the full audits
@pytest.mark.parametrize("kind", KINDS)
def test_audit_is_clean(kind):
    findings = audit_backend(kind, device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("kind", KINDS)
def test_phases_equal_the_jax_auditors_scenario(kind):
    """Phase for phase: the recorded entries and the staged_bytes,
    result_bytes and kernel_launches deltas equal the JAX auditor's over
    the same scenario (its backends on their plain jnp paths)."""

    class Logged(jax_audit._Auditor):
        def run_phase(self, records, phase, submit, **kw):
            st = self.backend.stats
            s0 = (st.staged_bytes, st.result_bytes, st.kernel_launches)
            recs = super().run_phase(records, phase, submit, **kw)
            self.log.append((phase, [JAX_ENTRY.get(r.entry, r.entry)
                                     for r in recs],
                             st.staged_bytes - s0[0],
                             st.result_bytes - s0[1],
                             st.kernel_launches - s0[2]))
            return recs

    ref = Logged(kind, use_kernel=False, hlo=False)
    ref.log = []
    with jax_audit.record_launches(kind) as records:
        ref._scenario(records)

    aud = _Auditor(kind, device="cpu")
    aud.run()
    got = [(p.phase, p.entries, p.staged_bytes, p.result_bytes,
            p.kernel_launches) for p in aud.phases]
    assert got == ref.log
    assert [p.phase for p in aud.phases] == [
        "search-cold", "search-warm", "plan", "lookup", "gather",
        "program-group", "search-after-program"]


# ------------------------------------------------------------- gate tripping
@pytest.mark.parametrize("kind", KINDS)
def test_second_launch_trips_sim101(kind, monkeypatch):
    """Doctor the search entry to run its kernel twice: every search phase
    is flagged (value-identical, so only the launch count differs)."""
    entry = SEARCH_ENTRY[kind]
    mod = _search_module(kind)
    orig = getattr(mod, entry)

    def doubled(*args, **kwargs):
        first = orig(*args, **kwargs)
        orig(*args, **kwargs)
        return first

    monkeypatch.setattr(mod, entry, doubled)
    findings = audit_backend(kind, device="cpu")
    bad = [f for f in findings
           if f.rule == "SIM101" and f.slug == f"kernel-count:{entry}"]
    assert {f.symbol for f in bad} >= {"search-cold", "search-warm"}
    assert {f.rule for f in findings} == {"SIM101"}


def test_second_entry_call_trips_launch_count(monkeypatch):
    """A flush that launches the gather twice breaks one-launch-a-phase,
    though its ``kernel_launches`` counter says one."""
    orig = batched_mod.launch_gathers

    def twice(be, gathers, *args, **kwargs):
        orig(be, gathers[:1], *args, **kwargs)
        return orig(be, gathers[1:], *args, **kwargs)

    monkeypatch.setattr(batched_mod, "launch_gathers", twice)
    findings = audit_backend("batched", device="cpu")
    assert {(f.rule, f.symbol, f.slug) for f in findings} == {
        ("SIM101", "gather", "launch-count")}


@pytest.mark.parametrize("kind", KINDS)
def test_launch_outside_an_entry_trips_sim101(kind, monkeypatch):
    """A gather flush that launches a kernel besides its recorded entry
    (as a card launch would show in ``native.LAUNCHES``) is flagged."""
    monkeypatch.setitem(native.LAUNCHES, "sim_plan",
                        native.LAUNCHES["sim_plan"])
    cls = batched_mod.BatchedKernelBackend if kind == "batched" \
        else sharded_mod.ShardedSsdBackend
    orig = cls._flush_gathers

    def stray(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        native.LAUNCHES["sim_plan"] += 1
        return out

    monkeypatch.setattr(cls, "_flush_gathers", stray)
    findings = audit_backend(kind, device="cpu")
    assert [(f.rule, f.symbol, f.slug) for f in findings] == [
        ("SIM101", "gather", "launches-outside-entry")]


@pytest.mark.parametrize("sync", ["item", "tolist", "cpu", "numpy",
                                  "synchronize"])
def test_host_sync_in_gather_trips_sim102(sync, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    orig = batched_mod.sim_gather

    def with_sync(*args, **kwargs):
        out, counts = orig(*args, **kwargs)
        if sync == "synchronize":
            torch.cuda.synchronize()
        else:
            getattr(counts.sum() if sync == "item" else counts, sync)()
        return out, counts

    monkeypatch.setattr(batched_mod, "sim_gather", with_sync)
    findings = audit_backend("sharded", device="cpu")
    assert [(f.rule, f.symbol, f.slug) for f in findings] == [
        ("SIM102", "gather", "host-sync:sim_gather")]
    assert sync in findings[0].message


def test_unpadded_queries_trip_sim103(monkeypatch):
    """Without the pow2 padding of the query rows every burst size is a
    launch shape of its own."""
    monkeypatch.setattr(batched_mod, "next_pow2", lambda n: max(n, 1))
    findings = audit_backend("batched", device="cpu")
    assert ("SIM103", "retrace-sweep", "distinct-signatures") in \
        {(f.rule, f.symbol, f.slug) for f in findings}


def test_unpadded_rows_trip_sim104(monkeypatch):
    """Unpadded page rows: the rows operand and the plan's copied planes
    no longer have padded_rows(unique pages, PAGE_BLOCK) rows."""
    monkeypatch.setattr(batched_mod, "padded_rows", lambda n, block: n)
    findings = audit_backend("batched", device="cpu")
    got = {(f.rule, f.symbol, f.slug) for f in findings}
    assert ("SIM104", "search-cold", "rows-operand:sim_search") in got
    assert ("SIM104", "plan", "plane-rows:sim_plan") in got


def test_miscounted_bytes_trip_sim104(monkeypatch):
    """A lookup phase that bills 64 result bytes the launch never moved."""
    orig = batched_mod.BatchedKernelBackend._flush_lookups

    def billed(self, lookups, opens):
        orig(self, lookups, opens)
        self.stats.result_bytes += 64

    monkeypatch.setattr(batched_mod.BatchedKernelBackend, "_flush_lookups",
                        billed)
    findings = audit_backend("batched", device="cpu")
    assert [(f.rule, f.symbol, f.slug) for f in findings] == [
        ("SIM104", "lookup", "result-bytes")]
