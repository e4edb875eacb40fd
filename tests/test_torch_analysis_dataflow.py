"""The port's dataflow engine (repro_torch.analysis.dataflow): the JAX
engine's cases (CFG shapes, suffix dimensions, summaries, recursion) run
against it, and both engines build the same CFGs for the same sources."""
import ast
import textwrap
from pathlib import Path

import pytest

from repro.analysis import dataflow as jax_dataflow
from repro_torch.analysis.contracts import parse_module
from repro_torch.analysis.dataflow import Test as CondTest
from repro_torch.analysis.dataflow import (Bind, ProjectIndex, build_cfg,
                                           calls_in, is_flush_name,
                                           is_seed_name, join_envs,
                                           looped_call_ids, suffix_dim)

ROOT = Path(__file__).resolve().parents[1]


def _fn(src: str) -> ast.FunctionDef:
    tree = ast.parse(textwrap.dedent(src))
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef))


def _mod(tmp_path, src: str, name="m.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return parse_module(p, tmp_path)


# ------------------------------------------------------------------ suffixes
def test_suffix_dimension_inference():
    assert suffix_dim("pcie_bytes") == "bytes"
    assert suffix_dim("PAGE_BYTES") == "bytes"       # constants too
    assert suffix_dim("t_read_ns") == "ns"
    assert suffix_dim("energy_pj") == "pj"
    assert suffix_dim("zipf_probs") == "prob"        # plural normalizes
    assert suffix_dim("ns") == "ns"                  # bare suffix
    assert suffix_dim("burns") is None               # no _ boundary
    assert suffix_dim("nsq") is None                 # suffix only
    assert suffix_dim("latency") is None
    assert suffix_dim(None) is None


def test_seed_and_flush_name_predicates():
    assert is_seed_name("seed") and is_seed_name("device_seed")
    assert is_seed_name("seed_root") and is_seed_name("entropy")
    assert not is_seed_name("seedling") and not is_seed_name("reseeded")
    assert is_flush_name("flush") and is_flush_name("flush_writes")
    assert is_flush_name("_drain") and is_flush_name("resolve_burst")
    assert not is_flush_name("flushed") and not is_flush_name("result")


# ----------------------------------------------------------------------- CFG
def test_cfg_if_else_join():
    fn = _fn("""
        def f(x):
            a = 1
            if x:
                b = 2
            else:
                b = 3
            return b
    """)
    cfg = build_cfg(fn)
    # every statement lands in exactly one block
    assert cfg.stmt_count() == 5   # a=1, Test(x), b=2, b=3, return
    # the entry block branches two ways; both arms rejoin in one block
    succs = cfg.blocks[0].succs
    assert len(succs) == 2
    joins = [b.idx for b in cfg.blocks
             if any(isinstance(s, ast.Return) for s in b.stmts)]
    assert len(joins) == 1


def test_cfg_loop_back_edge():
    fn = _fn("""
        def f(xs):
            total = 0
            for x in xs:
                total += x
            return total
    """)
    cfg = build_cfg(fn)
    header = next(b for b in cfg.blocks
                  if any(isinstance(s, Bind) for s in b.stmts))
    body = next(b for b in cfg.blocks
                if any(isinstance(s, ast.AugAssign) for s in b.stmts))
    assert header.idx in body.succs          # the back edge
    assert len(header.succs) == 2            # body + after


def test_cfg_while_and_break_terminate_blocks():
    fn = _fn("""
        def f(q):
            while True:
                item = q.get()
                if item is None:
                    break
            return item
    """)
    cfg = build_cfg(fn)
    header = next(b for b in cfg.blocks
                  if any(isinstance(s, CondTest) for s in b.stmts))
    after = next(b for b in cfg.blocks
                 if any(isinstance(s, ast.Return) for s in b.stmts))
    preds = [b.idx for b in cfg.blocks if after.idx in b.succs]
    # reachable via the loop exit edge AND via break
    assert len(preds) >= 2
    assert header.succs                      # header always has successors


def test_cfg_try_handler_edges():
    fn = _fn("""
        def f(t):
            try:
                r = t.result()
            except IOError:
                r = None
            return r
    """)
    cfg = build_cfg(fn)
    handler = next(b for b in cfg.blocks for s in b.stmts
                   if isinstance(s, ast.Assign)
                   and isinstance(s.value, ast.Constant))
    preds = [b.idx for b in cfg.blocks if handler.idx in b.succs]
    # reachable both by skipping the body and after the body ran
    assert len(preds) >= 2


def test_calls_in_evaluation_order_and_scope():
    st = ast.parse("x = outer(inner()).result()").body[0]
    names = [c.func.id if isinstance(c.func, ast.Name) else c.func.attr
             for c in calls_in(st)]
    assert names == ["inner", "outer", "result"]
    # nested defs and lambdas are opaque
    st2 = ast.parse("f = lambda: hidden()").body[0]
    assert list(calls_in(st2)) == []


def test_looped_call_ids_marks_loops_and_comprehensions():
    fn = _fn("""
        def f(backend, cmds):
            once = backend.submit_search(cmds[0])
            many = [backend.submit_search(c) for c in cmds]
            for c in cmds:
                backend.submit_gather(c)
    """)
    looped = looped_call_ids(fn)
    calls = {c.func.attr: c for c in ast.walk(fn)
             if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Attribute)}
    assert id(calls["submit_gather"]) in looped
    once, comp = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                  and isinstance(c.func, ast.Attribute)
                  and c.func.attr == "submit_search"]
    assert (id(once) in looped) != (id(comp) in looped)


def test_join_envs_is_keywise_union():
    a = {"x": frozenset({"ns"})}
    b = {"x": frozenset({"pj"}), "y": frozenset({"bytes"})}
    j = join_envs(a, b)
    assert j == {"x": frozenset({"ns", "pj"}), "y": frozenset({"bytes"})}
    assert join_envs(None, b) == b


# ------------------------------------------------------------- summaries
def test_return_dims_summary_propagates_through_calls(tmp_path):
    mod = _mod(tmp_path, """
        def total_ns(a_ns, b_ns):
            return a_ns + b_ns

        def doubled(a_ns, b_ns):
            return total_ns(a_ns, b_ns)
    """)
    idx = ProjectIndex.get()
    view = idx.with_module(mod)
    total, doubled = view._local
    assert view.return_dims(total) == frozenset({"ns"})
    # the caller's summary flows through the callee's summary
    assert view.return_dims(doubled) == frozenset({"ns"})


def test_returns_seeded_summary(tmp_path):
    mod = _mod(tmp_path, """
        def derive(base):
            return 0xFEED + base

        def launder(base):
            return base
    """)
    view = ProjectIndex.get().with_module(mod)
    derive, launder = view._local
    assert view.returns_seeded(derive) is True
    assert view.returns_seeded(launder) is False


def test_may_flush_summary_skips_result(tmp_path):
    mod = _mod(tmp_path, """
        def helper(backend):
            backend.flush()

        def indirect(backend):
            helper(backend)

        def via_result_only(ticket):
            return ticket.result()
    """)
    view = ProjectIndex.get().with_module(mod)
    helper, indirect, via_result = view._local
    assert view.may_flush(helper) is True
    assert view.may_flush(indirect) is True       # transitive
    # .result() auto-flushes at runtime, but summarizing it as a flush
    # would launder the exact anti-pattern SIM009 polices
    assert view.may_flush(via_result) is False


def test_leaves_pending_summary(tmp_path):
    mod = _mod(tmp_path, """
        def stages(backend, cmd):
            return backend.submit_search(cmd)

        def settled(backend, cmd):
            t = backend.submit_search(cmd)
            backend.flush()
            return t
    """)
    view = ProjectIndex.get().with_module(mod)
    stages, settled = view._local
    assert view.leaves_pending(stages) is True
    assert view.leaves_pending(settled) is False


def test_recursive_summaries_terminate(tmp_path):
    mod = _mod(tmp_path, """
        def ping(n):
            return pong(n - 1)

        def pong(n):
            return ping(n - 1)
    """)
    view = ProjectIndex.get().with_module(mod)
    ping, _ = view._local
    # the cycle guard bottoms out instead of recursing forever
    assert view.return_dims(ping) == frozenset()
    assert view.returns_seeded(ping) is False


def test_project_index_knows_the_real_tree():
    idx = ProjectIndex.get()
    # spot-check: the timeline adapter's flush observer is indexed
    names = {fi.qualname for fi in idx.by_name.get("observe_flush", [])}
    assert "BurstTimeline.observe_flush" in names
    # and method call_params drop self for attribute-form calls
    fi = next(f for f in idx.by_name["observe_flush"]
              if f.qualname == "BurstTimeline.observe_flush")
    call = ast.parse("tl.observe_flush(bursts)", mode="eval").body
    assert fi.call_params(call)[0] == "bursts"


def test_project_index_is_the_ports():
    idx = ProjectIndex.get()
    paths = {m.rel_path for m in idx.modules}
    assert paths and all(p.startswith("src/repro_torch/") for p in paths)
    assert "src/repro_torch/backend/batched.py" in paths


def test_torch_generator_seed_flows_through_manual_seed(tmp_path):
    mod = _mod(tmp_path, """
        import torch

        def make(seed):
            return torch.Generator().manual_seed(seed)

        def unseeded():
            return torch.Generator()
    """)
    view = ProjectIndex.get().with_module(mod)
    make, unseeded = view._local
    assert view.returns_seeded(make) is True
    assert view.returns_seeded(unseeded) is False


# ------------------------------------------- the two engines' CFGs agree
def _shape(cfg):
    return [([type(s).__name__ for s in b.stmts], sorted(b.succs))
            for b in cfg.blocks]


_CFG_SOURCES = sorted(
    p.relative_to(ROOT).as_posix()
    for d in ("backend", "frontend", "flash", "reliability", "index")
    for p in (ROOT / "src" / "repro_torch" / d).glob("*.py")
    if p.name != "__init__.py")


@pytest.mark.parametrize("rel", _CFG_SOURCES)
def test_cfgs_agree_with_the_jax_engine(rel):
    """Every function of the port's backend, frontend, flash, reliability
    and index layers: both engines build block for block the same CFG."""
    tree = ast.parse((ROOT / rel).read_text())
    fns = [n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    assert fns
    for fn in fns:
        assert _shape(build_cfg(fn)) == \
            _shape(jax_dataflow.build_cfg(fn)), fn.name
