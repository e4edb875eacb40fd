"""SIM008 — seed provenance (invariant I6 in repro_torch.backend.base).

Every RNG construction in the tree must *dataflow-trace* to a declared
seed (``RunConfig.seed``, ``FaultSchedule.seed``, a ``seed`` parameter, a
literal) — the replay/chaos determinism contract is "same seed =>
byte-identical counters", and one generator drawing OS entropy anywhere
in the stack silently breaks every regression gate downstream.  This
upgrades SIM006's syntactic bare-``default_rng()`` check (now retired)
into a taint analysis on the dataflow engine:

  * taint sources: integer/string literals (deterministic), names and
    attributes matching the seed convention (``seed``, ``*_seed``,
    ``.seed``, ``entropy``), and calls to project functions whose
    summary says they return seeded values;
  * taint propagates through assignments, arithmetic (the repo's
    ``seed ^ 0xD1CE`` idiom), entropy lists (``[seed, key, attempt]`` —
    one seeded component makes the mix deterministic given the seed),
    and function returns;
  * a constructor argument that is only a *parameter* of the enclosing
    function is resolved interprocedurally: every call site in the
    project must pass a seeded value (or the parameter's default must be
    a literal) — otherwise the RNG's provenance is unproven.

torch idiom: ``torch.Generator(...).manual_seed(x)`` is an RNG
construction whose entropy is ``x`` (``manual_seed`` is checked like
``default_rng``); a ``torch.Generator(...)`` not chained into
``.manual_seed`` draws from the OS, and so does a torch draw
(``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
``bernoulli``/``multinomial`` and the ``*_like`` forms) without a
``generator=``: both are ``unseeded-rng``.

Findings: ``unseeded-rng`` (no entropy argument at all) and
``untraced-rng[:param]`` (entropy that no dataflow path connects to a
declared seed).
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..contracts import ParsedModule, attr_root, callee_name
from ..dataflow import (Bind, ForwardAnalysis, ProjectIndex, RNG_NAMES,
                        SEEDED, TORCH_DRAWS, Test, _SEED_PASSTHROUGH,
                        build_cfg, calls_in, is_seed_name)
from ..findings import Finding

_EMPTY = frozenset()


def _syntactic_seed(e, seen_depth: int = 0) -> bool:
    """Caller-side, environment-free seededness of a call-site argument."""
    if seen_depth > 6 or e is None:
        return False
    if isinstance(e, ast.Constant):
        return True
    if isinstance(e, ast.Name):
        return is_seed_name(e.id)
    if isinstance(e, ast.Attribute):
        return is_seed_name(e.attr)
    if isinstance(e, (ast.List, ast.Tuple, ast.Set)):
        return any(_syntactic_seed(x, seen_depth + 1) for x in e.elts)
    if isinstance(e, ast.BinOp):
        return _syntactic_seed(e.left, seen_depth + 1) \
            or _syntactic_seed(e.right, seen_depth + 1)
    if isinstance(e, ast.UnaryOp):
        return _syntactic_seed(e.operand, seen_depth + 1)
    if isinstance(e, ast.Call):
        if callee_name(e) in _SEED_PASSTHROUGH | RNG_NAMES:
            return any(_syntactic_seed(a, seen_depth + 1) for a in e.args)
        return False
    return False


def _is_torch_call(call: ast.Call, names) -> bool:
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr in names and attr_root(call.func) == "torch"


def _seeded_generators(fn: ast.FunctionDef) -> set[int]:
    """``id()`` of every ``torch.Generator(...)`` call that is the receiver
    of a chained ``.manual_seed(...)``: its entropy is checked there."""
    out: set[int] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and callee_name(n) == "manual_seed" \
                and isinstance(n.func, ast.Attribute) \
                and isinstance(n.func.value, ast.Call) \
                and _is_torch_call(n.func.value, ("Generator",)):
            out.add(id(n.func.value))
    return out


class SeedAnalysis(ForwardAnalysis):
    """Seed-taint propagation over one function; checks RNG constructions."""

    def __init__(self, fi, view):
        super().__init__(build_cfg(fi.node))
        self.fi = fi
        self.view = view
        self.returns_seeded = False
        self.seeded_generators = _seeded_generators(fi.node)

    def init_env(self) -> dict:
        env = {}
        a = self.fi.node.args
        for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            env[arg.arg] = (frozenset({SEEDED}) if is_seed_name(arg.arg)
                            else frozenset({f"param:{arg.arg}"}))
        return env

    # ----------------------------------------------------------- evaluation
    def eval(self, e, env: dict) -> frozenset:
        if e is None:
            return _EMPTY
        if isinstance(e, ast.Constant):
            return frozenset({SEEDED})
        if isinstance(e, ast.Name):
            if is_seed_name(e.id):
                return frozenset({SEEDED})
            return env.get(e.id, _EMPTY)
        if isinstance(e, ast.Attribute):
            return frozenset({SEEDED}) if is_seed_name(e.attr) else _EMPTY
        if isinstance(e, (ast.List, ast.Tuple, ast.Set)):
            out = _EMPTY
            for elt in e.elts:
                out |= self.eval(elt, env)
            return out
        if isinstance(e, ast.BinOp):
            return self.eval(e.left, env) | self.eval(e.right, env)
        if isinstance(e, ast.UnaryOp):
            return self.eval(e.operand, env)
        if isinstance(e, ast.BoolOp):
            out = _EMPTY
            for v in e.values:
                out |= self.eval(v, env)
            return out
        if isinstance(e, ast.IfExp):
            return self.eval(e.body, env) | self.eval(e.orelse, env)
        if isinstance(e, ast.Subscript):
            return self.eval(e.value, env)
        if isinstance(e, ast.Starred):
            return self.eval(e.value, env)
        if isinstance(e, ast.NamedExpr):
            t = self.eval(e.value, env)
            if isinstance(e.target, ast.Name):
                env[e.target.id] = t
            return t
        if isinstance(e, ast.Call):
            name = callee_name(e)
            if name in _SEED_PASSTHROUGH | RNG_NAMES:
                out = _EMPTY
                for a in e.args:
                    out |= self.eval(a, env)
                for kw in e.keywords:
                    out |= self.eval(kw.value, env)
                return out
            matches = self.view.resolve(name)
            if matches and any(self.view.returns_seeded(m) for m in matches):
                return frozenset({SEEDED})
            return _EMPTY
        return _EMPTY

    # ------------------------------------------------------------- RNG check
    def _check_rng(self, call: ast.Call, env: dict) -> None:
        name = callee_name(call)
        if not call.args and not call.keywords:
            self.report(
                "unseeded-rng", call,
                f"{name}() with no entropy draws from the OS — the "
                "same-seed => byte-identical-counters contract (I6) "
                "requires a declared seed")
            return
        taint = _EMPTY
        for a in call.args:
            taint |= self.eval(a, env)
        for kw in call.keywords:
            taint |= self.eval(kw.value, env)
        if SEEDED in taint:
            return
        params = sorted({t[6:] for t in taint if t.startswith("param:")})
        if not params:
            self.report(
                "untraced-rng", call,
                f"{name}(...) entropy has no dataflow path to a declared "
                "seed (literal, seed-named value, or seeded-returning "
                "function)")
            return
        for p in params:
            ok, why = self._trace_param(p)
            if not ok:
                self.report(
                    f"untraced-rng:{p}", call,
                    f"{name}(...) entropy flows from parameter {p!r}, "
                    f"which is not proven seeded: {why}")

    def _check_torch(self, call: ast.Call) -> None:
        """A torch RNG that takes no declared seed: a ``torch.Generator``
        never chained into ``.manual_seed``, or a draw on the global RNG."""
        if _is_torch_call(call, ("Generator",)) \
                and id(call) not in self.seeded_generators:
            self.report(
                "unseeded-rng", call,
                "torch.Generator(...) without a chained .manual_seed(seed) "
                "starts from OS entropy (I6)")
        elif _is_torch_call(call, TORCH_DRAWS) and not any(
                kw.arg == "generator" for kw in call.keywords):
            self.report(
                "unseeded-rng", call,
                f"torch.{call.func.attr}(...) without generator= draws from "
                "the global RNG, whose seed nothing declares (I6)")

    def _trace_param(self, p: str) -> tuple[bool, str]:
        """Interprocedural leg: prove parameter ``p`` receives a seeded
        value at every project call site (or via a literal default)."""
        default = self._param_default(p)
        sites = self.view.call_sites(self.fi)
        if not sites and default is None:
            return False, "no call sites found and no literal default"
        for caller, call in sites:
            pairs = dict(self.fi.map_args(call))
            if p in pairs:
                if not _syntactic_seed(pairs[p]):
                    return False, (f"call site {caller.qualname} "
                                   f"(line {call.lineno}) passes an "
                                   "unseeded value")
            elif default is None or not _syntactic_seed(default):
                return False, (f"call site {caller.qualname} "
                               f"(line {call.lineno}) omits it and the "
                               "default is not a literal seed")
        return True, ""

    def _param_default(self, p: str):
        a = self.fi.node.args
        pos = [*a.posonlyargs, *a.args]
        for arg, d in zip(reversed(pos), reversed(a.defaults)):
            if arg.arg == p:
                return d
        for arg, d in zip(a.kwonlyargs, a.kw_defaults):
            if arg.arg == p and d is not None:
                return d
        return None

    # ------------------------------------------------------------- transfer
    def transfer(self, st, env: dict) -> dict:
        env = dict(env)
        if self.report is not None:
            for call in calls_in(st):
                if callee_name(call) in RNG_NAMES:
                    self._check_rng(call, env)
                else:
                    self._check_torch(call)
        if isinstance(st, Bind):
            self._bind(st.target, self.eval(st.iter, env), env)
        elif isinstance(st, Test):
            pass
        elif isinstance(st, ast.Assign):
            t = self.eval(st.value, env)
            for target in st.targets:
                self._bind(target, t, env)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._bind(st.target, self.eval(st.value, env), env)
        elif isinstance(st, ast.AugAssign):
            if isinstance(st.target, ast.Name):
                env[st.target.id] = env.get(st.target.id, _EMPTY) \
                    | self.eval(st.value, env)
        elif isinstance(st, ast.Return):
            if self.reporting and SEEDED in self.eval(st.value, env):
                self.returns_seeded = True
        return env

    def _bind(self, target, taint: frozenset, env: dict) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = taint
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, taint, env)


def function_returns_seeded(fi) -> bool:
    """Call-graph summary: can this function return a seeded value?"""
    view = ProjectIndex.get().with_module(fi.module)
    sa = SeedAnalysis(fi, view)
    sa.run()
    return sa.returns_seeded


class Sim008Seeds:
    rule_id = "SIM008"
    title = "every RNG construction dataflow-traces to a declared seed"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.endswith(".py")

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        view = ProjectIndex.get().with_module(mod)
        for fi in view._local:
            found: list[Finding] = []

            def report(slug, node, msg, _q=fi.qualname, _out=found):
                _out.append(Finding(self.rule_id, mod.rel_path, _q, slug,
                                    message=msg,
                                    line=getattr(node, "lineno", 0)))
            sa = SeedAnalysis(fi, view)
            sa.report = None
            sa.run(report)
            seen: set[str] = set()
            for f in found:
                if f.slug not in seen:
                    seen.add(f.slug)
                    yield f
