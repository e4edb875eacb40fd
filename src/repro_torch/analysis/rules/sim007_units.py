"""SIM007 — physical-unit discipline (invariant I5 in repro_torch.backend.base).

Every quantity that crosses a layer boundary carries its dimension in its
name: ``_ns`` (time), ``_pj`` (energy), ``_bytes`` (payload), ``_prob``
(probability).  The proof methodology of the whole repo — exact counters
reconciled across backend -> timeline -> frontend -> report — only works
if a nanosecond never lands in a picojoule field.  This rule infers
dimensions from the suffix convention and taint-propagates them through
assignments, arithmetic, returns and call arguments on the dataflow
engine's per-function CFGs, with call-graph summaries for the return
dimension of project functions.

Findings (slugs):

  * ``mix:<a>+<b>``      — addition/subtraction/comparison of two known,
    disjoint dimensions (``lat_ns + cost_pj``);
  * ``mis-assign:<n>``   — a suffixed target assigned a value of a
    different known dimension (``energy_pj = t_ns``);
  * ``mis-call:<f>.<p>`` — a value of known dimension passed to a
    parameter or keyword whose suffix declares a different one (the
    "latency into an energy parameter two calls away" case — positional
    arguments are matched against the resolved callee's signature);
  * ``mis-return:<dim>`` — a function whose name declares a dimension
    returning a different known one.

Soundness: multiplication/division/modulo yield *unknown* (unit algebra —
conversions and rates are legitimate), and a check fires only when BOTH
sides have known dimensions with an empty intersection, so untyped
intermediates never false-positive.  Joins union the possible dimensions.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..contracts import ParsedModule, callee_name
from ..dataflow import (Bind, ForwardAnalysis, ProjectIndex, Test,
                        _DIM_PASSTHROUGH, build_cfg, suffix_dim)
from ..findings import Finding

_EMPTY = frozenset()


class DimAnalysis(ForwardAnalysis):
    """Forward dimension propagation over one function."""

    def __init__(self, fn: ast.FunctionDef, view):
        super().__init__(build_cfg(fn))
        self.fn = fn
        self.view = view
        self.returned: set[str] = set()

    def init_env(self) -> dict:
        env = {}
        a = self.fn.args
        for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            d = suffix_dim(arg.arg)
            if d:
                env[arg.arg] = frozenset({d})
        return env

    # --------------------------------------------------------------- checks
    def _report(self, slug: str, node, msg: str) -> None:
        if self.report is not None:
            self.report(slug, node, msg)

    def _mix(self, a: frozenset, b: frozenset, node, what: str) -> None:
        if a and b and a.isdisjoint(b):
            self._report(f"mix:{'|'.join(sorted(a))}+{'|'.join(sorted(b))}",
                         node,
                         f"{what} of {'/'.join(sorted(a))} and "
                         f"{'/'.join(sorted(b))} quantities — incompatible "
                         "physical dimensions (I5 suffix convention)")

    # ----------------------------------------------------------- evaluation
    def eval(self, e, env: dict) -> frozenset:
        if e is None:
            return _EMPTY
        if isinstance(e, ast.Name):
            if e.id in env:
                return env[e.id]
            d = suffix_dim(e.id)
            return frozenset({d}) if d else _EMPTY
        if isinstance(e, ast.Attribute):
            d = suffix_dim(e.attr)
            return frozenset({d}) if d else _EMPTY
        if isinstance(e, ast.Constant):
            return _EMPTY
        if isinstance(e, ast.BinOp):
            left = self.eval(e.left, env)
            right = self.eval(e.right, env)
            if isinstance(e.op, (ast.Add, ast.Sub)):
                self._mix(left, right, e, "addition/subtraction")
                return left | right
            return _EMPTY            # *, /, //, %, **: unit algebra, unknown
        if isinstance(e, ast.UnaryOp):
            return self.eval(e.operand, env)
        if isinstance(e, ast.IfExp):
            self.eval(e.test, env)
            return self.eval(e.body, env) | self.eval(e.orelse, env)
        if isinstance(e, ast.Compare):
            dims = [self.eval(e.left, env)]
            dims += [self.eval(c, env) for c in e.comparators]
            for a, b in zip(dims, dims[1:]):
                self._mix(a, b, e, "comparison")
            return _EMPTY
        if isinstance(e, ast.BoolOp):
            out = _EMPTY
            for v in e.values:
                out |= self.eval(v, env)
            return out
        if isinstance(e, ast.NamedExpr):
            d = self.eval(e.value, env)
            if isinstance(e.target, ast.Name):
                env[e.target.id] = d
            return d
        if isinstance(e, ast.Call):
            return self.eval_call(e, env)
        if isinstance(e, ast.Subscript):
            self.eval(e.slice, env)
            return self.eval(e.value, env)
        if isinstance(e, ast.Starred):
            return self.eval(e.value, env)
        if isinstance(e, (ast.List, ast.Tuple, ast.Set)):
            for elt in e.elts:
                self.eval(elt, env)
            return _EMPTY
        if isinstance(e, ast.Dict):
            for k in e.keys:
                self.eval(k, env)
            for v in e.values:
                self.eval(v, env)
            return _EMPTY
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for g in e.generators:
                self.eval(g.iter, env)
            return _EMPTY
        if isinstance(e, (ast.JoinedStr, ast.FormattedValue)):
            return _EMPTY
        return _EMPTY

    def eval_call(self, call: ast.Call, env: dict) -> frozenset:
        argdims = [self.eval(a, env) for a in call.args]
        name = callee_name(call)
        # keyword-name check works on ANY call — the kw name IS a signature
        for kw in call.keywords:
            d = self.eval(kw.value, env)
            kdim = suffix_dim(kw.arg)
            if kdim and d and kdim not in d:
                self._report(
                    f"mis-call:{name or '?'}.{kw.arg}", call,
                    f"keyword {kw.arg} (declares {kdim}) receives a "
                    f"{'/'.join(sorted(d))} value")
        # positional check needs the resolved callee's parameter names
        fi = self.view.resolve_unique(name)
        if fi is not None:
            params = fi.call_params(call)
            for i, arg in enumerate(call.args):
                if isinstance(arg, ast.Starred) or i >= len(params):
                    break
                pdim = suffix_dim(params[i])
                if pdim and argdims[i] and pdim not in argdims[i]:
                    self._report(
                        f"mis-call:{name}.{params[i]}", call,
                        f"parameter {params[i]} of {fi.qualname} (declares "
                        f"{pdim}) receives a "
                        f"{'/'.join(sorted(argdims[i]))} value")
        # return dimension: passthroughs, the callee's own suffix, summaries
        if name in _DIM_PASSTHROUGH:
            out = _EMPTY
            for d in argdims:
                out |= d
            for kw in call.keywords:
                out |= self.eval(kw.value, env)
            return out
        d = suffix_dim(name)
        if d:
            return frozenset({d})
        matches = self.view.resolve(name)
        if matches:
            summaries = {self.view.return_dims(m) for m in matches}
            if len(summaries) == 1:
                return summaries.pop()
        return _EMPTY

    # ------------------------------------------------------------- transfer
    def _bind(self, target, dims: frozenset, env: dict,
              check: bool, node=None) -> None:
        if isinstance(target, ast.Name):
            tdim = suffix_dim(target.id)
            if check and tdim and dims and tdim not in dims:
                self._report(
                    f"mis-assign:{target.id}", node or target,
                    f"{target.id} declares {tdim} but is assigned a "
                    f"{'/'.join(sorted(dims))} value")
            env[target.id] = dims or (frozenset({tdim}) if tdim else _EMPTY)
        elif isinstance(target, ast.Attribute):
            tdim = suffix_dim(target.attr)
            if check and tdim and dims and tdim not in dims:
                self._report(
                    f"mis-assign:{target.attr}", node or target,
                    f".{target.attr} declares {tdim} but is assigned a "
                    f"{'/'.join(sorted(dims))} value")
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, _EMPTY, env, False)
        # Subscript/Starred targets: no name to type

    def _target_dims(self, target, env: dict) -> frozenset:
        if isinstance(target, ast.Name):
            if target.id in env:
                return env[target.id]
            d = suffix_dim(target.id)
            return frozenset({d}) if d else _EMPTY
        if isinstance(target, ast.Attribute):
            d = suffix_dim(target.attr)
            return frozenset({d}) if d else _EMPTY
        return _EMPTY

    def transfer(self, st, env: dict) -> dict:
        env = dict(env)
        if isinstance(st, Test):
            self.eval(st.expr, env)
        elif isinstance(st, Bind):
            self._bind(st.target, self.eval(st.iter, env), env, False)
        elif isinstance(st, ast.Assign):
            dims = self.eval(st.value, env)
            if len(st.targets) == 1 \
                    and isinstance(st.targets[0], (ast.Tuple, ast.List)) \
                    and isinstance(st.value, (ast.Tuple, ast.List)) \
                    and len(st.targets[0].elts) == len(st.value.elts):
                for t, v in zip(st.targets[0].elts, st.value.elts):
                    self._bind(t, self.eval(v, env), env, True, st)
            else:
                for t in st.targets:
                    self._bind(t, dims, env, True, st)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._bind(st.target, self.eval(st.value, env), env,
                           True, st)
        elif isinstance(st, ast.AugAssign):
            vdims = self.eval(st.value, env)
            tdims = self._target_dims(st.target, env)
            if isinstance(st.op, (ast.Add, ast.Sub)):
                self._mix(tdims, vdims, st, "augmented addition/subtraction")
                if isinstance(st.target, ast.Name):
                    env[st.target.id] = tdims | vdims
            # *=, /= etc: unit algebra — keep the declared dimension
        elif isinstance(st, ast.Return):
            dims = self.eval(st.value, env)
            if self.reporting:
                self.returned |= dims
                fdim = suffix_dim(self.fn.name)
                if fdim and dims and fdim not in dims:
                    self._report(
                        f"mis-return:{'|'.join(sorted(dims))}", st,
                        f"{self.fn.name} declares {fdim} but returns a "
                        f"{'/'.join(sorted(dims))} value")
        elif isinstance(st, ast.Expr):
            self.eval(st.value, env)
        elif isinstance(st, ast.Assert):
            self.eval(st.test, env)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                d = self.eval(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, d, env, False)
        return env


def function_return_dims(fi) -> frozenset:
    """Call-graph summary: the union of dimensions a function can return
    (computed by running its full CFG analysis; memoized by the index)."""
    view = ProjectIndex.get().with_module(fi.module)
    da = DimAnalysis(fi.node, view)
    da.run()
    return frozenset(da.returned)


class Sim007Units:
    rule_id = "SIM007"
    title = "suffix-declared dimensions (_ns/_pj/_bytes/_prob) never mix"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.endswith(".py")

    def check(self, mod: ParsedModule) -> Iterator[Finding]:
        view = ProjectIndex.get().with_module(mod)
        for qualname, fn in mod.functions():
            found: list[Finding] = []

            def report(slug, node, msg, _q=qualname, _out=found):
                _out.append(Finding(self.rule_id, mod.rel_path, _q, slug,
                                    message=msg,
                                    line=getattr(node, "lineno", 0)))
            DimAnalysis(fn, view).run(report)
            seen: set[str] = set()
            for f in found:
                if f.slug not in seen:      # one finding per site kind/fn
                    seen.add(f.slug)
                    yield f
