"""Interprocedural dataflow engine for the contract auditor (v2).

The first-generation rules (SIM001..SIM006) are syntactic and
per-function: they can spot a ``default_rng()`` with no argument, but not
a nanosecond flowing into a picojoule field two calls away, nor prove
that an RNG three assignments downstream of ``RunConfig.seed`` is in fact
seeded.  This module supplies the machinery the second-generation rules
(SIM007 units, SIM008 seed provenance, SIM009 ticket lifecycle) share:

  * **per-function CFGs** over the AST (:func:`build_cfg`) — statement
    blocks with branch/loop/try edges, loop back edges included, nested
    scopes opaque (a nested def is a value, not control flow);
  * **a forward dataflow solver** (:class:`ForwardAnalysis`) — join =
    key-wise set union, monotone transfer, worklist to fixpoint, then one
    reporting pass over every statement with its inflowing environment;
  * **abstract evaluators** — :meth:`ForwardAnalysis.transfer` delegates
    to rule-specific expression evaluation: physical *dimensions* inferred
    from the ``_ns``/``_pj``/``_bytes``/``_prob`` suffix convention
    (``backend.base`` invariant I5), *seed taint* for RNG provenance
    (I6), and *pending-ticket* sets for the flush-before-result contract
    (I1);
  * **call-graph summaries** (:class:`ProjectIndex`) — every function in
    ``src/repro_torch`` indexed by bare name, with lazily-computed, memoized,
    cycle-guarded summaries: return dimension, returns-seeded, may-flush
    and leaves-pending.  Rules resolve a call through the module being
    linted first (so fixtures stay self-contained), then project-wide.

Soundness posture: the engine is tuned to *prove* the repo's real idioms
clean rather than to maximize findings.  Multiplication and division
yield an unknown dimension (unit conversions like ``t_start_ms * MS_NS``
and rates like ``bytes / seconds`` are legitimate), only the addition,
subtraction or comparison of two *known, disjoint* dimensions is a
finding; any literal or seed-named contribution to an RNG's entropy mix
counts as seeded (the repo's entropy-list idiom mixes a declared seed
with op indices); a single outstanding ticket auto-flushed by its own
``.result()`` is the documented immediate mode, only a multi-command
implicit flush is flagged.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Callable, Iterator

from .contracts import ParsedModule, callee_name, parse_module

# ------------------------------------------------------------------ suffixes
#: dimension suffixes of the repo-wide naming convention (backend.base I5)
DIMENSIONS = ("ns", "pj", "bytes", "prob")

_DIM_RE = re.compile(r"(?:^|_)(ns|pj|bytes|prob|probs)$", re.IGNORECASE)
_SEED_RE = re.compile(r"(?:^|_)(seed|seeds|entropy)(?:_|$)", re.IGNORECASE)

#: names whose value passes its arguments' dimension through unchanged
_DIM_PASSTHROUGH = frozenset({
    "min", "max", "sum", "abs", "float", "round", "maximum", "minimum",
})
#: names whose value passes its arguments' seed taint through unchanged
_SEED_PASSTHROUGH = frozenset({
    "int", "abs", "list", "tuple", "array", "asarray", "uint32", "uint64",
    "int32", "int64",
})
#: RNG constructors whose entropy must trace to a declared seed (I6);
#: ``manual_seed(x)`` seeds a ``torch.Generator`` (or the global one) from x
RNG_NAMES = frozenset({
    "default_rng", "SeedSequence", "Philox", "PCG64", "MT19937",
    "manual_seed",
})
#: torch draws that take their entropy from ``generator=`` (the global RNG
#: when it is missing)
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like",
})
#: syntactic flush spellings (shared with SIM001's historical list)
FLUSH_NAMES = ("flush", "drain", "resolve_burst")

SEEDED = "seeded"


def suffix_dim(name: str | None) -> str | None:
    """Dimension declared by a name's suffix, or None (``pcie_bytes`` ->
    ``bytes``, ``PAGE_BYTES`` -> ``bytes``, ``zipf_probs`` -> ``prob``)."""
    if not name:
        return None
    m = _DIM_RE.search(name)
    if not m:
        return None
    d = m.group(1).lower()
    return "prob" if d == "probs" else d


def is_seed_name(name: str | None) -> bool:
    return bool(name) and bool(_SEED_RE.search(name))


def is_flush_name(name: str | None) -> bool:
    if not name:
        return False
    base = name.lstrip("_")
    return any(base == f or base.startswith(f + "_") for f in FLUSH_NAMES)


# ----------------------------------------------------------------------- CFG
class Test:
    """Branch/loop condition evaluated in a block (no bindings)."""
    __slots__ = ("expr", "lineno")

    def __init__(self, expr: ast.expr):
        self.expr = expr
        self.lineno = getattr(expr, "lineno", 0)


class Bind:
    """A ``for target in iter`` header: binds target from iter's elements."""
    __slots__ = ("target", "iter", "lineno")

    def __init__(self, node: ast.For):
        self.target = node.target
        self.iter = node.iter
        self.lineno = node.lineno


@dataclasses.dataclass
class Block:
    idx: int
    stmts: list
    succs: list[int]


@dataclasses.dataclass
class CFG:
    blocks: list[Block]
    entry: int = 0

    def stmt_count(self) -> int:
        return sum(len(b.stmts) for b in self.blocks)


_SCOPE_STMTS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def build_cfg(fn: ast.FunctionDef) -> CFG:
    """Statement-level CFG of one function body.

    Compound statements decompose into blocks and edges (if/else join,
    loop back edge + exit edge, try body/handler/finally approximation);
    ``break``/``continue``/``return``/``raise`` terminate their block.
    Nested defs/classes stay opaque single statements in their block.
    """
    blocks: list[Block] = [Block(0, [], [])]

    def new_block() -> Block:
        b = Block(len(blocks), [], [])
        blocks.append(b)
        return b

    def edge(a: Block, b: Block) -> None:
        if b.idx not in a.succs:
            a.succs.append(b.idx)

    loop_stack: list[tuple[Block, Block]] = []   # (header, after)

    def seq(stmts, cur: Block | None) -> Block | None:
        for st in stmts:
            if cur is None:                      # unreachable tail
                cur = new_block()
            if isinstance(st, ast.If):
                cur.stmts.append(Test(st.test))
                body_in = new_block()
                edge(cur, body_in)
                body_out = seq(st.body, body_in)
                if st.orelse:
                    else_in = new_block()
                    edge(cur, else_in)
                    else_out = seq(st.orelse, else_in)
                else:
                    else_out = cur
                outs = [b for b in (body_out, else_out) if b is not None]
                if not outs:
                    cur = None
                else:
                    after = new_block()
                    for b in outs:
                        edge(b, after)
                    cur = after
            elif isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
                head = new_block()
                edge(cur, head)
                head.stmts.append(Test(st.test) if isinstance(st, ast.While)
                                  else Bind(st))
                body_in = new_block()
                after = new_block()
                edge(head, body_in)
                edge(head, after)
                loop_stack.append((head, after))
                body_out = seq(st.body, body_in)
                loop_stack.pop()
                if body_out is not None:
                    edge(body_out, head)         # back edge
                cur = seq(st.orelse, after) if st.orelse else after
            elif isinstance(st, ast.Try):
                body_in = new_block()
                edge(cur, body_in)
                body_out = seq(st.body, body_in)
                if body_out is not None and st.orelse:
                    body_out = seq(st.orelse, body_out)
                outs = [body_out] if body_out is not None else []
                for h in st.handlers:
                    h_in = new_block()
                    edge(cur, h_in)              # exception may skip the body
                    if body_out is not None:
                        edge(body_out, h_in)     # or strike mid-body
                    h_out = seq(h.body, h_in)
                    if h_out is not None:
                        outs.append(h_out)
                if st.finalbody:
                    fin = new_block()
                    for o in outs:
                        edge(o, fin)
                    if not outs:
                        edge(cur, fin)           # finally always runs
                    cur = seq(st.finalbody, fin)
                elif not outs:
                    cur = None
                else:
                    after = new_block()
                    for o in outs:
                        edge(o, after)
                    cur = after
            elif isinstance(st, (ast.With, ast.AsyncWith)):
                cur.stmts.append(st)             # transfer binds the items
                cur = seq(st.body, cur)
            elif isinstance(st, (ast.Return, ast.Raise)):
                cur.stmts.append(st)
                cur = None
            elif isinstance(st, ast.Break):
                if loop_stack:
                    edge(cur, loop_stack[-1][1])
                cur = None
            elif isinstance(st, ast.Continue):
                if loop_stack:
                    edge(cur, loop_stack[-1][0])
                cur = None
            else:
                cur.stmts.append(st)
        return cur

    seq(fn.body, blocks[0])
    return CFG(blocks)


def calls_in(node: ast.AST) -> Iterator[ast.Call]:
    """Own-scope calls of a statement/expression in evaluation (post)order:
    a chained ``submit(...).result()`` yields the submit first.  Descends
    comprehensions (inline execution), not nested defs/lambdas."""
    def visit(n):
        if isinstance(n, _SCOPE_STMTS + (ast.Lambda,)):
            return
        for child in ast.iter_child_nodes(n):
            yield from visit(child)
        if isinstance(n, ast.Call):
            yield n
    if isinstance(node, Test):
        roots = [node.expr]
    elif isinstance(node, Bind):
        roots = [node.iter]
    elif isinstance(node, (ast.With, ast.AsyncWith)):
        # the body statements live in their own CFG block entries already
        roots = [item.context_expr for item in node.items]
    else:
        roots = [node]
    for r in roots:
        yield from visit(r)


def looped_call_ids(fn: ast.FunctionDef) -> set[int]:
    """``id()`` of every own-scope Call that can execute more than once per
    function entry: inside a loop body or a comprehension."""
    out: set[int] = set()

    def visit(n, in_loop: bool):
        if isinstance(n, _SCOPE_STMTS + (ast.Lambda,)) and n is not fn:
            return
        entering = in_loop or isinstance(
            n, (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
                ast.DictComp, ast.GeneratorExp))
        if isinstance(n, ast.Call) and in_loop:
            out.add(id(n))
        for child in ast.iter_child_nodes(n):
            visit(child, entering)
    visit(fn, False)
    return out


# -------------------------------------------------------------------- solver
def join_envs(a: dict | None, b: dict) -> dict:
    if a is None:
        return dict(b)
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, frozenset()) | v
    return out


class ForwardAnalysis:
    """Worklist fixpoint over a CFG; subclass provides ``transfer``.

    Environments are ``dict[str, frozenset]`` (join = key-wise union, a
    finite lattice, so the fixpoint terminates).  ``run()`` solves block
    in-environments with reporting off, then makes one reporting pass so
    each check fires exactly once per program point.
    """

    def __init__(self, cfg: CFG):
        self.cfg = cfg
        self.reporting = False
        self.report: Callable[[str, ast.AST, str], None] | None = None

    def init_env(self) -> dict:
        return {}

    def transfer(self, st, env: dict) -> dict:     # pragma: no cover
        raise NotImplementedError

    def run(self, report=None) -> None:
        ins: dict[int, dict] = {self.cfg.entry: self.init_env()}
        work = [self.cfg.entry]
        while work:
            i = work.pop(0)
            env = dict(ins[i])
            for st in self.cfg.blocks[i].stmts:
                env = self.transfer(st, env)
            for s in self.cfg.blocks[i].succs:
                joined = join_envs(ins.get(s), env)
                if ins.get(s) != joined:
                    ins[s] = joined
                    if s not in work:
                        work.append(s)
        self.report = report
        self.reporting = True
        for b in self.cfg.blocks:
            env = dict(ins.get(b.idx) or self.init_env())
            for st in b.stmts:
                env = self.transfer(st, env)
            self.block_end(b, env)
        self.reporting = False

    def block_end(self, block: Block, env: dict) -> None:
        """Hook: called with each block's out-environment during the
        reporting pass (exit-state summaries hang off this)."""


# ------------------------------------------------------------- project index
@dataclasses.dataclass
class FunctionInfo:
    module: ParsedModule
    qualname: str
    name: str
    node: ast.FunctionDef
    is_method: bool
    params: list[str]
    # memoized summaries (None = not yet computed)
    _return_dims: frozenset | None = None
    _returns_seeded: bool | None = None
    _may_flush: bool | None = None
    _leaves_pending: bool | None = None

    def call_params(self, call: ast.Call) -> list[str]:
        """Parameter names as seen by this call form (``self`` dropped for
        attribute-form method calls)."""
        if self.is_method and isinstance(call.func, ast.Attribute) \
                and self.params:
            return self.params[1:]
        return self.params

    def map_args(self, call: ast.Call) -> list[tuple[str, ast.expr]]:
        params = self.call_params(call)
        pairs: list[tuple[str, ast.expr]] = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred) or i >= len(params):
                break
            pairs.append((params[i], arg))
        for kw in call.keywords:
            if kw.arg:
                pairs.append((kw.arg, kw.value))
        return pairs


def _index_functions(mod: ParsedModule) -> list[FunctionInfo]:
    out: list[FunctionInfo] = []

    def visit(node, prefix: str, in_class: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                a = child.args
                params = [x.arg for x in (*a.posonlyargs, *a.args)]
                out.append(FunctionInfo(mod, q, child.name, child,
                                        in_class, params))
                visit(child, f"{q}.", False)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", True)
            else:
                visit(child, prefix, in_class)
    visit(mod.tree, "", False)
    return out


class ProjectIndex:
    """Bare-name function index + lazy call-graph summaries.

    Built once per process over ``src/repro_torch`` (the analysis package
    knows where it lives); :meth:`with_module` overlays the module currently
    being linted so fixture files resolve their own helpers first.
    """

    _cached: "ProjectIndex | None" = None

    def __init__(self, modules: list[ParsedModule]):
        # Lazy summaries recurse through the call graph, and each summary
        # level costs a few dozen interpreter frames (solver + evaluator);
        # a 30-call chain overflows CPython's default 1000-frame limit.
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 10_000))
        self.modules = modules
        self.by_name: dict[str, list[FunctionInfo]] = {}
        self.by_module: dict[str, list[FunctionInfo]] = {}
        for mod in modules:
            infos = _index_functions(mod)
            self.by_module[mod.real_path] = infos
            for fi in infos:
                self.by_name.setdefault(fi.name, []).append(fi)
        self._guard: set[int] = set()   # cycle guard for lazy summaries
        # out-of-project modules (fixtures, benchmarks) indexed on demand;
        # cached by path so FunctionInfo identity — which memoization and
        # the cycle guard key on — is stable across summary requests
        self._extra: dict[str, list[FunctionInfo]] = {}

    @classmethod
    def get(cls) -> "ProjectIndex":
        if cls._cached is None:
            pkg_root = Path(__file__).resolve().parents[1]   # repro_torch
            repo_root = pkg_root.parents[1]
            mods = []
            for p in sorted(pkg_root.rglob("*.py")):
                try:
                    mods.append(parse_module(p, repo_root))
                except SyntaxError:       # pragma: no cover
                    continue
            cls._cached = cls(mods)
        return cls._cached

    def with_module(self, mod: ParsedModule) -> "ModuleView":
        return ModuleView(self, mod)

    # ------------------------------------------------------------ summaries
    def _guarded(self, fi: FunctionInfo, attr: str, default,
                 compute) -> object:
        cached = getattr(fi, attr)
        if cached is not None:
            return cached
        if id(fi) in self._guard:
            return default                 # recursion: bottom of the lattice
        self._guard.add(id(fi))
        try:
            value = compute(fi)
        finally:
            self._guard.discard(id(fi))
        setattr(fi, attr, value)
        return value

    def return_dims(self, fi: FunctionInfo) -> frozenset:
        from .rules.sim007_units import function_return_dims
        return self._guarded(fi, "_return_dims", frozenset(),
                             function_return_dims)

    def returns_seeded(self, fi: FunctionInfo) -> bool:
        from .rules.sim008_seeds import function_returns_seeded
        return self._guarded(fi, "_returns_seeded", False,
                             function_returns_seeded)

    def may_flush(self, fi: FunctionInfo) -> bool:
        return self._guarded(fi, "_may_flush", False, self._compute_flush)

    def leaves_pending(self, fi: FunctionInfo) -> bool:
        from .rules.sim009_lifecycle import function_leaves_pending
        return self._guarded(fi, "_leaves_pending", False,
                             function_leaves_pending)

    def _compute_flush(self, fi: FunctionInfo) -> bool:
        """A function may flush if it (transitively) calls a flush-named
        callee.  ``.result()`` deliberately does NOT count: resolving
        through the auto-flush is exactly what SIM009 polices, so routing
        a flush summary through ``result`` would launder the violation."""
        view = self.with_module(fi.module)
        for call in calls_in_function(fi.node):
            name = callee_name(call)
            if is_flush_name(name):
                return True
            if name == "result":
                continue
            matches = view.resolve(name)
            if matches and any(self.may_flush(m) for m in matches
                               if m is not fi):
                return True
        return False


class ModuleView:
    """Name resolution preferring the module under analysis."""

    def __init__(self, index: ProjectIndex, mod: ParsedModule):
        self.index = index
        self.mod = mod
        if mod.real_path in index.by_module:
            self._local = index.by_module[mod.real_path]
        elif mod.real_path in index._extra:
            self._local = index._extra[mod.real_path]
        else:
            self._local = index._extra.setdefault(mod.real_path,
                                                  _index_functions(mod))

    def resolve(self, name: str | None) -> list[FunctionInfo]:
        if not name:
            return []
        local = [fi for fi in self._local if fi.name == name]
        if local:
            return local
        return self.index.by_name.get(name, [])

    def resolve_unique(self, name: str | None) -> FunctionInfo | None:
        matches = self.resolve(name)
        return matches[0] if len(matches) == 1 else None

    def call_sites(self, fi: FunctionInfo) -> list[tuple[FunctionInfo,
                                                         ast.Call]]:
        """Every (caller, call) whose callee bare name is ``fi.name``,
        across the module under analysis and the whole project."""
        sites: list[tuple[FunctionInfo, ast.Call]] = []
        seen: set[str] = set()
        pools = [self._local]
        for path, infos in self.index.by_module.items():
            if infos is not self._local:
                pools.append(infos)
        for infos in pools:
            for caller in infos:
                key = f"{caller.module.real_path}:{caller.qualname}"
                if key in seen:
                    continue
                seen.add(key)
                for call in calls_in_function(caller.node):
                    if callee_name(call) == fi.name:
                        sites.append((caller, call))
        return sites

    # convenience passthroughs
    def return_dims(self, fi):
        return self.index.return_dims(fi)

    def returns_seeded(self, fi):
        return self.index.returns_seeded(fi)

    def may_flush(self, fi):
        return self.index.may_flush(fi)

    def leaves_pending(self, fi):
        return self.index.leaves_pending(fi)


def calls_in_function(fn: ast.FunctionDef) -> Iterator[ast.Call]:
    """Own-scope calls of a whole function body, evaluation order per
    statement (comprehensions descended, nested scopes not)."""
    for st in fn.body:
        yield from _calls_in_stmt(st, fn)


def _calls_in_stmt(st, fn) -> Iterator[ast.Call]:
    def visit(n):
        if isinstance(n, _SCOPE_STMTS + (ast.Lambda,)) and n is not st:
            return
        for child in ast.iter_child_nodes(n):
            yield from visit(child)
        if isinstance(n, ast.Call):
            yield n
    if isinstance(st, _SCOPE_STMTS):
        return
    yield from visit(st)
