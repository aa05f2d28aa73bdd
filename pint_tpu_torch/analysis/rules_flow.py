"""precision-flow: interprocedural f32 taint into f64-critical sinks.

The per-file ``f32-in-f64`` rule flags float32 introduced LEXICALLY
inside a registered f64-critical function. It cannot see the chain the
ERRORBUDGET tiers actually worry about: a kernel wrapper or a
``.to(torch.float32)`` in one module producing a value that flows
through helpers and call boundaries into the whitening/normal-equation
chain three files away. This rule closes that gap with a summary-based
taint analysis over the ProjectIndex:

- **sources**: the ``f32-in-f64`` markers — ``.to(torch.float32)`` /
  ``.float()`` / ``.half()`` / ``.bfloat16()``, ``dtype=torch.float32``
  constructors, a torch factory left at torch's float32 default
  (``torch.zeros(n)``) — and calls whose name matches the configured
  f32-source patterns (the ``*_cuda`` kernel wrappers: the hand-written
  Hopper kernels compute in f32);
- **propagation**: assignments, arithmetic, returns, and calls — each
  function gets a summary (tainted return? which params reach a
  critical sink?) iterated to a fixpoint over the call graph;
- **sanitizers**: ``.double()``, ``.to(torch.float64)`` /
  ``.to(dtype=torch.float64)``, ``dtype=torch.float64`` constructors and
  ``np.float64(...)`` kill the taint (the value is f64 again — the lost
  digits are gone, but that is f32-in-f64's lexical problem at the cast
  site, not a flow);
- **sinks**: calls into functions registered in ``F64_CRITICAL``.

Findings name the full source→sink chain, one per (function, source
site). Taint introduced lexically inside the critical function itself
is NOT re-reported — that is exactly f32-in-f64's finding, and the two
rules partition the space: lexical introduction vs cross-function
flow.
"""

from __future__ import annotations

import ast
import re

from .core import Rule, call_name, dotted_name, register
from .rules_precision import (F32_CAST_METHODS, default_dtype_factory,
                              f32_marker)

_CLEAN = (frozenset(), None)

# numpy/torch constructors that accept dtype= and forward their input
_DTYPE_CTORS = frozenset({
    "asarray", "array", "zeros", "ones", "full", "empty", "arange",
    "linspace", "zeros_like", "ones_like", "full_like", "empty_like",
    "tensor", "as_tensor", "logspace", "eye", "rand", "randn",
    "new_zeros", "new_ones", "new_full", "new_empty", "new_tensor",
})


def _merge(a, b):
    return (a[0] | b[0], a[1] if a[1] is not None else b[1])


def _dtype_marker(expr):
    """"f32" / "f64" / None for a dtype-valued expression."""
    for sub in ast.walk(expr):
        if f32_marker(sub) is not None and not isinstance(sub, ast.Call):
            return "f32"
        if dotted_name(sub) == "torch.double":
            return "f64"
        text = None
        if isinstance(sub, ast.Attribute):
            text = sub.attr
        elif isinstance(sub, ast.Name):
            text = sub.id
        elif isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                          str):
            text = sub.value
        if text is None:
            continue
        if "float32" in text or text == "f32":
            return "f32"
        if "float64" in text or text == "f64":
            return "f64"
    return None


class _FuncState:
    __slots__ = ("func", "rel", "ret", "param_sinks", "calls",
                 "report", "reported", "ctx")

    def __init__(self, func, calls, report):
        self.func = func
        self.ctx = func.ctx
        self.rel = func.ctx.rel
        self.ret = _CLEAN
        self.param_sinks = {}
        self.calls = calls
        self.report = report
        self.reported = set()


@register
class PrecisionFlowRule(Rule):
    """An f32 value produced anywhere — a kernel wrapper, a cast in a
    prep helper — that reaches a registered f64-critical sink has
    already destroyed ~9 of the ~16 decimal digits the TOA residual
    contract requires, no matter how many f64 casts happen afterwards.
    The flow must be broken at the source or explicitly sanctioned."""

    id = "precision-flow"
    family = "precision"
    rationale = ("f32 value flowing across functions into an "
                 "f64-critical sink loses the precision the residual "
                 "contract requires; the full source->sink chain is "
                 "reported")
    whole_program = True

    def check_project(self, project, index):
        config = project.config
        if not config.f64_critical:
            return
        self.index = index
        self.src_re = re.compile("|".join(
            config.f32_source_patterns)) if config.f32_source_patterns \
            else None
        self.critical = self._critical_funcs(index, config)
        funcs = [index.functions[q] for q in sorted(index.functions)]
        call_maps = {
            f.qname: {id(c): g for c, g in index.calls_of(f)}
            for f in funcs
        }
        self.summaries = {}
        for _ in range(10):
            changed = False
            for f in funcs:
                st = _FuncState(f, call_maps[f.qname], report=False)
                self._analyze(st)
                new = (st.ret, tuple(sorted(st.param_sinks.items())))
                if self.summaries.get(f.qname) != new:
                    self.summaries[f.qname] = new
                    changed = True
            if not changed:
                break
        for f in funcs:
            st = _FuncState(f, call_maps[f.qname], report=True)
            self._analyze(st)

    @staticmethod
    def _critical_funcs(index, config):
        out = set()
        for qname, func in index.functions.items():
            for suffix, names in config.f64_critical.items():
                if not (func.ctx.path.endswith(suffix)
                        or func.ctx.rel.endswith(suffix)):
                    continue
                if "*" in names or func.name in names:
                    out.add(qname)
                break
        return out

    # -- the fixpoint ---------------------------------------------------

    def _analyze(self, st):
        env = {}
        args = st.func.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            env[a.arg] = (frozenset({a.arg}), None)
        if st.func.cls is not None:
            env.pop("self", None)
            env["self"] = _CLEAN
        self._block(st.func.node.body, env, st)
        st.ret = st.ret

    def _block(self, stmts, env, st):
        for s in stmts:
            self._stmt(s, env, st)

    def _stmt(self, s, env, st):
        if isinstance(s, ast.Assign):
            av = self._eval(s.value, env, st)
            for tgt in s.targets:
                self._bind(tgt, av, env)
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            self._bind(s.target, self._eval(s.value, env, st), env)
        elif isinstance(s, ast.AugAssign):
            av = self._eval(s.value, env, st)
            if isinstance(s.target, ast.Name):
                env[s.target.id] = _merge(
                    env.get(s.target.id, _CLEAN), av)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                st.ret = _merge(st.ret, self._eval(s.value, env, st))
        elif isinstance(s, ast.Expr):
            self._eval(s.value, env, st)
        elif isinstance(s, ast.If):
            self._eval(s.test, env, st)
            left, right = dict(env), dict(env)
            self._block(s.body, left, st)
            self._block(s.orelse, right, st)
            for k in set(left) | set(right):
                env[k] = _merge(left.get(k, _CLEAN),
                                right.get(k, _CLEAN))
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            av = self._eval(s.iter, env, st)
            self._bind(s.target, av, env)
            # twice: pick up loop-carried taint
            self._block(s.body, env, st)
            self._block(s.body, env, st)
            self._block(s.orelse, env, st)
        elif isinstance(s, ast.While):
            self._eval(s.test, env, st)
            self._block(s.body, env, st)
            self._block(s.body, env, st)
            self._block(s.orelse, env, st)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                av = self._eval(item.context_expr, env, st)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, av, env)
            self._block(s.body, env, st)
        elif isinstance(s, ast.Try):
            self._block(s.body, env, st)
            for h in s.handlers:
                self._block(h.body, env, st)
            self._block(s.orelse, env, st)
            self._block(s.finalbody, env, st)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            pass                   # nested defs have their own summary
        elif isinstance(s, (ast.Assert, ast.Raise)):
            pass
        # Pass/Break/Continue/Import/Global/Delete: nothing flows

    def _bind(self, tgt, av, env):
        if isinstance(tgt, ast.Name):
            env[tgt.id] = av
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._bind(elt, av, env)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, av, env)
        # attribute/subscript targets: not tracked

    # -- expressions ----------------------------------------------------

    def _eval(self, expr, env, st):
        if isinstance(expr, ast.Name):
            return env.get(expr.id, _CLEAN)
        if isinstance(expr, ast.Constant):
            return _CLEAN
        if isinstance(expr, ast.Call):
            return self._eval_call(expr, env, st)
        if isinstance(expr, ast.Attribute):
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                return _CLEAN      # object state: not tracked
            return self._eval(expr.value, env, st)
        if isinstance(expr, ast.BinOp):
            return _merge(self._eval(expr.left, env, st),
                          self._eval(expr.right, env, st))
        if isinstance(expr, ast.BoolOp):
            out = _CLEAN
            for v in expr.values:
                out = _merge(out, self._eval(v, env, st))
            return out
        if isinstance(expr, ast.UnaryOp):
            return self._eval(expr.operand, env, st)
        if isinstance(expr, ast.Compare):
            for c in [expr.left] + expr.comparators:
                self._eval(c, env, st)
            return _CLEAN
        if isinstance(expr, ast.Subscript):
            return self._eval(expr.value, env, st)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out = _CLEAN
            for elt in expr.elts:
                out = _merge(out, self._eval(elt, env, st))
            return out
        if isinstance(expr, ast.Dict):
            out = _CLEAN
            for v in expr.values:
                if v is not None:
                    out = _merge(out, self._eval(v, env, st))
            return out
        if isinstance(expr, ast.IfExp):
            self._eval(expr.test, env, st)
            return _merge(self._eval(expr.body, env, st),
                          self._eval(expr.orelse, env, st))
        if isinstance(expr, ast.Starred):
            return self._eval(expr.value, env, st)
        if isinstance(expr, ast.Await):
            return self._eval(expr.value, env, st)
        return _CLEAN

    def _taint(self, st, node, desc, base=_CLEAN):
        chain = (base[1] or ()) + ((st.rel, node.lineno, desc),)
        return (frozenset(), chain)

    def _eval_call(self, call, env, st):
        args_av = [self._eval(a, env, st) for a in call.args]
        kw_av = {kw.arg: self._eval(kw.value, env, st)
                 for kw in call.keywords if kw.arg is not None}
        name = call_name(call) or ""
        tail = name.rsplit(".", 1)[-1]
        recv = _CLEAN
        if isinstance(call.func, ast.Attribute):
            recv = self._eval(call.func.value, env, st)
            if not tail:
                # method call on a non-name receiver — e.g.
                # (M32.T @ M32).astype(f64) — call_name cannot build a
                # dotted name, but the method itself still decides
                # cast/sanitize semantics
                tail = call.func.attr

        # dtype casts: sanitize or taint
        if tail in ("astype", "to") and (call.args or call.keywords):
            dts = [_dtype_marker(a) for a in call.args] + [
                _dtype_marker(kw.value) for kw in call.keywords
                if kw.arg == "dtype"]
            dt = next((d for d in dts if d is not None), None)
            if dt == "f64":
                return _CLEAN
            if dt == "f32":
                return self._taint(st, call, f"{tail}(float32)", recv)
            return recv
        if (tail in F32_CAST_METHODS and isinstance(call.func,
                                                    ast.Attribute)
                and not call.args and not call.keywords):
            return self._taint(st, call, f".{tail}()", recv)
        if tail in _DTYPE_CTORS:
            dt = None
            for kw in call.keywords:
                if kw.arg == "dtype":
                    dt = _dtype_marker(kw.value)
            if dt == "f64":
                return _CLEAN
            merged = recv
            for av in args_av:
                merged = _merge(merged, av)
            if dt == "f32":
                return self._taint(st, call, f"{tail}(dtype=float32)",
                                   merged)
            what = default_dtype_factory(call)
            if what is not None:
                return self._taint(st, call, what, merged)
            return merged
        if tail in ("float32", "bfloat16", "float16"):
            merged = _CLEAN
            for av in args_av:
                merged = _merge(merged, av)
            return self._taint(st, call, f"{name or tail}()", merged)
        if tail in ("float64", "double"):
            return _CLEAN

        callee = st.calls.get(id(call))
        if callee is not None:
            return self._resolved_call(call, callee, args_av, kw_av,
                                       st)
        # unresolved: configured f32 sources taint; everything else
        # passes its inputs through (torch.matmul and friends)
        merged = recv
        for av in args_av:
            merged = _merge(merged, av)
        for av in kw_av.values():
            merged = _merge(merged, av)
        if self.src_re is not None and tail \
                and self.src_re.search(tail):
            return self._taint(st, call, f"f32 source {name or tail}()",
                               merged)
        return merged

    def _resolved_call(self, call, callee, args_av, kw_av, st):
        gargs = callee.node.args
        gparams = [a.arg for a in (list(gargs.posonlyargs)
                                   + list(gargs.args))]
        offset = 1 if (callee.cls is not None
                       and isinstance(call.func, ast.Attribute)
                       and gparams[:1] == ["self"]) else 0
        pairs = []
        for i, av in enumerate(args_av):
            idx = i + offset
            if idx < len(gparams):
                pairs.append((gparams[idx], av))
        for kname, av in kw_av.items():
            if kname in gparams:
                pairs.append((kname, av))

        crit = callee.qname in self.critical
        summ = self.summaries.get(callee.qname)
        sinks = dict(summ[1]) if summ is not None else {}

        for pname, av in pairs:
            if av[1] is not None:      # tainted argument
                if crit:
                    self._report(st, call, av[1] + (
                        (st.rel, call.lineno,
                         f"passed to f64-critical {callee.name}()"),))
                elif pname in sinks:
                    self._report(st, call, av[1] + (
                        (st.rel, call.lineno,
                         f"passed to {callee.name}()"),) + sinks[pname])
            if av[0]:                  # caller params flow onward
                if crit:
                    for p in av[0]:
                        st.param_sinks.setdefault(p, (
                            (st.rel, call.lineno,
                             f"passed to f64-critical "
                             f"{callee.name}()"),))
                elif pname in sinks:
                    for p in av[0]:
                        st.param_sinks.setdefault(p, (
                            (st.rel, call.lineno,
                             f"passed to {callee.name}()"),)
                            + sinks[pname])

        result = _CLEAN
        if summ is not None:
            rparams, rchain = summ[0]
            if rchain is not None:
                result = (frozenset(), rchain + (
                    (st.rel, call.lineno,
                     f"returned by {callee.name}()"),))
            for pname, av in pairs:
                if pname in rparams:
                    if av[1] is not None:
                        result = (result[0] | av[0],
                                  result[1] if result[1] is not None
                                  else av[1] + ((st.rel, call.lineno,
                                                 f"through "
                                                 f"{callee.name}()"),))
                    else:
                        result = (result[0] | av[0], result[1])
        if (self.src_re is not None
                and self.src_re.search(callee.name)):
            result = self._taint(st, call,
                                 f"f32 source {callee.name}()", result)
        # a tainted value materializing inside a critical function is
        # itself a contamination, even with no further call
        if (result[1] is not None and st.func.qname in self.critical
                and not self._chain_starts_here(st, result[1])):
            self._report(st, call, result[1] + (
                (st.rel, call.lineno,
                 f"enters f64-critical {st.func.name}()"),))
        return result

    def _chain_starts_here(self, st, chain):
        rel, line, _ = chain[0]
        node = st.func.node
        end = getattr(node, "end_lineno", node.lineno)
        return rel == st.rel and node.lineno <= line <= end

    def _report(self, st, call, chain):
        if not st.report:
            return
        # lexical introduction inside a critical function is
        # f32-in-f64's finding; only cross-function flow is ours
        if (st.func.qname in self.critical
                and self._chain_starts_here(st, chain)):
            return
        key = chain[0]
        if key in st.reported:
            return
        st.reported.add(key)
        steps = " -> ".join(f"{rel}:{line} {desc}"
                            for rel, line, desc in chain)
        st.ctx.report(
            self.id, call.lineno,
            f"f32 value reaches an f64-critical sink: {steps}")
