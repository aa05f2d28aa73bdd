"""Retrace / sync-hazard rule family.

- host-sync-in-jit: a host sync inside device code. A fit program is
  captured into CUDA graphs on the card: its host code runs once, at
  capture, so a ``.item()`` there either raises (a host read is
  illegal while a stream captures) or bakes one batch's value into
  every replay.
- static-unhashable: an unhashable value or a tensor in a program key
  (``self._fns[...]``, ``ExecutableCache`` keys, ``lru_cache``
  arguments): the key raises, or hashes by identity and the program is
  captured again on every call.
- serve-unpadded-batch: PTABatch built in the serve path without
  pad_toas= (shape drift defeats the ExecutableCache).

*Device code* is a function passed to ``graphs.Program``,
``graphs.GraphProgram``, ``fitter.aot_backend_compile``, a
``torch.func`` transform (``vmap``, ``jacfwd``, ``jacrev``, ``grad``,
``hessian``, ``functional_call``) or ``autodiff.jacfwd``, or stored in
a program table (``self._fns[key] = f``, ``self._fns.setdefault(key,
f)``); with it, every local function such a function calls. The index
follows a function through the file: a parameter that reaches a
wrapper (``_dispatch``'s ``fit``) makes every argument given for it
device code, and a tuple a builder returns (``key, fit =
self._build_gls(...)``) hands the matching element on. The arguments
of ``graphs.eager(fn, ...)`` and the body of ``fn`` are the sanctioned
escape from a graph and are never device code.
"""

from __future__ import annotations

import ast

from .config import (EAGER_CALLS, HOST_SYNC_CALLS, HOST_SYNC_METHODS,
                     PROGRAM_TABLE_ATTRS, TRACING_WRAPPERS)
from .core import Rule, call_name, dotted_name, register


def _tail(name):
    return name.rsplit(".", 1)[-1] if name else None


_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPES = _FUNCS + (ast.Lambda, ast.ClassDef)


def _is_eager(call):
    return (isinstance(call, ast.Call)
            and (call_name(call) in EAGER_CALLS
                 or _tail(call_name(call)) in EAGER_CALLS))


def _table_root(node):
    """True for ``self._fns`` (a program table attribute)."""
    return (isinstance(node, ast.Attribute)
            and node.attr in PROGRAM_TABLE_ATTRS)


def _local_names(scope):
    """Parameters and names bound by assignment directly in ``scope``."""
    out = set()
    if isinstance(scope, _FUNCS + (ast.Lambda,)):
        args = scope.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            out.add(a.arg)
        for a in (args.vararg, args.kwarg):
            if a is not None:
                out.add(a.arg)
    body = scope.body if isinstance(scope.body, list) else []
    for node in _walk_own(body):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _walk_own(stmts):
    """Every node of ``stmts`` outside nested function/class bodies."""
    work = list(stmts)
    while work:
        node = work.pop()
        yield node
        if isinstance(node, _SCOPES):
            continue
        work.extend(ast.iter_child_nodes(node))


class TracedIndex:
    """Scope-aware index of device code in one file.

    Resolution follows Python's scoping: a function sees its own names,
    then those of the enclosing functions and the module. A class body
    is not an enclosing scope of its methods, so a method never
    resolves a bare name to another method (``PTAFleet.fit`` is not the
    ``fit`` closure a builder returns), and a name bound locally
    shadows a function of the same name further out. ``self.m`` from a
    method resolves to the method ``m`` of its class."""

    def __init__(self, tree):
        self.tree = tree
        self._scope_of = {id(tree): None}
        self._node = {id(tree): tree}
        self._defs = {}  # (id(scope), name) -> def node
        self._locals = {}  # id(scope) -> names bound there
        self._calls = []  # every call of the file
        self._index(tree, tree)
        self._device = {}  # id(def or lambda) -> node
        self._bindings = set()  # (id(scope), name) of g = Program(f)
        self._eager = set()  # id(def) given to graphs.eager
        self._done = set()
        self._work = []
        self._mark()

    # -- scopes --------------------------------------------------------

    def _index(self, node, scope):
        for child in ast.iter_child_nodes(node):
            self._scope_of[id(child)] = scope
            self._node[id(child)] = child
            if isinstance(child, _FUNCS):
                self._defs[(id(scope), child.name)] = child
            if isinstance(child, _SCOPES):
                self._index(child, child)
            else:
                self._index(child, scope)
            if isinstance(child, ast.Call):
                self._calls.append(child)

    def _locals_of(self, scope):
        names = self._locals.get(id(scope))
        if names is None:
            names = self._locals[id(scope)] = (
                _local_names(scope) if scope is not self.tree else set())
        return names

    def _resolve(self, scope, name):
        """The def ``name`` names in ``scope``, or None (unknown, or
        shadowed by a local binding that is not a def)."""
        first = True
        while scope is not None:
            if first or not isinstance(scope, ast.ClassDef):
                found = self._defs.get((id(scope), name))
                if found is not None:
                    return found
                if scope is not self.tree and name in self._locals_of(
                        scope):
                    return None
            first = False
            scope = self._scope_of.get(id(scope))
        return None

    def _binding_scope(self, scope, name):
        """The function scope where ``name`` is a parameter or a local
        (class bodies skipped), or None."""
        while scope is not None and scope is not self.tree:
            if not isinstance(scope, ast.ClassDef) and \
                    name in self._locals_of(scope):
                return scope
            scope = self._scope_of.get(id(scope))
        return None

    def _class_of(self, scope):
        """The class whose method (innermost enclosing) ``scope`` is."""
        while scope is not None:
            parent = self._scope_of.get(id(scope))
            if isinstance(parent, ast.ClassDef) and isinstance(scope,
                                                               _FUNCS):
                return parent
            scope = parent
        return None

    def _callee(self, call, scope):
        """The local def a call invokes: a bare name resolved
        lexically, or ``self.m`` in a method of the class defining m."""
        func = call.func
        if isinstance(func, ast.Name):
            return self._resolve(scope, func.id)
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in ("self", "cls")):
            cls = self._class_of(scope)
            if cls is not None:
                found = self._defs.get((id(cls), func.attr))
                if isinstance(found, _FUNCS):
                    return found
        return None

    # -- marking -------------------------------------------------------

    def _push(self, *item):
        if item not in self._done:
            self._done.add(item)
            self._work.append(item)

    def _mark_def(self, node):
        if id(node) not in self._device:
            self._device[id(node)] = node
            self._push("body", id(node))

    def _harvest(self, expr, scope, want=None, via_call=False):
        """Mark the functions ``expr`` evaluates to as device code.
        ``want`` picks one element of a tuple value; ``via_call`` (an
        argument of an ordinary call) follows only names of defs."""
        if isinstance(expr, ast.Lambda):
            self._mark_def(expr)
        elif isinstance(expr, ast.Name):
            found = self._resolve(scope, expr.id)
            if found is not None:
                if want is None:
                    self._mark_def(found)
                return
            if via_call:
                return
            where = self._binding_scope(scope, expr.id)
            if where is not None:
                self._push("name", id(where), expr.id, want)
        elif isinstance(expr, (ast.Tuple, ast.List)):
            if want is None:
                for elt in expr.elts:
                    self._harvest(elt, scope, None, via_call)
            elif want < len(expr.elts):
                self._harvest(expr.elts[want], scope, None, via_call)
        elif isinstance(expr, ast.IfExp):
            self._harvest(expr.body, scope, want, via_call)
            self._harvest(expr.orelse, scope, want, via_call)
        elif isinstance(expr, ast.Call):
            if _is_eager(expr):
                return
            if _tail(call_name(expr)) in TRACING_WRAPPERS | {"partial"}:
                if expr.args:
                    self._harvest(expr.args[0], scope)
                return
            if want is None:
                for arg in expr.args:
                    if isinstance(arg, (ast.Name, ast.Lambda)):
                        self._harvest(arg, scope, None, True)
            callee = self._callee(expr, scope)
            if callee is not None:
                self._push("return", id(callee), want)

    def _mark(self):
        for node in ast.walk(self.tree):
            scope = self._scope_of.get(id(node))
            if isinstance(node, ast.Call):
                tail = _tail(call_name(node))
                if _is_eager(node) and node.args:
                    fn = node.args[0]
                    if isinstance(fn, ast.Name):
                        found = self._resolve(scope, fn.id)
                        if found is not None:
                            self._eager.add(id(found))
                elif tail in TRACING_WRAPPERS and node.args:
                    self._harvest(node.args[0], scope)
                elif (tail == "setdefault"
                        and isinstance(node.func, ast.Attribute)
                        and _table_root(node.func.value)
                        and len(node.args) >= 2):
                    self._harvest(node.args[1], scope)
            elif isinstance(node, ast.Assign):
                if any(isinstance(t, ast.Subscript) and _table_root(t.value)
                       for t in node.targets):
                    self._harvest(node.value, scope)
                value = node.value
                if isinstance(value, ast.Subscript):
                    value = value.value  # aot_backend_compile(..)["compiled"]
                if isinstance(value, ast.Call) and \
                        _tail(call_name(value)) in TRACING_WRAPPERS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self._bindings.add((id(scope), t.id))
            elif isinstance(node, _FUNCS):
                for dec in node.decorator_list:
                    name = (call_name(dec) if isinstance(dec, ast.Call)
                            else dotted_name(dec))
                    if _tail(name) in TRACING_WRAPPERS:
                        self._mark_def(node)
        while self._work:
            self._step(self._work.pop())

    def _step(self, item):
        kind = item[0]
        if kind == "body":
            self._calls_from(self._node[item[1]])
        elif kind == "return":
            func = self._node[item[1]]
            for node in _walk_own(func.body):
                if isinstance(node, ast.Return) and node.value is not None:
                    self._harvest(node.value, func, item[2])
        elif kind == "name":
            self._bound_values(self._node[item[1]], item[2], item[3])

    def _bound_values(self, scope, name, want):
        """Harvest what ``name`` is bound to in ``scope``: a parameter
        takes every argument given for it at the function's call sites
        in this file; a local takes its assigned values."""
        args = getattr(scope, "args", None)
        params = ([a.arg for a in list(args.posonlyargs) + list(args.args)]
                  if args is not None else [])
        if name in params or (args is not None and name in
                              {a.arg for a in args.kwonlyargs}):
            self._arguments_for(scope, name, params, want)
            return
        body = scope.body if isinstance(scope.body, list) else []
        for node in _walk_own(body):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    self._harvest(node.value, scope, want)
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    for i, elt in enumerate(tgt.elts):
                        if isinstance(elt, ast.Name) and elt.id == name:
                            self._harvest(node.value, scope,
                                          i if want is None else None)

    def _arguments_for(self, func, name, params, want):
        if not isinstance(func, _FUNCS):
            return
        for node in self._calls:
            scope = self._scope_of.get(id(node))
            if self._callee(node, scope) is not func:
                continue
            offset = 1 if (isinstance(node.func, ast.Attribute)
                           and params[:1] in (["self"], ["cls"])) else 0
            for kw in node.keywords:
                if kw.arg == name:
                    self._harvest(kw.value, scope, want)
            if name in params:
                idx = params.index(name) - offset
                if 0 <= idx < len(node.args) and not any(
                        isinstance(a, ast.Starred)
                        for a in node.args[:idx + 1]):
                    self._harvest(node.args[idx], scope, want)

    def _calls_from(self, func):
        """Local functions a device function calls run in its program."""
        for node in device_nodes(func):
            if isinstance(node, ast.Call):
                scope = self._scope_of.get(id(node))
                if isinstance(node.func, ast.Name):
                    self._harvest(node.func, scope)
                else:
                    callee = self._callee(node, scope)
                    if callee is not None:
                        self._mark_def(callee)

    # -- queries -------------------------------------------------------

    def device_defs(self):
        """The device functions and lambdas, in source order."""
        return sorted((n for i, n in self._device.items()
                       if i not in self._eager),
                      key=lambda n: (n.lineno, n.col_offset))

    def is_traced_def(self, func):
        return id(func) in self._device and id(func) not in self._eager

    def is_traced_name(self, name, at_node):
        """True when ``name`` called at ``at_node`` lexically resolves
        to a device function or a ``g = GraphProgram(f)`` binding."""
        if not name or "." in name:
            return False
        scope = self._scope_of.get(id(at_node))
        probe = scope
        while probe is not None:
            if (id(probe), name) in self._bindings:
                return True
            probe = self._scope_of.get(id(probe))
        found = self._resolve(scope, name)
        return found is not None and self.is_traced_def(found)

    def __bool__(self):
        return bool(self._device) or bool(self._bindings)


def traced_index(tree):
    """The file's :class:`TracedIndex`, built once per parsed tree (the
    retrace, bench and signature rules all read it)."""
    idx = getattr(tree, "_pintlint_traced", None)
    if idx is None:
        idx = tree._pintlint_traced = TracedIndex(tree)
    return idx


def device_nodes(func):
    """Every node of a device function's body outside the arguments of
    ``graphs.eager`` calls."""
    work = [func]
    while work:
        node = work.pop()
        yield node
        if not _is_eager(node):
            work.extend(ast.iter_child_nodes(node))


def device_code_index(paths):
    """{absolute path: [(first line, last line, name)]} of the device
    functions of the Python files under ``paths`` — the static model of
    what runs inside a captured program, which chip_smoke.py holds
    against the syncs the card reports."""
    import os

    from .core import iter_py_files

    out = {}
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        spans = [(n.lineno, n.end_lineno, getattr(n, "name", "<lambda>"))
                 for n in TracedIndex(tree).device_defs()]
        if spans:
            out[os.path.abspath(path)] = spans
    return out


def host_sync(node):
    """A description of the host sync ``node`` calls, or None."""
    if not isinstance(node, ast.Call):
        return None
    name = call_name(node)
    if name in HOST_SYNC_CALLS or (name or "").startswith("time."):
        return name
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in HOST_SYNC_METHODS):
        return f".{node.func.attr}()"
    return None


@register
class HostSyncInJitRule(Rule):
    """A ``float()`` / ``.item()`` / ``.cpu()`` / ``torch.nonzero`` /
    ``time.*`` call inside device code either raises at capture (a host
    read is illegal while a stream captures) or — worse — runs once at
    capture and bakes one batch's value into every replay of the graph.
    Host conversions belong in the finalize half of the
    dispatch/finalize split (``PTABatch._pull``); a factorization whose
    status ATen reads on the host goes through ``graphs.eager``."""

    id = "host-sync-in-jit"
    family = "retrace"
    rationale = ("host syncs inside device code either fail at capture "
                 "or freeze capture-time values into every replay")

    def check_file(self, ctx):
        traced = traced_index(ctx.tree)
        if not traced:
            return
        seen = set()
        for func in traced.device_defs():
            fname = getattr(func, "name", "<lambda>")
            for node in device_nodes(func):
                bad = host_sync(node)
                if bad is None:
                    continue
                key = (node.lineno, node.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                ctx.report(
                    self.id, node,
                    f"host-sync call {bad} inside device function "
                    f"'{fname}'; move it to the finalize half of the "
                    f"dispatch/finalize split, or run it through "
                    f"graphs.eager")


_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
               ast.SetComp)
# calls whose result is hashable whatever their arguments
_HASHABLE_CALLS = frozenset({"tuple", "frozenset", "str", "repr", "len",
                             "hash", "int", "float", "bool", "id"})
_CACHE_KEY_METHODS = frozenset({"lookup", "insert", "stage"})


def _memoizer(node):
    """True for ``functools.lru_cache`` / ``functools.cache`` (called
    with its options or not)."""
    name = (call_name(node) if isinstance(node, ast.Call)
            else dotted_name(node))
    return _tail(name) in ("lru_cache", "cache")


def _bad_key_parts(expr):
    """Unhashable literals and torch calls inside a key expression."""
    work = [expr]
    while work:
        node = work.pop()
        if isinstance(node, _UNHASHABLE):
            yield node, "an unhashable literal"
            continue
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if name.startswith("torch."):
                yield node, f"a tensor ({name})"
                continue
            if name in _HASHABLE_CALLS:
                continue
        work.extend(ast.iter_child_nodes(node))


@register
class StaticUnhashableRule(Rule):
    """A program key must hash by value: a list/dict/set in a key
    raises at the lookup, and a tensor hashes by identity, so a key
    holding one misses on every call and captures the program again
    (the zero-recapture contract gone). Checked: the keys of
    ``self._fns[...]`` / ``self._fns.setdefault`` (and the local
    ``key = ...`` feeding them), ``ExecutableCache`` keys
    (``cache.lookup/insert/stage``) and the arguments of a
    ``functools.lru_cache`` function."""

    id = "static-unhashable"
    family = "retrace"
    rationale = ("unhashable values or tensors in a program key fail "
                 "at the lookup or capture again on every call")

    def check_file(self, ctx):
        cached = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, _FUNCS):
                if any(_memoizer(dec) for dec in node.decorator_list):
                    cached.add(node.name)
            elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                             ast.Call):
                # f = functools.lru_cache(f), f = lru_cache(maxsize=8)(f)
                if _memoizer(node.value.func) or _memoizer(node.value):
                    cached.update(t.id for t in node.targets
                                  if isinstance(t, ast.Name))
        seen = set()
        for func in [ctx.tree] + [n for n in ast.walk(ctx.tree)
                                  if isinstance(n, _FUNCS)]:
            for expr, where in self._keys(func, cached):
                for bad, what in _bad_key_parts(expr):
                    key = (bad.lineno, bad.col_offset)
                    if key in seen:
                        continue
                    seen.add(key)
                    ctx.report(
                        self.id, bad,
                        f"{what} in {where}: a program key must hash "
                        f"by value (use a tuple of Python scalars, a "
                        f"shape or a dtype)")

    @staticmethod
    def _keys(func, cached):
        body = func.body if isinstance(func.body, list) else []
        nodes = list(_walk_own(body))
        keys, names = [], set()
        for node in nodes:
            if isinstance(node, ast.Subscript) and _table_root(node.value):
                keys.append((node.slice, "a program-table key"))
                if isinstance(node.slice, ast.Name):
                    names.add(node.slice.id)
            elif isinstance(node, ast.Call):
                func_ = node.func
                tail = _tail(call_name(node))
                if (isinstance(func_, ast.Attribute) and node.args
                        and _table_root(func_.value)
                        and func_.attr in ("setdefault", "get", "pop")):
                    keys.append((node.args[0], "a program-table key"))
                    if isinstance(node.args[0], ast.Name):
                        names.add(node.args[0].id)
                elif (isinstance(func_, ast.Attribute) and node.args
                        and func_.attr in _CACHE_KEY_METHODS
                        and "cache" in (dotted_name(func_.value)
                                        or "").lower()):
                    keys.append((node.args[0], "an ExecutableCache key"))
                    if isinstance(node.args[0], ast.Name):
                        names.add(node.args[0].id)
                elif tail in cached and isinstance(func_, ast.Name):
                    for arg in list(node.args) + [kw.value for kw in
                                                  node.keywords]:
                        keys.append((arg, f"an argument of lru_cache'd "
                                          f"'{tail}'"))
        for node in nodes:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id in names:
                        keys.append((node.value, "a program key"))
        return keys


@register
class ServeUnpaddedBatchRule(Rule):
    """The serve path's zero-recompile contract requires every flush
    of a slot to present identical shapes: PTABatch built without
    ``pad_toas=`` pads to the batch's own max TOA count, so each new
    TOA-count mixture compiles a fresh executable and the
    ExecutableCache can never hit. Deliberate exceptions (the oversize
    spill path) must carry a justified suppression."""

    id = "serve-unpadded-batch"
    family = "retrace"
    rationale = ("an unpadded PTABatch in the serve path drifts the "
                 "shape signature and defeats the ExecutableCache")

    def check_file(self, ctx):
        path = ctx.path.replace("\\", "/")
        if not any(mod in path for mod in ctx.config.serve_pad_modules):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            tail = name.rsplit(".", 1)[-1] if name else None
            if tail != "PTABatch":
                continue
            if not any(kw.arg == "pad_toas" for kw in node.keywords):
                ctx.report(
                    self.id, node,
                    "PTABatch built in the serve path without "
                    "pad_toas=: shapes drift per flush and the "
                    "ExecutableCache zero-recompile contract breaks")
