"""Kernel-dispatch rule family.

- kernel-silent-fallback: a kernel that did not run, hidden. The
  port's kernel wrappers launch their hand-written kernel on a CUDA
  tensor or raise; there is no fallback to count (the JAX package's
  ``note_pallas_fallback`` has no counterpart), so in a kernel dispatch
  module (``KERNEL_DISPATCH_MODULES``) two shapes are findings:

  - a ``try`` whose body launches a kernel (calls a ``*_cuda``
    wrapper, ``launch_gram``, or a symbol of a library that
    ``kernels/build.py``'s ``load`` returned) with a handler that can
    end without raising (a ``return`` anywhere in it, or a path that
    falls through);
  - a dispatcher that calls both ``X_cuda`` and ``X_plain``/``X_ref``
    where the plain branch can be taken for a CUDA tensor on a test
    other than the tensor's device (``x.device.type == "cpu"``,
    ``not x.is_cuda``), a named module-level size constant
    (``KERNEL_MIN_PHOTONS``, the JAX package's own dispatch) or an
    option the caller spelled (``precision == "f64"``).

  A fleet silently pinned to a plain path looks healthy in every fit
  while its kernels never launch; the launch counters chip_smoke.py
  reads would show it only on the card.
"""

from __future__ import annotations

import ast
import re

from .config import KERNEL_LAUNCH_PATTERN
from .core import Rule, call_name, register

_LOADERS = frozenset({"load", "load_all", "build.load", "build.load_all"})
_CUDA = re.compile(r"^(\w+)_cuda$")
_PLAIN = re.compile(r"^(\w+)_(?:plain|ref)$")
_LAUNCH = re.compile(KERNEL_LAUNCH_PATTERN)


def _tail(name):
    return name.rsplit(".", 1)[-1] if name else ""


def _library_names(func):
    """Names bound in ``func`` to a library from ``load(...)`` or to one
    of its symbols (``fn = lib.sym``, ``fn = getattr(lib, name)``)."""
    libs = set()
    for _ in range(2):  # lib = load(..); fn = lib.sym
        for node in ast.walk(func):
            if not isinstance(node, ast.Assign):
                continue
            if _is_library_value(node.value, libs):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        libs.add(t.id)
    return libs


def _is_library_value(node, libs):
    if isinstance(node, ast.Call):
        if call_name(node) in _LOADERS:
            return True
        if (call_name(node) == "getattr" and node.args
                and _is_library_value(node.args[0], libs)):
            return True
    if isinstance(node, ast.Attribute):
        return _is_library_value(node.value, libs)
    if isinstance(node, ast.Subscript):
        return _is_library_value(node.value, libs)
    return isinstance(node, ast.Name) and node.id in libs


def launches_kernel(node, libs=frozenset()):
    """True when ``node`` contains a call that launches a kernel."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        if _LAUNCH.search(_tail(call_name(sub))) or _is_library_value(
                sub.func, libs):
            return True
    return False


def _always_raises(stmts):
    """True when every path through ``stmts`` ends in ``raise``."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Raise):
        return True
    return (isinstance(last, ast.If) and _always_raises(last.body)
            and _always_raises(last.orelse))


def _reraises(handler):
    """Every path out of the handler raises: it ends in ``raise`` on each
    branch and returns nowhere (``if oom: raise`` followed by a plain
    return is a fallback)."""
    return _always_raises(handler.body) and not any(
        isinstance(sub, ast.Return) for sub in ast.walk(handler))


def _module_constants(tree):
    """UPPER_CASE names bound at module level."""
    out = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        for t in targets:
            if isinstance(t, ast.Name) and t.id.isupper():
                out.add(t.id)
    return out


def _atoms(test):
    """The leaf conditions of a boolean test."""
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            yield from _atoms(v)
    elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        yield from _atoms(test.operand)
    else:
        yield test


def _device_test(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("is_cuda",
                                                           "device"):
            return True
    return False


def _sanctioned(atom, constants, params):
    """A device test, a comparison with a named module-level constant,
    or a parameter compared with a string option."""
    if _device_test(atom):
        return True
    if not isinstance(atom, ast.Compare):
        return False
    sides = [atom.left] + list(atom.comparators)
    if any(isinstance(s, ast.Name) and s.id in constants for s in sides):
        return True
    return (any(isinstance(s, ast.Name) and s.id in params for s in sides)
            and any(isinstance(s, ast.Constant) and isinstance(s.value, str)
                    for s in sides))


def _exits(stmts):
    """True when ``stmts`` cannot fall through: they end in a return or
    a raise, an if whose branches both exit, or a try whose body and
    handlers all exit."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise)):
        return True
    if isinstance(last, ast.If):
        return _exits(last.body) and _exits(last.orelse)
    if isinstance(last, ast.Try):
        return ((_exits(last.body) or _exits(last.orelse))
                and all(_exits(h.body) for h in last.handlers))
    return False


def _guarded_calls(stmts, tests, out):
    """(call, [tests on its path]) for every call in ``stmts``: the tests
    of the enclosing ifs and of the earlier ifs whose taken branch
    returns. Calls inside except handlers are the try shape's."""
    prior = []
    for s in stmts:
        here = tests + prior
        if isinstance(s, ast.If):
            _guarded_expr(s.test, here, out)
            _guarded_calls(s.body, here + [s.test], out)
            _guarded_calls(s.orelse, here + [s.test], out)
            if _exits(s.body) or _exits(s.orelse):
                prior.append(s.test)
        elif isinstance(s, ast.Try):
            _guarded_calls(s.body, here, out)
            _guarded_calls(s.orelse, here, out)
            _guarded_calls(s.finalbody, here, out)
        elif isinstance(s, (ast.For, ast.AsyncFor, ast.While, ast.With,
                            ast.AsyncWith)):
            for field in ("iter", "test"):
                if getattr(s, field, None) is not None:
                    _guarded_expr(getattr(s, field), here, out)
            for item in getattr(s, "items", ()):
                _guarded_expr(item.context_expr, here, out)
            _guarded_calls(s.body, here, out)
            _guarded_calls(getattr(s, "orelse", []), here, out)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            continue
        else:
            _guarded_expr(s, here, out)


def _guarded_expr(node, tests, out):
    if isinstance(node, ast.IfExp):
        _guarded_expr(node.test, tests, out)
        _guarded_expr(node.body, tests + [node.test], out)
        _guarded_expr(node.orelse, tests + [node.test], out)
        return
    if isinstance(node, ast.Call):
        out.append((node, tests))
    for child in ast.iter_child_nodes(node):
        _guarded_expr(child, tests, out)


@register
class KernelSilentFallbackRule(Rule):
    id = "kernel-silent-fallback"
    family = "kernels"
    rationale = ("a kernel wrapper given a CUDA tensor launches or "
                 "raises: a swallowed launch failure or a plain branch "
                 "a CUDA tensor can take hides a kernel that never ran")

    def _applies(self, ctx):
        rel = "/" + ctx.rel.replace("\\", "/")
        markers = getattr(ctx.config, "kernel_dispatch_modules", ())
        return any(m in rel for m in markers)

    def check_file(self, ctx):
        if not self._applies(ctx):
            return
        constants = _module_constants(ctx.tree)
        for func in ast.walk(ctx.tree):
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not self._check_tries(ctx, func):
                    self._check_dispatch(ctx, func, constants)

    def _check_tries(self, ctx, func):
        """Report handlers around a launch that do not re-raise; True
        when one was reported (its plain fall-through is the same
        fault, so the dispatch shape is not checked again)."""
        libs = _library_names(func)
        found = False
        for node in ast.walk(func):
            if not isinstance(node, ast.Try):
                continue
            if not any(launches_kernel(stmt, libs)
                       for stmt in node.body):
                continue
            for handler in node.handlers:
                if not _reraises(handler):
                    found = True
                    ctx.report(
                        self.id, handler,
                        "exception handler around a kernel launch "
                        "swallows the failure: a wrapper given a CUDA "
                        "tensor launches its kernel or raises (the "
                        "port has no fallback), so re-raise")
        return found

    def _check_dispatch(self, ctx, func, constants):
        calls = []
        _guarded_calls(func.body, [], calls)
        cuda = {m.group(1) for c, _ in calls
                if (m := _CUDA.match(_tail(call_name(c))))}
        if not cuda:
            return
        args = func.args
        params = {a.arg for a in (list(args.posonlyargs) + list(args.args)
                                  + list(args.kwonlyargs))}
        for call, tests in calls:
            m = _PLAIN.match(_tail(call_name(call)))
            if m is None or m.group(1) not in cuda:
                continue
            atoms = [a for t in tests for a in _atoms(t)]
            if atoms and all(_sanctioned(a, constants, params)
                             for a in atoms):
                continue
            ctx.report(
                self.id, call,
                f"{_tail(call_name(call))}() can run for a CUDA tensor "
                f"in a dispatcher of {m.group(1)}_cuda: take the plain "
                f"branch on the tensor's device (or a named size "
                f"constant) only, so a CUDA tensor launches the kernel "
                f"or raises")
