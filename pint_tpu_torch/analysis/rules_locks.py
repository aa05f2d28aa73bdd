"""Lock-discipline rule family.

- lock-discipline: mutations of registered shared state outside
  ``with self._lock:`` (classes) / ``with <LOCK>:`` (module globals).
- locked-helper-call: a ``*_locked`` helper invoked without the lock.

Model (documented limits):
the rule sees DIRECT mutations — ``self.x = ...``, ``self.x += ...``,
``self.x[k] = ...``, ``self.x.append(...)`` and friends. A mutation
through a local alias (``e = self._keys[k]; e["n"] += 1``) is invisible
statically, which is exactly why helpers that mutate through aliases
must follow the ``*_locked`` naming convention: the alias mutation is
then guarded at every call site, which IS checkable."""

from __future__ import annotations

import ast

from .core import (MUTATOR_METHODS, Rule, name_root, register,
                   self_attr_root)

_EXEMPT_METHODS = frozenset({"__init__", "__new__", "__repr__",
                             "__str__", "__len__"})


def _with_lock_spans(func, is_lock_expr):
    """(start, end) line spans of ``with <lock>:`` blocks in func."""
    spans = []
    for node in ast.walk(func):
        if isinstance(node, ast.With):
            for item in node.items:
                if is_lock_expr(item.context_expr):
                    spans.append((node.lineno, node.end_lineno))
                    break
    return spans


def _in_spans(line, spans):
    return any(a <= line <= b for a, b in spans)


def _self_lock_matcher(lock_attr):
    def match(expr):
        return (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and expr.attr == lock_attr)
    return match


def _name_lock_matcher(lock_name):
    def match(expr):
        return isinstance(expr, ast.Name) and expr.id == lock_name
    return match


def _iter_mutations(scope):
    """Yield (node, target_expr) for direct mutations in ``scope``:
    assignments, augmented assigns, deletes, and mutator-method calls.
    The target_expr is the mutated container/attribute expression."""
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for sub in _split_target(t):
                    yield node, sub
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(node, ast.AnnAssign) and node.value is None:
                continue
            yield node, node.target
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                yield node, t
        elif isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in MUTATOR_METHODS):
                yield node, node.func.value


def _split_target(t):
    if isinstance(t, (ast.Tuple, ast.List)):
        for el in t.elts:
            yield from _split_target(el)
    else:
        yield t


def _thread_local_attrs(cls):
    """Attrs assigned ``threading.local()`` anywhere in the class:
    per-thread state is the canonical LOCK-FREE pattern, so mutations
    through such an attribute need no lock."""
    out = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if not (isinstance(v, ast.Call)
                and isinstance(v.func, ast.Attribute)
                and v.func.attr == "local"):
            continue
        for t in node.targets:
            attr = self_attr_root(t)
            if attr is not None:
                out.add(attr)
    return out


@register
class LockDisciplineRule(Rule):
    """The serve engine, the pipelined fleet executor, and concurrent
    prewarm all share these objects across threads; an unsynchronized
    ``self.hits += 1`` is a lost update and an unsynchronized
    OrderedDict mutation can corrupt the container. Every direct
    mutation of a registered class's monitored attributes (or of a
    registered module-level cache) must execute under its lock."""

    id = "lock-discipline"
    family = "locks"
    rationale = ("registered shared state mutated outside 'with "
                 "self._lock:' races the serve/fleet thread pools")

    def check_file(self, ctx):
        cfg = ctx.config
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and \
                    node.name in cfg.locked_classes:
                self._check_class(ctx, node,
                                  cfg.locked_classes[node.name])
        if cfg.locked_globals:
            self._check_globals(ctx)

    def _check_class(self, ctx, cls, spec):
        lock_attr = spec.get("lock", "_lock")
        monitored = spec.get("attrs")
        is_lock = _self_lock_matcher(lock_attr)
        thread_local = _thread_local_attrs(cls)
        for func in cls.body:
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if func.name in _EXEMPT_METHODS or \
                    func.name.endswith("_locked"):
                continue
            spans = _with_lock_spans(func, is_lock)
            for node, target in _iter_mutations(func):
                attr = self_attr_root(target)
                if attr is None or attr == lock_attr:
                    continue
                if attr in ctx.config.locked_class_exempt_attrs:
                    continue
                if attr in thread_local:
                    continue
                if monitored is not None and attr not in monitored:
                    continue
                if not _in_spans(node.lineno, spans):
                    ctx.report(
                        self.id, node,
                        f"'{cls.name}.{func.name}' mutates shared "
                        f"attribute 'self.{attr}' outside 'with "
                        f"self.{lock_attr}:'")

    def _check_globals(self, ctx):
        cfg = ctx.config
        # only fire in files that actually define the registered global
        defined = set()
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            t.id in cfg.locked_globals:
                        defined.add(t.id)
        if not defined:
            return
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for node, target in _iter_mutations(func):
                root = name_root(target)
                if root not in defined:
                    continue
                lock_name = cfg.locked_globals[root]
                spans = _with_lock_spans(func,
                                         _name_lock_matcher(lock_name))
                if not _in_spans(node.lineno, spans):
                    ctx.report(
                        self.id, node,
                        f"module-level shared cache '{root}' mutated "
                        f"outside 'with {lock_name}:'")


@register
class LockedHelperCallRule(Rule):
    """``*_locked`` helpers mutate shared state through local aliases
    the static mutation scan cannot follow; the convention's other
    half is that every call site must already hold the lock. This rule
    checks that half: a ``self.<x>_locked(...)`` call outside ``with
    self._lock:`` (from a non-``_locked`` method) is a violation."""

    id = "locked-helper-call"
    family = "locks"
    rationale = ("a *_locked helper called without holding the lock "
                 "voids the convention that makes alias mutations safe")

    def check_file(self, ctx):
        cfg = ctx.config
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and \
                    node.name in cfg.locked_classes:
                self._check_class(ctx, node,
                                  cfg.locked_classes[node.name])

    def _check_class(self, ctx, cls, spec):
        lock_attr = spec.get("lock", "_lock")
        is_lock = _self_lock_matcher(lock_attr)
        for func in cls.body:
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if func.name.endswith("_locked"):
                continue  # helpers may chain; call sites are guarded
            spans = _with_lock_spans(func, is_lock)
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "self"
                        and f.attr.endswith("_locked")
                        and not _in_spans(node.lineno, spans)):
                    ctx.report(
                        self.id, node,
                        f"'{cls.name}.{func.name}' calls "
                        f"'self.{f.attr}()' without holding "
                        f"'self.{lock_attr}'")
