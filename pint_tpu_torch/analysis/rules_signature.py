"""signature-incomplete: what a captured program reads must be its key
or its arguments.

A fit program in a class's program table (``self._fns``) is shared:
the serve engine's executable cache hands a program built on one batch
to every batch of the same key, which ``PTABatch.shape_signature()``
(every tensor's shape and dtype) and ``ShapePlan.signature()`` (the
bucket geometry) make up with the structure key. So a program must
compute on the data it is called with (``fit(x0, *self._leaves())``),
and two things are findings, per class registered in
``SIGNATURE_CLASSES``:

- a ``self.X`` read inside a captured closure (device code, as
  ``rules_retrace.TracedIndex`` finds it, transitively through
  ``self.m()`` helpers) unless X is in the program key (the
  ``self._fns[key]`` expression and the local ``key = ...`` feeding
  it) or exempt host-only metadata. The signature does not cover such
  a read: a CUDA graph replays the tensor it was captured on, so a
  program built on one batch and replayed for another fits the first
  batch's data under the second's key (a closed fault of the serve
  engine's program tables);
- a runtime argument at a ``self._fns[...](...)`` dispatch whose
  ``self.X`` the signature method (transitively through ``self.m()``)
  does not fingerprint. ``*self.m()`` passes the method's value: its
  own reads are what the signature must cover (``_leaves()`` returns
  the params, prep and TOA fields ``shape_signature`` walks).
"""

from __future__ import annotations

import ast

from .core import Rule, register, self_attr_root
from .rules_retrace import traced_index


def _self_attr(node):
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


@register
class SignatureCompletenessRule(Rule):
    """A shape-affecting attribute passed to a shared program but
    absent from its key can change the program without changing the
    key; a tensor a captured closure reads from ``self`` is the
    building batch's, replayed for every batch of the key."""

    id = "signature-incomplete"
    family = "retrace"
    rationale = ("attr read inside a captured program but missing "
                 "from its key, or a dispatch argument missing from "
                 "the shape signature, serves one batch's program to "
                 "another")
    whole_program = True

    def check_project(self, project, index):
        config = project.config
        if not config.signature_classes:
            return
        for qname in sorted(index.classes):
            cls = index.classes[qname]
            spec = config.signature_classes.get(cls.name)
            if spec is None:
                continue
            self._check_class(index, cls, spec)

    def _check_class(self, index, cls, spec):
        sig_method = cls.find_method(index, spec["signature"])
        if sig_method is None:
            cls.module.ctx.report(
                self.id, cls.node.lineno,
                f"class {cls.name} is registered with signature "
                f"method '{spec['signature']}' but does not define "
                f"it")
            return
        exempt = set(spec.get("exempt", ())) | {"_fns"}
        methods = self._methods(index, cls)
        sig_reads = self._transitive_self_reads(methods, sig_method)
        traced = traced_index(cls.module.ctx.tree)

        for method in self._all_methods(index, cls):
            key_attrs = self._key_attrs(method.node)
            for closure in method.nested.values():
                if not traced.is_traced_def(closure.node):
                    continue
                reads = self._transitive_self_reads(methods, closure)
                for attr in sorted(reads - key_attrs - exempt):
                    line = self._read_line(closure.node, attr)
                    closure.ctx.report(
                        self.id, line,
                        f"captured closure '{closure.name}' in "
                        f"{cls.name}.{method.name} reads self.{attr}, "
                        f"which is not in its program key: a replay "
                        f"reads the building batch's self.{attr}; pass "
                        f"it as an argument (folded into "
                        f"{cls.name}.{spec['signature']}())")
            covered = sig_reads | key_attrs | exempt
            for node, attrs in self._dispatch_args(methods, method.node):
                for attr in sorted(attrs - covered):
                    method.ctx.report(
                        self.id, node.lineno,
                        f"self.{attr} is passed as a runtime argument "
                        f"at a program-table dispatch in "
                        f"{cls.name}.{method.name} but is not folded "
                        f"into {cls.name}.{spec['signature']}()")

    @staticmethod
    def _all_methods(index, cls):
        seen, out = set(), []
        for mro_cls in cls.mro(index):
            for name, method in sorted(mro_cls.methods.items()):
                if name not in seen:
                    seen.add(name)
                    out.append(method)
        return out

    @staticmethod
    def _methods(index, cls):
        methods = {}
        for mro_cls in cls.mro(index):
            for name in mro_cls.methods:
                methods.setdefault(name, mro_cls.methods[name])
        return methods

    def _transitive_self_reads(self, methods, func):
        """self-attr READS in ``func``, following self.m() calls into
        other methods of the class (MRO-wide)."""
        return self._reads_of([func.node], methods, {func.qname})

    @staticmethod
    def _reads_of(nodes, methods, seen):
        reads = set()
        work = list(nodes)
        while work:
            cur = work.pop()
            for sub in ast.walk(cur):
                attr = _self_attr(sub)
                if attr is None:
                    continue
                if attr in methods:
                    callee = methods[attr]
                    if callee.qname not in seen:
                        seen.add(callee.qname)
                        work.append(callee.node)
                    continue
                if isinstance(sub.ctx, ast.Load):
                    reads.add(attr)
        return reads

    @staticmethod
    def _key_attrs(method_node):
        """self attrs participating in program-table keys: subscript
        expressions of ``self._fns[...]`` plus the local ``key = ...``
        assignments feeding them."""
        key_exprs, key_names = [], set()
        for sub in ast.walk(method_node):
            if (isinstance(sub, ast.Subscript)
                    and self_attr_root(sub.value) == "_fns"):
                key_exprs.append(sub.slice)
                if isinstance(sub.slice, ast.Name):
                    key_names.add(sub.slice.id)
        for sub in ast.walk(method_node):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if (isinstance(tgt, ast.Name)
                            and tgt.id in key_names):
                        key_exprs.append(sub.value)
        out = set()
        for expr in key_exprs:
            for sub in ast.walk(expr):
                attr = _self_attr(sub)
                if attr is not None:
                    out.add(attr)
        return out

    def _dispatch_args(self, methods, method_node):
        """[(call node, {self attrs passed as runtime args})] for
        ``self._fns[...](...)`` dispatch sites; ``self.m()`` passes
        what m reads."""
        out = []
        for sub in ast.walk(method_node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Subscript)
                    and self_attr_root(sub.func) == "_fns"):
                continue
            attrs = set()
            for arg in list(sub.args) + [kw.value
                                         for kw in sub.keywords]:
                for inner in ast.walk(arg):
                    attr = _self_attr(inner)
                    if attr is None:
                        continue
                    if attr in methods:
                        attrs |= self._reads_of(
                            [methods[attr].node], methods,
                            {methods[attr].qname})
                    else:
                        attrs.add(attr)
            out.append((sub, attrs))
        return out

    @staticmethod
    def _read_line(closure_node, attr):
        for sub in ast.walk(closure_node):
            if _self_attr(sub) == attr:
                return sub.lineno
        return closure_node.lineno
