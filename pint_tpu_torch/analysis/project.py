"""pintlint pass 1: the whole-program ``ProjectIndex``.

Per-file AST rules see one module at a time; the interprocedural
rules (lock-order-cycle, precision-flow, signature-incomplete,
registry-drift) need the tree: which class a ``self.batcher`` attribute
holds, which function a ``from .batcher import pow2_bucket`` name binds
to, which locks a class owns, and who calls whom. This module builds
that index once per scan, from the already-parsed ``FileContext``
trees, with no imports executed — everything is derived syntactically,
so the index is safe to build on broken or heavyweight modules alike.

The index is intentionally a *may* analysis tuned for this codebase's
idioms rather than a sound points-to solver: attribute types come from
``self.x = ClassName(...)`` constructor assignments (including the
``x if x is not None else ClassName(...)`` injection idiom), local
variable types from ``v = ClassName(...)`` / ``v = self.attr``, and
calls resolve through imports, class MROs, and lexically enclosing
scopes. Unresolvable calls stay unresolved; the rules built on top
treat them conservatively.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from .core import dotted_name

_LOCK_CTORS = frozenset({"Lock", "RLock"})


def _is_lock_ctor(node):
    """True for ``threading.Lock()`` / ``RLock()`` (any import style)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name is None:
        return False
    return name.split(".")[-1] in _LOCK_CTORS


def _condition_alias(node):
    """``threading.Condition(self._lock)`` -> "_lock"; else None."""
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if name is None or name.split(".")[-1] != "Condition":
        return None
    if (node.args and isinstance(node.args[0], ast.Attribute)
            and isinstance(node.args[0].value, ast.Name)
            and node.args[0].value.id == "self"):
        return node.args[0].attr
    return None


def module_name_for(rel):
    """Dotted module name from a scan-relative path:
    ``serve/engine.py`` -> "serve.engine", ``obs/__init__.py`` ->
    "obs"."""
    rel = rel.replace(os.sep, "/").lstrip("./")
    if rel.endswith(".py"):
        rel = rel[:-3]
    parts = [p for p in rel.split("/") if p]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "__root__"


@dataclass
class FuncInfo:
    """One function or method definition."""

    qname: str                    # "module.Class.method" / "module.f"
    name: str
    node: object                  # ast.FunctionDef / AsyncFunctionDef
    module: "ModuleInfo"
    cls: "ClassInfo" = None       # owning class, when a method
    parent: "FuncInfo" = None     # lexically enclosing function
    nested: dict = field(default_factory=dict)   # name -> FuncInfo

    @property
    def ctx(self):
        return self.module.ctx


@dataclass
class ClassInfo:
    name: str
    qname: str
    node: object
    module: "ModuleInfo"
    base_names: list = field(default_factory=list)   # dotted strings
    methods: dict = field(default_factory=dict)      # name -> FuncInfo
    attr_types: dict = field(default_factory=dict)   # attr -> class NAME
    lock_attrs: set = field(default_factory=set)     # own Lock/RLock attrs
    cond_aliases: dict = field(default_factory=dict)  # cv attr -> lock attr

    def mro(self, index):
        """This class plus resolved base classes, nearest first.
        Cycles and unresolved bases are skipped silently."""
        out, seen, work = [], set(), [self]
        while work:
            cls = work.pop(0)
            if cls.qname in seen:
                continue
            seen.add(cls.qname)
            out.append(cls)
            for base in cls.base_names:
                resolved = index.resolve_class(cls.module, base)
                if resolved is not None:
                    work.append(resolved)
        return out

    def find_method(self, index, name):
        for cls in self.mro(index):
            if name in cls.methods:
                return cls.methods[name]
        return None

    def all_attr_types(self, index):
        out = {}
        for cls in reversed(self.mro(index)):
            out.update(cls.attr_types)
        return out

    def all_lock_attrs(self, index):
        out = {}                   # attr -> owning ClassInfo
        for cls in reversed(self.mro(index)):
            for attr in cls.lock_attrs:
                out[attr] = cls
        return out

    def all_cond_aliases(self, index):
        out = {}
        for cls in reversed(self.mro(index)):
            out.update(cls.cond_aliases)
        return out


@dataclass
class ModuleInfo:
    name: str
    ctx: object                    # FileContext
    imports: dict = field(default_factory=dict)   # local -> dotted target
    functions: dict = field(default_factory=dict)  # name -> FuncInfo
    classes: dict = field(default_factory=dict)    # name -> ClassInfo
    module_locks: set = field(default_factory=set)  # NAME = Lock()
    global_types: dict = field(default_factory=dict)  # NAME -> class


class ProjectIndex:
    """Cross-file symbol table + call graph over one lint scan."""

    def __init__(self, project):
        self.project = project
        self.modules = {}          # dotted name -> ModuleInfo
        self.functions = {}        # qname -> FuncInfo
        self.classes = {}          # qname -> ClassInfo
        self.classes_by_name = {}  # bare name -> [ClassInfo]
        self._call_cache = {}
        self._ret_cache = {}
        self._ret_inflight = set()
        self._locals_inflight = set()
        self._module_lookups = None  # dotted -> ModuleInfo, once indexed
        for ctx in project.files:
            self._index_module(ctx)
        self._module_lookups = {}
        # attr harvesting and the type-inference passes need the full
        # symbol table, so they run after every module is indexed
        for cls in self.classes.values():
            for method in cls.methods.values():
                self._harvest_attrs(cls, method.node)
        self._infer_global_types()
        self._infer_param_attr_types()

    # -- construction --------------------------------------------------

    def _index_module(self, ctx):
        mod = ModuleInfo(name=module_name_for(ctx.rel), ctx=ctx)
        self.modules[mod.name] = mod
        for node in ctx.tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    mod.imports[local] = (alias.name if alias.asname
                                          else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(mod.name, node)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    mod.imports[local] = (base + "." + alias.name
                                          if base else alias.name)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self._index_function(mod, None, None, node)
            elif isinstance(node, ast.ClassDef):
                self._index_class(mod, node)
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Name)
                            and _is_lock_ctor(node.value)):
                        mod.module_locks.add(tgt.id)

    @staticmethod
    def _import_base(modname, node):
        if node.level == 0:
            return node.module or ""
        # relative: level 1 = this file's package, each extra level one
        # package up. A module file's package is its dirname.
        parts = modname.split(".")[:-1]
        up = node.level - 1
        parts = parts[:len(parts) - up] if up else parts
        if node.module:
            parts = parts + node.module.split(".")
        return ".".join(parts)

    def _index_function(self, mod, cls, parent, node):
        prefix = parent.qname if parent else (
            cls.qname if cls else mod.name)
        info = FuncInfo(qname=f"{prefix}.{node.name}", name=node.name,
                        node=node, module=mod, cls=cls, parent=parent)
        self.functions[info.qname] = info
        if parent is not None:
            parent.nested[node.name] = info
        elif cls is not None:
            cls.methods[node.name] = info
        else:
            mod.functions[node.name] = info
        for sub in ast.walk(node):
            if sub is node:
                continue
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if self._encloses(node, sub, stop_at_funcs=True):
                    self._index_function(mod, cls, info, sub)
        return info

    @staticmethod
    def _encloses(outer, target, stop_at_funcs=False):
        """True when ``target`` is a DIRECT nested def of ``outer``
        (not nested inside a deeper function)."""
        for sub in ast.iter_child_nodes(outer):
            stack = [sub]
            while stack:
                n = stack.pop()
                if n is target:
                    return True
                if (stop_at_funcs and n is not sub
                        and isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))):
                    continue
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)) and n is not sub:
                    continue
                stack.extend(ast.iter_child_nodes(n))
        return False

    def _index_class(self, mod, node):
        cls = ClassInfo(name=node.name,
                        qname=f"{mod.name}.{node.name}",
                        node=node, module=mod)
        cls.base_names = [dotted_name(b) for b in node.bases
                          if dotted_name(b)]
        mod.classes[node.name] = cls
        self.classes[cls.qname] = cls
        self.classes_by_name.setdefault(node.name, []).append(cls)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_function(mod, cls, None, item)

    def _harvest_attrs(self, cls, fn_node):
        for sub in ast.walk(fn_node):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                attr = None
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    attr = tgt.attr
                elif isinstance(tgt, ast.Subscript):
                    # self.X[k] = C(...): the container's element type
                    from .core import self_attr_root

                    attr = self_attr_root(tgt)
                if attr is None:
                    continue
                if isinstance(tgt, ast.Attribute):
                    if _is_lock_ctor(sub.value):
                        cls.lock_attrs.add(attr)
                        continue
                    alias = _condition_alias(sub.value)
                    if alias is not None:
                        cls.cond_aliases[attr] = alias
                        continue
                typ = self._ctor_class_name(cls.module, sub.value)
                if typ is not None:
                    cls.attr_types.setdefault(attr, typ)

    def _ctor_class_name(self, mod, value):
        """Bare class name when ``value`` constructs exactly one known
        class — handles ``C(...)``, ``x or C(...)``, ``x if x is not
        None else C(...)``, and container displays/comprehensions of a
        single class (``{p: Histogram() for p in ...}``)."""
        hits = set()
        for sub in ast.walk(value):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted_name(sub.func)
            if name is None:
                continue
            resolved = self.resolve_class(mod, name)
            if resolved is not None:
                hits.add(resolved.name)
        return hits.pop() if len(hits) == 1 else None

    # -- type inference passes -----------------------------------------

    def _infer_global_types(self):
        """Module-level singleton instances (``REGISTRY = Registry()``)
        get a type, so ``metricsreg.REGISTRY.counter(...)`` resolves."""
        for mod in self.modules.values():
            for node in mod.ctx.tree.body:
                if not isinstance(node, ast.Assign):
                    continue
                typ = self._ctor_class_name(mod, node.value)
                if typ is None:
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        mod.global_types.setdefault(tgt.id, typ)

    def _infer_param_attr_types(self):
        """Propagate constructor-argument types into attribute types:
        ``ExecutableCache(cap, persistent=p)`` where ``p`` is a known
        ``PersistentExecutableCache`` gives ``self.persistent =
        persistent`` in __init__ a type. One pass, unique types only."""
        cand = {}
        for qname in sorted(self.functions):
            func = self.functions[qname]
            types = self.local_types(func)
            for call, callee in self.calls_of(func):
                if callee is None:
                    continue
                gargs = callee.node.args
                gparams = [a.arg for a in (list(gargs.posonlyargs)
                                           + list(gargs.args))]
                offset = 1 if gparams[:1] == ["self"] else 0
                pairs = []
                for i, arg in enumerate(call.args):
                    if i + offset < len(gparams):
                        pairs.append((gparams[i + offset], arg))
                for kw in call.keywords:
                    if kw.arg in gparams:
                        pairs.append((kw.arg, kw.value))
                for pname, arg in pairs:
                    typ = self._expr_class(func.module, arg, types,
                                           func)
                    if typ is not None:
                        cand.setdefault(
                            (callee.qname, pname), set()).add(typ)
        for cls in self.classes.values():
            for method in cls.methods.values():
                for sub in ast.walk(method.node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    if not isinstance(sub.value, ast.Name):
                        continue
                    key = (method.qname, sub.value.id)
                    types = cand.get(key)
                    if types is None or len(types) != 1:
                        continue
                    typ = next(iter(types))
                    for tgt in sub.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            cls.attr_types.setdefault(tgt.attr, typ)
        # argument types changed what attribute accesses resolve to —
        # drop call resolutions made with the poorer information
        self._call_cache.clear()

    def _expr_class(self, mod, expr, locals_map=None, func=None,
                    depth=0):
        """Bare class name of ``expr``'s value, or None. Follows
        constructor calls, typed locals/globals/attributes, method
        return types, container subscripts, and injection idioms."""
        if depth > 4:
            return None
        locals_map = locals_map or {}
        if isinstance(expr, ast.Name):
            if expr.id in locals_map:
                return locals_map[expr.id]
            return mod.global_types.get(expr.id)
        if isinstance(expr, ast.Subscript):
            # element of a typed container (attr_types harvested the
            # element class from the display/comprehension)
            return self._expr_class(mod, expr.value, locals_map, func,
                                    depth + 1)
        if isinstance(expr, ast.Attribute):
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                    and func is not None and func.cls is not None):
                return func.cls.all_attr_types(self).get(expr.attr)
            dotted = dotted_name(expr)
            if dotted is not None:
                parts = dotted.split(".")
                head = mod.imports.get(parts[0])
                if head is not None:
                    parts = head.split(".") + parts[1:]
                if len(parts) >= 2:
                    owner = self._lookup_module(".".join(parts[:-1]))
                    if owner is not None:
                        return owner.global_types.get(parts[-1])
            return None
        if isinstance(expr, ast.Call):
            name = dotted_name(expr.func)
            if name is not None:
                found = self._resolve_dotted(mod, name)
                if isinstance(found, ClassInfo):
                    return found.name
                if isinstance(found, FuncInfo):
                    return self.ret_class(found)
                bare = self.resolve_class(mod, name) \
                    if "." not in name else None
                if bare is not None:
                    return bare.name
            if isinstance(expr.func, ast.Attribute):
                recv = self._expr_class(mod, expr.func.value,
                                        locals_map, func, depth + 1)
                if recv is not None:
                    cls = self.resolve_class(mod, recv)
                    if cls is not None:
                        method = cls.find_method(self, expr.func.attr)
                        if method is not None:
                            return self.ret_class(method)
            return None
        if isinstance(expr, (ast.IfExp, ast.BoolOp)):
            branches = (expr.values if isinstance(expr, ast.BoolOp)
                        else [expr.body, expr.orelse])
            hits = set()
            for b in branches:
                typ = self._expr_class(mod, b, locals_map, func,
                                       depth + 1)
                if typ is not None:
                    hits.add(typ)
            return hits.pop() if len(hits) == 1 else None
        return None

    def ret_class(self, func):
        """Bare class name ``func`` returns, when every classable
        return agrees (``Registry.counter`` -> "Counter")."""
        cached = self._ret_cache.get(func.qname, Ellipsis)
        if cached is not Ellipsis:
            return cached
        if func.qname in self._ret_inflight:
            return None
        self._ret_inflight.add(func.qname)
        try:
            types = self.local_types(func)
            hits = set()
            nested = {n.node for n in func.nested.values()}
            stack = list(ast.iter_child_nodes(func.node))
            while stack:
                n = stack.pop()
                if n in nested:
                    continue
                if isinstance(n, ast.Return) and n.value is not None:
                    typ = self._expr_class(func.module, n.value,
                                           types, func)
                    if typ is not None:
                        hits.add(typ)
                stack.extend(ast.iter_child_nodes(n))
            out = hits.pop() if len(hits) == 1 else None
        finally:
            self._ret_inflight.discard(func.qname)
        self._ret_cache[func.qname] = out
        return out

    # -- name resolution -----------------------------------------------

    def _lookup_module(self, dotted):
        if dotted in self.modules:
            return self.modules[dotted]
        memo = self._module_lookups
        if memo is not None and dotted in memo:
            return memo[dotted]
        # scans rooted below the package (rel "serve/engine.py" vs
        # absolute import "pint_tpu.serve.engine") meet on suffixes
        found = None
        for name, mod in self.modules.items():
            if (dotted.endswith("." + name) or name.endswith("." + dotted)):
                found = mod
                break
        if memo is not None:
            memo[dotted] = found
        return found

    def _resolve_dotted(self, mod, dotted):
        """Resolve a dotted name used in ``mod`` to a FuncInfo /
        ClassInfo / ModuleInfo, following one import hop."""
        parts = dotted.split(".")
        head, rest = parts[0], parts[1:]
        target = mod.imports.get(head)
        if target is not None:
            dotted = ".".join([target] + rest)
            parts = dotted.split(".")
        else:
            own = mod.classes.get(head) or mod.functions.get(head)
            if own is not None:            # the module's own namespace
                if not rest:
                    return own
                if isinstance(own, ClassInfo) and len(rest) == 1:
                    return own.find_method(self, rest[0])
                return None
        # longest module prefix, then member lookup
        for cut in range(len(parts), 0, -1):
            owner = self._lookup_module(".".join(parts[:cut]))
            if owner is None:
                continue
            member = parts[cut:]
            if not member:
                return owner
            if len(member) == 1:
                return (owner.functions.get(member[0])
                        or owner.classes.get(member[0]))
            if len(member) == 2 and member[0] in owner.classes:
                return owner.classes[member[0]].find_method(
                    self, member[1])
            return None
        return None

    def resolve_class(self, mod, dotted):
        """ClassInfo for a (possibly dotted) class name used in
        ``mod``; falls back to the unique bare-name match."""
        found = self._resolve_dotted(mod, dotted)
        if isinstance(found, ClassInfo):
            return found
        bare = dotted.split(".")[-1]
        cands = self.classes_by_name.get(bare, ())
        return cands[0] if len(cands) == 1 else None

    # -- call graph ----------------------------------------------------

    def local_types(self, func):
        """{local var -> bare class name} from assignments inside
        ``func``: constructor calls, typed self attrs and globals,
        typed method returns, the injection idioms."""
        if func.qname in self._locals_inflight:
            return {}
        self._locals_inflight.add(func.qname)
        try:
            out = {}
            assigns = [n for n in ast.walk(func.node)
                       if isinstance(n, ast.Assign)]
            assigns.sort(key=lambda n: n.lineno)
            for sub in assigns:
                typ = self._expr_class(func.module, sub.value, out,
                                       func)
                if typ is None:
                    continue
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        out[tgt.id] = typ
            # for-loop element types ride the container heuristic:
            # ``for b in self.batches:`` with batches -> PTABatch
            for sub in ast.walk(func.node):
                if not isinstance(sub, (ast.For, ast.AsyncFor)):
                    continue
                if not isinstance(sub.target, ast.Name):
                    continue
                it = sub.iter
                if (isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Attribute)
                        and it.func.attr in ("values", "items")):
                    it = it.func.value
                typ = self._expr_class(func.module, it, out, func)
                if typ is not None:
                    out.setdefault(sub.target.id, typ)
            return out
        finally:
            self._locals_inflight.discard(func.qname)

    def resolve_call(self, func, call, local_types=None):
        """FuncInfo for ``call``'s callee as seen from inside
        ``func``; None when unresolvable (builtins, externals,
        dynamic dispatch)."""
        callee = call.func
        if isinstance(callee, ast.Name):
            name = callee.id
            cursor = func
            while cursor is not None:       # lexical scope first
                if name in cursor.nested:
                    return cursor.nested[name]
                cursor = cursor.parent
            found = self._resolve_dotted(func.module, name)
            if isinstance(found, FuncInfo):
                return found
            if isinstance(found, ClassInfo):
                return found.find_method(self, "__init__")
            return None
        if isinstance(callee, ast.Subscript):
            return None                     # program tables etc.
        if not isinstance(callee, ast.Attribute):
            return None
        owner, meth = callee.value, callee.attr
        if (isinstance(owner, ast.Name) and owner.id == "self"
                and func.cls is not None):
            return func.cls.find_method(self, meth)
        dotted = dotted_name(callee)
        if dotted is not None:
            found = self._resolve_dotted(func.module, dotted)
            if isinstance(found, FuncInfo):
                return found
            if isinstance(found, ClassInfo):
                return found.find_method(self, "__init__")
        # typed receiver: locals, self attrs, globals, subscripts,
        # chained method returns
        types = (local_types if local_types is not None
                 else self.local_types(func))
        recv = self._expr_class(func.module, owner, types, func)
        if recv is not None:
            cls = self.resolve_class(func.module, recv)
            if cls is not None:
                return cls.find_method(self, meth)
        return None

    def calls_of(self, func):
        """Cached [(ast.Call, FuncInfo-or-None)] for every call inside
        ``func`` (nested defs excluded — they have their own entry)."""
        hit = self._call_cache.get(func.qname)
        if hit is not None:
            return hit
        types = self.local_types(func)
        out = []
        skip = {n.node for n in func.nested.values()}
        stack = list(ast.iter_child_nodes(func.node))
        while stack:
            n = stack.pop()
            if n in skip:
                continue
            if isinstance(n, ast.Call):
                out.append((n, self.resolve_call(func, n, types)))
            stack.extend(ast.iter_child_nodes(n))
        out.reverse()
        self._call_cache[func.qname] = out
        return out


def build_index(project):
    return ProjectIndex(project)
