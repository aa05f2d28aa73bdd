"""Lock-order family: whole-program deadlock detection.

The serve path is concurrent: submitter threads, the flusher worker,
and the watchdog all take locks — ``IntakeQueue._lock`` inside
``AsyncServeEngine._work_mutex``, ``Histogram._lock`` inside
``ServeTelemetry._lock``, the persistent tier inside
``ExecutableCache._lock`` — and the port adds process-wide module
locks around every CUDA-graph capture and replay (``graphs._LOCK``),
every ``jacfwd`` (``autodiff.LOCK``) and every kernel build
(``kernels/build.py::_LOCK``). Each class is individually disciplined
(rules_locks), but nothing checked the SYSTEM: two code paths
acquiring the same pair of locks in opposite orders deadlock under
load, and no per-class rule can see it.

This rule builds the acquired-while-held graph over the whole scan:

- lock identities are class-level (``ServeTelemetry._lock``), so any
  two instances of the same class alias (conservative); a module-level
  lock is its own identity (``graphs._LOCK``);
- direct edges come from lexically nested ``with`` blocks (including
  multi-item ``with a, b:``);
- call-mediated edges resolve calls made under a held lock through the
  project call graph, transitively, with the full witness chain;
- ``*_locked`` helper methods are treated as holding their class lock
  for their whole body (the repo convention rules_locks enforces);
- ``threading.Condition(self._lock)`` aliases to the underlying lock.

A cycle in the graph is a ``lock-order-cycle`` finding naming the full
witness path. The acyclic graph is exported as a machine-readable
artifact (``python -m pint_tpu_torch.analysis --lock-dag out.json``),
whose edges tests/test_torch_pintlint.py pins.

Reentrant self-edges (RLock re-entry) are not recorded: they are the
sanctioned pattern, not an ordering constraint.
"""

from __future__ import annotations

import ast

from .core import Rule, register


def _with_items(func_node, nested_nodes):
    """Every (With/AsyncWith node, [context expr]) inside ``func_node``
    excluding nested function bodies."""
    out = []
    stack = list(ast.iter_child_nodes(func_node))
    while stack:
        n = stack.pop()
        if n in nested_nodes:
            continue
        if isinstance(n, (ast.With, ast.AsyncWith)):
            out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    out.sort(key=lambda w: (w.lineno, w.col_offset))
    return out


class LockGraph:
    """Directed acquired-while-held graph with witness chains."""

    def __init__(self):
        self.nodes = set()
        self.edges = {}        # (held, acquired) -> witness [str, ...]
        self.sites = {}        # (held, acquired) -> (ctx, line)

    def add_node(self, lock):
        self.nodes.add(lock)

    def add_edge(self, held, acquired, witness, ctx, line):
        if held == acquired:
            return             # RLock re-entry, not an ordering edge
        self.nodes.add(held)
        self.nodes.add(acquired)
        key = (held, acquired)
        if key not in self.edges:
            self.edges[key] = list(witness)
            self.sites[key] = (ctx, line)

    def as_dict(self):
        return {
            "nodes": sorted(self.nodes),
            "edges": [
                {"held": held, "acquired": acquired,
                 "witness": self.edges[(held, acquired)]}
                for held, acquired in sorted(self.edges)
            ],
        }

    def cycles(self):
        """Strongly connected components with >1 node, as ordered node
        lists starting from the smallest lock name."""
        adj = {}
        for held, acquired in self.edges:
            adj.setdefault(held, set()).add(acquired)
        index, low, onstack = {}, {}, set()
        stack, sccs, counter = [], [], [0]

        def strongconnect(v):
            work = [(v, iter(sorted(adj.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            onstack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        onstack.add(w)
                        work.append((w, iter(sorted(adj.get(w, ())))))
                        advanced = True
                        break
                    if w in onstack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        onstack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        sccs.append(scc)

        for v in sorted(self.nodes):
            if v not in index:
                strongconnect(v)
        out = []
        for scc in sccs:
            members = set(scc)
            start = min(members)
            # shortest cycle through `start`: BFS within the SCC
            parent, dist = {start: None}, {start: 0}
            queue = [start]
            while queue:
                cur = queue.pop(0)
                for w in sorted(adj.get(cur, ())):
                    if w in members and w not in dist:
                        dist[w] = dist[cur] + 1
                        parent[w] = cur
                        queue.append(w)
            closers = [u for u in dist
                       if start in adj.get(u, ()) and u != start]
            if not closers:
                continue
            u = min(closers, key=lambda n: (dist[n], n))
            path = []
            while u is not None:
                path.append(u)
                u = parent[u]
            out.append(list(reversed(path)))
        return out


class _GraphBuilder:
    def __init__(self, project, index):
        self.project = project
        self.index = index
        self.config = project.config
        self.graph = LockGraph()
        self._acq_cache = {}
        self._acq_inflight = set()

    # -- lock identity -------------------------------------------------

    def _class_lock_owner(self, cls, attr):
        """(owner ClassInfo or None, canonical attr) for a ``self.X``
        lock access on ``cls``: resolves Condition aliases, own/
        inherited Lock attrs, and the LOCKED_CLASSES registry."""
        aliases = cls.all_cond_aliases(self.index)
        attr = aliases.get(attr, attr)
        owners = cls.all_lock_attrs(self.index)
        if attr in owners:
            return owners[attr], attr
        for mro_cls in cls.mro(self.index):
            spec = self.config.locked_classes.get(mro_cls.name)
            if spec and spec.get("lock") == attr:
                return mro_cls, attr
        return None, attr

    def _class_default_lock(self, cls):
        """The lock a ``*_locked`` helper implicitly holds."""
        spec = None
        for mro_cls in cls.mro(self.index):
            spec = self.config.locked_classes.get(mro_cls.name)
            if spec:
                break
        owners = cls.all_lock_attrs(self.index)
        if spec and spec.get("lock") in owners:
            attr = spec["lock"]
            return f"{owners[attr].name}.{attr}"
        if "_lock" in owners:
            return f"{owners['_lock'].name}._lock"
        if len(owners) == 1:
            attr, owner = next(iter(owners.items()))
            return f"{owner.name}.{attr}"
        return None

    def _lock_id(self, func, expr, local_types):
        """Lock identity of a with-item context expression, or None."""
        if isinstance(expr, ast.Attribute):
            attr, owner_expr = expr.attr, expr.value
            # with self._lock: / with self._cv:
            if (isinstance(owner_expr, ast.Name)
                    and owner_expr.id == "self"
                    and func.cls is not None):
                owner, attr = self._class_lock_owner(func.cls, attr)
                if owner is not None:
                    return f"{owner.name}.{attr}"
                return None
            # with <typed receiver>._lock: — q = self.intake, a local
            # constructed instance, a module singleton, c = reg.counter()
            typ = self.index._expr_class(func.module, owner_expr,
                                         local_types, func)
            if typ is not None:
                cls = self.index.resolve_class(func.module, typ)
                if cls is not None:
                    owner, attr = self._class_lock_owner(cls, attr)
                    if owner is not None:
                        return f"{owner.name}.{attr}"
            return None
        # with MODULE_LOCK:
        if isinstance(expr, ast.Name):
            if expr.id in func.module.module_locks:
                return f"{func.module.name}.{expr.id}"
        return None

    # -- per-function acquisition inventory -----------------------------

    def _acquisitions(self, func):
        """[(lock_id, with_node, item_index)] for direct with-block
        acquisitions in ``func``."""
        types = self.index.local_types(func)
        nested = {n.node for n in func.nested.values()}
        out = []
        for wnode in _with_items(func.node, nested):
            for i, item in enumerate(wnode.items):
                lock = self._lock_id(func, item.context_expr, types)
                if lock is not None:
                    out.append((lock, wnode, i))
        return out

    def _site(self, func, node):
        return f"{func.ctx.rel}:{node.lineno}"

    def acq_star(self, func):
        """{lock_id: witness chain} — every lock ``func`` may acquire
        during its execution, directly or through callees."""
        cached = self._acq_cache.get(func.qname)
        if cached is not None:
            return cached
        if func.qname in self._acq_inflight:
            return {}              # recursion: cut the cycle
        self._acq_inflight.add(func.qname)
        out = {}
        for lock, wnode, _ in self._acquisitions(func):
            out.setdefault(lock, (
                f"{self._site(func, wnode)}: {func.qname} "
                f"acquires {lock}",))
        for call, callee in self.index.calls_of(func):
            if callee is None:
                continue
            for lock, chain in self.acq_star(callee).items():
                out.setdefault(lock, (
                    f"{self._site(func, call)}: {func.qname} "
                    f"-> {callee.qname}",) + chain)
        self._acq_inflight.discard(func.qname)
        self._acq_cache[func.qname] = out
        return out

    # -- edge construction ----------------------------------------------

    @staticmethod
    def _inside(node, wnode):
        end = getattr(wnode, "end_lineno", wnode.lineno)
        nend = getattr(node, "end_lineno", node.lineno)
        return (node.lineno >= wnode.lineno and nend <= end
                and node is not wnode)

    def build(self):
        for qname in sorted(self.index.functions):
            self._edges_of(self.index.functions[qname])
        return self.graph

    def _edges_of(self, func):
        acqs = self._acquisitions(func)
        for lock, _, _ in acqs:
            self.graph.add_node(lock)
        calls = self.index.calls_of(func)
        for held, wnode, item_i in acqs:
            held_site = (f"{self._site(func, wnode)}: {func.qname} "
                         f"holds {held}")
            # nested with-blocks + later items of the same with
            for inner, iw, ii in acqs:
                if iw is wnode and ii > item_i:
                    self.graph.add_edge(
                        held, inner,
                        [held_site,
                         f"{self._site(func, iw)}: then acquires "
                         f"{inner} in the same with"],
                        func.ctx, wnode.lineno)
                elif iw is not wnode and self._inside(iw, wnode):
                    self.graph.add_edge(
                        held, inner,
                        [held_site,
                         f"{self._site(func, iw)}: acquires {inner} "
                         f"while held"],
                        func.ctx, wnode.lineno)
            # calls made while the lock is held
            for call, callee in calls:
                if callee is None or not self._inside(call, wnode):
                    continue
                for lock, chain in self.acq_star(callee).items():
                    self.graph.add_edge(
                        held, lock,
                        [held_site,
                         f"{self._site(func, call)}: calls "
                         f"{callee.qname}"] + list(chain),
                        func.ctx, wnode.lineno)
        # *_locked helpers hold their class lock for the whole body
        if (func.cls is not None and func.name.endswith("_locked")
                and func.parent is None):
            held = self._class_default_lock(func.cls)
            if held is not None:
                conv = (f"{self._site(func, func.node)}: {func.qname} "
                        f"holds {held} by *_locked convention")
                for lock, wnode, _ in acqs:
                    self.graph.add_edge(
                        held, lock,
                        [conv, f"{self._site(func, wnode)}: acquires "
                               f"{lock}"],
                        func.ctx, func.node.lineno)
                for call, callee in calls:
                    if callee is None:
                        continue
                    for lock, chain in self.acq_star(callee).items():
                        self.graph.add_edge(
                            held, lock,
                            [conv, f"{self._site(func, call)}: calls "
                                   f"{callee.qname}"] + list(chain),
                            func.ctx, func.node.lineno)


@register
class LockOrderRule(Rule):
    """Two threads acquiring the same pair of locks in opposite orders
    deadlock under load — the classic inversion no per-class rule can
    see. The whole-program acquired-while-held graph must be a DAG;
    every cycle is reported with its full witness path (the with-block
    or call chain realizing each edge)."""

    id = "lock-order-cycle"
    family = "locks"
    rationale = ("opposite-order lock acquisition across threads "
                 "deadlocks; the acquired-while-held graph must stay "
                 "acyclic")
    whole_program = True

    def check_project(self, project, index):
        graph = _GraphBuilder(project, index).build()
        project.lock_graph = graph
        for cycle in graph.cycles():
            edges = list(zip(cycle, cycle[1:] + cycle[:1]))
            first = None
            lines = []
            for held, acquired in edges:
                witness = graph.edges.get((held, acquired))
                site = graph.sites.get((held, acquired))
                if witness is None:
                    continue
                if first is None:
                    first = site
                lines.append(f"[{held} -> {acquired}: "
                             + " | ".join(witness) + "]")
            if first is None:
                continue
            ctx, line = first
            ctx.report(
                self.id, line,
                "lock-order cycle "
                + " -> ".join(cycle + cycle[:1])
                + ": " + " ".join(lines))


def lock_order_graph(paths, config=None):
    """Run the whole-program pass over ``paths`` and return the
    acquired-while-held graph as a JSON-ready dict (the artifact the
    CLI's --lock-dag writes and the runtime cross-check consumes)."""
    from .core import run_project

    _, project = run_project(paths, config=config)
    graph = getattr(project, "lock_graph", None)
    return graph.as_dict() if graph is not None else {
        "nodes": [], "edges": []}
