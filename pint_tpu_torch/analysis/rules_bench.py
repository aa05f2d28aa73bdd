"""Bench-hygiene rule family.

- timing-no-block: a timer window that dispatches device work without
  a synchronizing call before the elapsed time is computed. A CUDA
  launch, a graph replay and a program-table call all return once the
  work is queued: without ``torch.cuda.synchronize()`` (or an event's
  ``synchronize``/``elapsed_time``, or a host pull) the window times
  the enqueue, not the compute — the classic way a bench reports a
  100x phantom speedup.

Dispatches: ``self._fns[key](...)`` program-table calls, calls of
device functions (``rules_retrace.TracedIndex``), of a local bound to
``GraphProgram(...)`` / ``aot_backend_compile(...)["compiled"]``, of a
``*_cuda`` kernel wrapper, and a CUDA graph's ``.replay()`` (a
request journal's ``replay()`` reads a file and is not one).
"""

from __future__ import annotations

import ast
import re

from .config import (KERNEL_LAUNCH_PATTERN, PROGRAM_TABLE_ATTRS, SYNC_CALLS,
                     TIMER_CALLS)
from .core import Rule, call_name, dotted_name, register
from .rules_retrace import traced_index

_KERNEL = re.compile(KERNEL_LAUNCH_PATTERN)


def _is_timer_call(node):
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    return name in TIMER_CALLS


def _subscript_root_attr(node):
    """'_fns' for a ``self._fns[key](...)`` style callee."""
    if isinstance(node, ast.Subscript) and \
            isinstance(node.value, ast.Attribute):
        return node.value.attr
    return None


def _method(node):
    return node.func.attr if isinstance(node.func, ast.Attribute) else None


def _graph_replay(node):
    if _method(node) != "replay" or node.args:
        return False
    recv = dotted_name(node.func.value) or ""
    return not recv.rsplit(".", 1)[-1].endswith("journal")


@register
class TimingNoBlockRule(Rule):
    id = "timing-no-block"
    family = "bench"
    rationale = ("async dispatch inside a timer window without a "
                 "synchronize times the enqueue, not the work")

    def check_file(self, ctx):
        traced = traced_index(ctx.tree)
        for func in ast.walk(ctx.tree):
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_func(ctx, func, traced)

    @staticmethod
    def _dispatches(node, traced):
        cname = call_name(node)
        tail = cname.rsplit(".", 1)[-1] if cname else _method(node)
        return (_subscript_root_attr(node.func) in PROGRAM_TABLE_ATTRS
                or traced.is_traced_name(cname, node)
                or bool(tail and _KERNEL.search(tail))
                or _graph_replay(node))

    def _check_func(self, ctx, func, traced):
        body = list(ast.walk(func))
        # timer starts: t = time.perf_counter() (several windows may
        # reuse one variable; pair each elapsed use with the closest
        # preceding start of the same name)
        starts = []
        for node in body:
            if isinstance(node, ast.Assign) and \
                    _is_timer_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        starts.append((t.id, node.lineno))
        if not starts:
            return
        ends = []
        for node in body:
            if isinstance(node, ast.BinOp) and \
                    isinstance(node.op, ast.Sub) and \
                    isinstance(node.right, ast.Name) and \
                    node.right.id in {n for n, _ in starts}:
                ends.append((node.right.id, node.lineno))
        windows = []
        for name, end_line in sorted(ends, key=lambda p: p[1]):
            cands = [ln for n, ln in starts
                     if n == name and ln < end_line]
            if cands:
                windows.append((name, max(cands), end_line))
        for name, start_line, end_line in sorted(set(windows)):
            window = [n for n in body
                      if getattr(n, "lineno", None) is not None
                      and start_line <= n.lineno <= end_line]
            dispatch = None
            synced = False
            for node in window:
                if not isinstance(node, ast.Call):
                    continue
                cname = call_name(node)
                tail = (cname.rsplit(".", 1)[-1] if cname
                        else _method(node))
                if cname in SYNC_CALLS or tail in SYNC_CALLS:
                    synced = True
                if self._dispatches(node, traced):
                    dispatch = dispatch or node
            if dispatch is not None and not synced:
                ctx.report(
                    self.id, dispatch,
                    f"device dispatch inside the '{name}' timing "
                    f"window (lines {start_line}-{end_line}) with no "
                    f"torch.cuda.synchronize()/host pull before the "
                    f"elapsed computation: this times the async "
                    f"enqueue, not the compute")
