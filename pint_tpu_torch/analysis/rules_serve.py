"""Serve request-state coverage rule family.

- request-state-leak: a function in a serve-state module (the
  ``serve_state_modules`` registry: serve/engine.py) moves a request
  to a terminal outcome — an assignment to a result's ``.status`` or
  ``.reason`` — without telling anyone: no lifecycle transition
  (``_lc`` / ``reqlife``), no telemetry record or counter, no
  reject/fail helper that carries both. A status set in a code path
  the ledger never hears about is a request that exists in the
  caller's ServeResult but in NO observability surface: the lifecycle
  census under-counts, ``obs tail`` can't resolve it, and the
  terminal-state invariant ("every request ends in exactly one
  terminal state") rots silently the next time someone adds an early
  return. Fix: pair the assignment with a lifecycle transition or a
  telemetry record in the same function (the ``_reject`` / ``_fail``
  helpers do both), or suppress with a justification when the
  assignment is a non-terminal bookkeeping touch-up.

  Detection is per function: the STATUS assignment must appear in the
  function's own body (nested defs are their own scope), while the
  record pattern may appear anywhere inside it. Assignments to
  ``self.*`` are engine-internal state, not request outcomes, and
  stay quiet.
"""

from __future__ import annotations

import ast
import re

from .core import Rule, mentions, register
from .rules_quality import _assign_targets, _own_nodes


@register
class RequestStateLeakRule(Rule):
    id = "request-state-leak"
    family = "serve"
    rationale = ("a request status/reason assigned without a paired "
                 "lifecycle transition or telemetry record is a "
                 "terminal outcome no observability surface ever "
                 "sees")

    def _applies(self, ctx):
        rel = "/" + ctx.rel.replace("\\", "/")
        suffixes = getattr(ctx.config, "serve_state_modules", ())
        return any(rel.endswith(s) for s in suffixes)

    def _status_site(self, fn):
        """First request-outcome assignment in the function's own
        body: ``<non-self>.status = ...`` or ``<non-self>.reason =
        ...`` (self.* is engine state, not a request outcome)."""
        for node in _own_nodes(fn):
            for target in _assign_targets(node):
                if not isinstance(target, ast.Attribute) \
                        or target.attr not in ("status", "reason"):
                    continue
                recv = target.value
                if isinstance(recv, ast.Name) and recv.id == "self":
                    continue
                return node
        return None

    def check_file(self, ctx):
        if not self._applies(ctx):
            return
        rec = re.compile(getattr(
            ctx.config, "serve_state_record_pattern",
            r"_lc|reqlife|lifecycle|telemetry|_reject|_fail"))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            site = self._status_site(node)
            if site is None:
                continue
            if mentions(node, rec):
                continue
            ctx.report(
                self.id, site,
                f"{node.name}() assigns a request status/reason but "
                "never records the outcome: pair it with a lifecycle "
                "transition (self._lc / reqlife) or a telemetry "
                "record in the same function, or suppress with a "
                "justification")
