"""Fit-quality signal coverage rule family.

- quality-signal-dropped: a function on the fit path (the
  ``quality_signal_modules`` registry: fitter.py, parallel/pta.py,
  parallel/toa_shard.py, serve/engine.py) computes a numerical
  quality signal — a ``relres_failed`` refinement verdict or a
  ``chi2_whitened`` assignment — without routing anything into the
  numerics observatory (``pint_tpu_torch.obs.fitquality``): no ledger
  record, no fallback note, no per-batch quality summary. A
  computed-then-dropped signal is telemetry the drift sentinels and
  the ``fit_quality`` SLOs silently never see; the very fits that
  needed the f64 fallback are exactly the ones the observatory must
  know about. Fix: record through ``fitquality.record_fit_batch`` /
  ``FITQ.note_fallback`` (or the module's ``_record_*quality``
  helper), or suppress with a justification when the signal is a
  local probe diagnostic and not a production fit.

  Detection is per function: the SIGNAL must appear in the function's
  own body (nested defs are their own scope), while the RECORD
  pattern may appear anywhere inside it, so a recording closure
  counts. Functions whose own name matches the signal pattern (the
  ``relres_failed`` guard itself) are never flagged, and reads such
  as ``getattr(self, "chi2_whitened", None)`` are string constants,
  not computations, so they stay quiet.
"""

from __future__ import annotations

import ast
import re

from .core import Rule, call_name, mentions, register


def _own_nodes(fn):
    """The function's own statements — nested function/class bodies
    are separate scopes and are NOT descended into (they get their
    own check)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _assign_targets(node):
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        return [node.target]
    return []


@register
class QualitySignalDroppedRule(Rule):
    id = "quality-signal-dropped"
    family = "quality"
    rationale = ("a relres/chi2_whitened quality signal computed but "
                 "never recorded through pint_tpu_torch.obs.fitquality is "
                 "invisible to the drift sentinels and fit_quality "
                 "SLOs")

    def _applies(self, ctx):
        rel = "/" + ctx.rel.replace("\\", "/")
        suffixes = getattr(ctx.config, "quality_signal_modules", ())
        return any(rel.endswith(s) for s in suffixes)

    def _signal_site(self, fn, sig):
        """First quality-signal computation in the function's own
        body: a call to a signal-named function, or an assignment to
        a signal-named target (self.chi2_whitened = ...)."""
        for node in _own_nodes(fn):
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name and sig.search(name):
                    return node
            for target in _assign_targets(node):
                if isinstance(target, ast.Name) and sig.search(target.id):
                    return node
                if (isinstance(target, ast.Attribute)
                        and sig.search(target.attr)):
                    return node
        return None

    def check_file(self, ctx):
        if not self._applies(ctx):
            return
        sig = re.compile(getattr(ctx.config, "quality_signal_pattern",
                                 r"relres_failed|chi2_whitened"))
        rec = re.compile(getattr(
            ctx.config, "quality_record_pattern",
            r"quality|FITQ|obs_fitq|record_fit_batch|note_fallback"))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if sig.search(node.name):
                continue  # the guard/probe definition itself
            site = self._signal_site(node, sig)
            if site is None:
                continue
            if mentions(node, rec):
                continue
            ctx.report(
                self.id, site,
                f"{node.name}() computes a fit-quality signal but "
                "never records it: route it through "
                "pint_tpu_torch.obs.fitquality (record_fit_batch / "
                "FITQ.note_fallback / the module's quality helper) "
                "or suppress with a justification")
