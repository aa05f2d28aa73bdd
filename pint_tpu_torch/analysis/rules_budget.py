"""Budget-coverage rule family.

- meta-key-unbudgeted: a ``measured_*`` / ``serve_*`` / ``chaos_*``
  / ``cold_start_*`` / ``gw_*`` / ``incremental_*`` meta key
  defined as a dict-literal key in a budget-governed module (the
  port's round writer, ``chip_smoke.py``) that the machine-readable
  budget file (``pint_tpu_torch/obs/budgets.json``) does not know
  about — neither a budget bound, a regression-gated key, nor a
  tracked key. Every number a round carries must be registered so the
  regression gate sees it from the round it first appears; an
  unregistered key is a metric that can silently regress forever. Fix:
  add the key to ``tracked`` (or give it a budget/regression entry) in
  budgets.json.

  Only dict-literal KEYS are inspected — ``report["serve_x"]`` reads
  of some other dict are not meta-key definitions. The rule is inert
  when the budget file cannot be loaded (``budgeted_meta_keys`` is
  None): lint must not fail because an optional data file is absent.
"""

from __future__ import annotations

import ast
import re

from .core import Rule, register

_META_KEY = re.compile(
    r"^(measured_|serve_|chaos_|cold_start_|gw_|incremental_)")


@register
class MetaKeyUnbudgetedRule(Rule):
    id = "meta-key-unbudgeted"
    family = "budget"
    rationale = ("a measured_*/serve_*/chaos_*/cold_start_*/gw_*/"
                 "incremental_* meta key "
                 "absent from pint_tpu_torch/obs/budgets.json is "
                 "invisible to the regression gate and can regress "
                 "silently")

    def _applies(self, ctx):
        rel = "/" + ctx.rel.replace("\\", "/")
        suffixes = getattr(ctx.config, "budget_meta_modules", ())
        return any(rel.endswith(s) for s in suffixes)

    def check_file(self, ctx):
        if not self._applies(ctx):
            return
        budgeted = getattr(ctx.config, "budgeted_meta_keys", None)
        if budgeted is None:  # budget file unavailable -> inert
            return
        seen = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Dict):
                continue
            for key in node.keys:
                if (not isinstance(key, ast.Constant)
                        or not isinstance(key.value, str)):
                    continue
                name = key.value
                if (not _META_KEY.match(name) or name in budgeted
                        or name in seen):
                    continue
                seen.add(name)
                ctx.report(
                    self.id, key,
                    f"meta key {name!r} has no entry in "
                    "pint_tpu_torch/obs/budgets.json: register it under "
                    "tracked (or give it a budget/regression bound) "
                    "so the regression gate can watch it")
