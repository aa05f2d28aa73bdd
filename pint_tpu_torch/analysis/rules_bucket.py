"""Bucket-shape discipline rule family.

- bucket-hardcoded: direct pow2_bucket calls outside the shape
  planner / batcher keep bucket-shape decisions out of the planner's
  padded-FLOP cost model.
"""

from __future__ import annotations

import ast

from .config import BUCKET_CALLS
from .core import Rule, call_name, register


@register
class BucketHardcodedRule(Rule):
    """Every bucket-shape decision must route through
    parallel/shapeplan.py (plan_shapes / pow2_width / ladder_width)
    or the canonical serve/batcher.py implementation. A direct
    pow2_bucket call anywhere else hardcodes the legacy ladder,
    bypassing the planner's cost model and splitting the shape
    convention across modules — exactly the drift that made the pow2
    ladder's x1.37 padding invisible until the 670k bench measured
    it."""

    id = "bucket-hardcoded"
    family = "bucket"
    rationale = ("direct pow2_bucket calls outside shapeplan/batcher "
                 "hardcode the legacy ladder and bypass the shape "
                 "planner's cost model")

    def check_file(self, ctx):
        path = ctx.path.replace("\\", "/")
        if any(path.endswith(mod)
               for mod in ctx.config.bucket_allowed_modules):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            tail = name.rsplit(".", 1)[-1] if name else None
            if tail in BUCKET_CALLS:
                ctx.report(
                    self.id, node,
                    f"direct {tail}() call outside the shape planner "
                    "and batcher: route bucket widths through "
                    "parallel/shapeplan.py (plan_shapes / pow2_width "
                    "/ ladder_width) so shape decisions stay in the "
                    "cost model")
