"""Observability rule family.

- timing-untraced: a raw wall-clock READ (``time.time()``,
  ``time.perf_counter()``, ``time.monotonic()``) in a module that is
  instrumented with the obs tracing layer (``pint_tpu_torch.obs``).
  Instrumented modules must time through ``pint_tpu_torch.obs.clock``
  (``obs_clock.now()`` / ``Stopwatch``) or a span: a raw read uses a
  clock the tracer does not know about, so the number never lands in
  exported timelines or flight-recorder dumps, and two "elapsed"
  figures in one report can come from different clocks.
  ``time.sleep`` is a delay, not a measurement, and injectable timer
  DEFAULTS (``clock=time.monotonic`` — a reference, not a call) stay
  legal. The obs package itself and tests (fake clocks on purpose)
  are allow-listed.
"""

from __future__ import annotations

import ast

from .core import Rule, call_name, register


@register
class TimingUntracedRule(Rule):
    id = "timing-untraced"
    family = "obs"
    rationale = ("raw clock reads in obs-instrumented modules bypass "
                 "the shared obs clock: invisible to span timelines "
                 "and flight dumps")

    def _applies(self, ctx):
        rel = "/" + ctx.rel.replace("\\", "/")
        markers = getattr(ctx.config, "obs_allowed_path_markers", ())
        if any(m in rel for m in markers):
            return False
        suffixes = getattr(ctx.config, "obs_instrumented_modules", ())
        return any(rel.endswith(s) for s in suffixes)

    def check_file(self, ctx):
        if not self._applies(ctx):
            return
        raw = getattr(ctx.config, "obs_raw_timer_calls", frozenset())
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in raw:
                ctx.report(
                    self.id, node,
                    f"raw {name}() in an obs-instrumented module: "
                    "read the clock through pint_tpu_torch.obs.clock "
                    "(obs_clock.now) or wrap the region in an obs "
                    "span so the measurement lands in exported "
                    "timelines and flight dumps")
