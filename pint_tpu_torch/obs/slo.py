"""Service-level objectives (the JAX package's ``obs/slo.py``, in
part): :class:`SLOSpec`, one objective read from a snapshot dict.

Two SLO shapes:

- **ratio** — cumulative (bad, total) counters read from the
  snapshot: burn is the windowed bad/total rate divided by the budget.
- **threshold** — a point-in-time value checked against a limit: each
  observation is one check, burn is the windowed violation fraction
  divided by the budget.

The fit-quality pack (``fitquality.fit_quality_slos``) is built from
these specs. Not ported yet (ROADMAP §1 item 3): ``BurnRateMonitor``,
which evaluates a list of specs over fast and slow windows, and the
serve-engine packs ``serve_slos`` and ``tenant_slos``.
"""

from __future__ import annotations


def _resolve(snapshot, path):
    """Dotted-path lookup into a snapshot dict ("counters.shed" ->
    snapshot["counters"]["shed"]); 0 when any hop is missing."""
    cur = snapshot
    for part in path.split("."):
        if not isinstance(cur, dict):
            return 0
        cur = cur.get(part)
        if cur is None:
            return 0
    return cur


class SLOSpec:
    """One service-level objective.

    ratio mode: ``bad`` / ``total`` are dotted paths or callables
    returning CUMULATIVE counts from a snapshot. threshold mode:
    ``value`` (dotted path or callable) is compared against
    ``limit`` at every ingest. ``budget`` is the allowed bad
    fraction (e.g. 0.01 = 99% objective)."""

    def __init__(self, name, budget, bad=None, total=None,
                 value=None, limit=None,
                 fast_window_s=300.0, slow_window_s=3600.0,
                 fast_burn=14.4, slow_burn=6.0):
        if budget <= 0:
            raise ValueError("SLO budget must be > 0 (it is the "
                             "allowed bad fraction)")
        if (bad is None) == (value is None):
            raise ValueError("SLOSpec needs exactly one of bad= "
                             "(ratio mode) or value= (threshold mode)")
        self.name = name
        self.budget = float(budget)
        self.bad = bad
        self.total = total
        self.value = value
        self.limit = limit
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)

    def _get(self, snapshot, accessor):
        if callable(accessor):
            try:
                return accessor(snapshot) or 0
            except Exception:
                return 0
        return _resolve(snapshot, accessor)

    def observe(self, snapshot, state):
        """Cumulative (bad, total) after folding in one snapshot.
        Ratio specs read the snapshot's own cumulative counters;
        threshold specs accumulate one check per ingest into
        ``state`` (a mutable [bad, total] pair owned by the
        monitor)."""
        if self.bad is not None:
            return (float(self._get(snapshot, self.bad)),
                    float(self._get(snapshot, self.total)
                          if self.total is not None else 0))
        val = self._get(snapshot, self.value)
        state[1] += 1
        if val is not None and self.limit is not None \
                and val > self.limit:
            state[0] += 1
        return float(state[0]), float(state[1])
