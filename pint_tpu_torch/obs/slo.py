"""SLO burn-rate monitor: dual-window alerts over serve telemetry (the
JAX package's ``obs/slo.py``).

Classic SRE multi-window burn-rate alerting, pull-model like the rest
of the obs layer: the monitor never hooks the serve flush path —
callers :meth:`BurnRateMonitor.ingest` an engine snapshot at
poll/scrape time and the monitor derives, per SLO, the error-budget
burn rate over a *fast* window (catches sudden cliffs) and a *slow*
window (catches sustained simmer). An alert fires only when BOTH
windows exceed their factors — fast-only spikes self-resolve, slow-
only drift hasn't proven itself yet. Burn rate 1.0 means "consuming
exactly the whole budget over the window"; the default 14.4x fast /
6x slow factors are the standard page thresholds for a 99.9%-class
objective scaled to in-process serving.

Alert transitions flow through the flight recorder (an ``slo_alert``
event plus a ``dump("slo_burn_<name>")`` on firing, ``slo_resolved``
on clearing) and the burn rates land in the metrics registry as
``slo.<name>.*`` gauges, so one ``prometheus_text()`` scrape carries
the verdicts next to the raw counters they were derived from.

Two SLO shapes cover the serve surface:

- **ratio** — cumulative (bad, total) counters read from the
  snapshot (availability, shed rate, breaker rejections): burn is
  the windowed bad/total rate divided by the budget.
- **threshold** — a point-in-time value checked against a limit
  (p99 latency, lost lanes): each ingest is one check, burn is the
  windowed violation fraction divided by the budget.
"""

from __future__ import annotations

import collections
import threading

from . import clock as obs_clock
from . import metricsreg
from . import recorder as obs_recorder


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


def _tenant_row(snapshot, tenant):
    return (snapshot.get("tenants") or {}).get(tenant) or {}


def tenant_slos(tenants, latency_limit_s=0.25,
                availability_budget=0.01, latency_budget=0.05,
                **window_kw):
    """Per-tenant availability + p99-latency SLOs over the
    ``snapshot()["tenants"]`` rows (serve.metrics tenant accounting).
    Tenants are an explicit list — the monitor tracks the principals
    you promised budgets to, not whatever ids traffic invents (the
    cardinality cap folds those into ``other``, which can itself be
    monitored by naming it here)."""
    specs = []
    for t in tenants:
        specs.append(SLOSpec(
            "tenant_%s_availability" % t, availability_budget,
            bad=lambda s, t=t: (_tenant_row(s, t).get("requests", 0)
                                - _tenant_row(s, t).get("ok", 0)),
            total=lambda s, t=t: _tenant_row(s, t).get("requests", 0),
            **window_kw))
        specs.append(SLOSpec(
            "tenant_%s_latency_p99" % t, latency_budget,
            value=lambda s, t=t: _tenant_row(s, t).get("p99_s"),
            limit=latency_limit_s, **window_kw))
    return specs


def serve_slos(latency_limit_s=0.25, availability_budget=0.01,
               shed_budget=0.02, breaker_budget=0.02,
               latency_budget=0.05, lane_budget=0.01, tenants=None,
               **window_kw):
    """The default serve-engine SLO set over
    ``ServeEngine.snapshot()`` dicts: availability (non-ok request
    fraction), queue sheds, breaker rejections, p99 latency vs a
    limit, and device-lane losses. Budgets must satisfy
    ``1 / budget > fast_burn`` or the alert is unreachable (burn is
    capped at 1/budget when every sample is bad) — 0.05 with the
    14.4x default leaves headroom; 0.10 would not.

    tenants: optional list of tenant ids; each adds a per-tenant
    availability + p99-latency pair (see :func:`tenant_slos`) riding
    the same windows."""
    extra = (tenant_slos(tenants, latency_limit_s=latency_limit_s,
                         availability_budget=availability_budget,
                         latency_budget=latency_budget, **window_kw)
             if tenants else [])
    return extra + [
        SLOSpec("availability", availability_budget,
                bad=lambda s: (s.get("requests", 0)
                               - s.get("requests_ok", 0)),
                total="requests", **window_kw),
        SLOSpec("shed", shed_budget,
                bad="counters.shed_queue_full",
                total="requests", **window_kw),
        SLOSpec("breaker", breaker_budget,
                bad="counters.rejected_circuit_open",
                total="requests", **window_kw),
        SLOSpec("latency_p99", latency_budget,
                value=lambda s: (s.get("total_s") or {}).get("p99"),
                limit=latency_limit_s, **window_kw),
        SLOSpec("lane_loss", lane_budget,
                value=lambda s: len((s.get("devices") or {})
                                    .get("lost_lanes", []) or []),
                limit=0, **window_kw),
    ]


class BurnRateMonitor:
    """Dual-window burn-rate evaluator over a list of SLOSpecs.

    Thread-safe; injectable clock for deterministic tests. Alert
    events go to the process flight recorder and the burn rates to
    the given registry (default: the process REGISTRY) at every
    ingest."""

    def __init__(self, specs=None, clock=obs_clock.now,
                 registry=None, recorder=None):
        self.specs = list(specs) if specs is not None else serve_slos()
        self.clock = clock
        self.registry = registry
        self.recorder = recorder
        self._lock = threading.Lock()
        self._samples = {s.name: collections.deque() for s in self.specs}
        self._threshold_state = {s.name: [0, 0] for s in self.specs}
        self._alerting = {s.name: False for s in self.specs}
        self.alerts_fired = 0

    def add_specs(self, specs):
        """Extend a live monitor with more SLOs (e.g. the fit_quality
        five-pack joining an already-attached serve monitor). Existing
        names are replaced wholesale — their window history restarts,
        which is the honest reading of 'the objective changed'."""
        with self._lock:
            for spec in specs:
                self.specs = ([s for s in self.specs
                               if s.name != spec.name] + [spec])
                self._samples[spec.name] = collections.deque()
                self._threshold_state[spec.name] = [0, 0]
                self._alerting[spec.name] = False
        return self

    def _registry(self):
        return (metricsreg.REGISTRY if self.registry is None
                else self.registry)

    def _recorder(self):
        return (obs_recorder.RECORDER if self.recorder is None
                else self.recorder)

    @staticmethod
    def _burn(samples, now, window_s, budget):
        """Error-budget burn over [now - window_s, now]: windowed
        bad/total rate divided by the budget. 0.0 until the window
        has any traffic."""
        t_now, bad_now, total_now = samples[-1]
        anchor = samples[0]
        for s in samples:
            if s[0] <= now - window_s:
                anchor = s
            else:
                break
        d_bad = bad_now - anchor[1]
        d_total = total_now - anchor[2]
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / budget

    def ingest(self, snapshot, t=None):
        """Fold one service snapshot in; returns the per-SLO state
        list (name, burn_fast, burn_slow, alerting)."""
        now = self.clock() if t is None else t
        out = []
        with self._lock:
            for spec in self.specs:
                bad, total = spec.observe(
                    snapshot, self._threshold_state[spec.name])
                samples = self._samples[spec.name]
                samples.append((now, bad, total))
                # retain one sample beyond the slow window so the
                # anchor exists even at exact-window reads
                horizon = now - 2.0 * spec.slow_window_s
                while len(samples) > 2 and samples[1][0] < horizon:
                    samples.popleft()
                burn_fast = self._burn(samples, now,
                                       spec.fast_window_s, spec.budget)
                burn_slow = self._burn(samples, now,
                                       spec.slow_window_s, spec.budget)
                firing = (burn_fast >= spec.fast_burn
                          and burn_slow >= spec.slow_burn)
                was = self._alerting[spec.name]
                self._alerting[spec.name] = firing
                state = {"name": spec.name, "burn_fast": burn_fast,
                         "burn_slow": burn_slow, "alerting": firing,
                         "budget": spec.budget}
                out.append(state)
                if firing and not was:
                    self.alerts_fired += 1
                    rec = self._recorder()
                    rec.note("slo_alert", slo=spec.name,
                             burn_fast=round(burn_fast, 3),
                             burn_slow=round(burn_slow, 3),
                             budget=spec.budget)
                    rec.dump("slo_burn_%s" % spec.name,
                             slo=spec.name,
                             burn_fast=round(burn_fast, 3),
                             burn_slow=round(burn_slow, 3))
                elif was and not firing:
                    self._recorder().note("slo_resolved", slo=spec.name,
                                          burn_fast=round(burn_fast, 3),
                                          burn_slow=round(burn_slow, 3))
        self._export(out)
        return out

    def _export(self, states):
        reg = self._registry()
        for st in states:
            base = "slo.%s." % st["name"]
            reg.gauge(base + "burn_fast").set(round(st["burn_fast"], 4))
            reg.gauge(base + "burn_slow").set(round(st["burn_slow"], 4))
            reg.gauge(base + "alerting").set(int(st["alerting"]))
        c = reg.counter("slo.alerts_fired")
        with c._lock:
            c.value = self.alerts_fired

    def snapshot(self):
        """JSON-safe per-SLO state (most recent burn rates)."""
        with self._lock:
            out = {}
            for spec in self.specs:
                samples = self._samples[spec.name]
                if not samples:
                    out[spec.name] = {"burn_fast": 0.0,
                                      "burn_slow": 0.0,
                                      "alerting": False,
                                      "budget": spec.budget}
                    continue
                now = samples[-1][0]
                out[spec.name] = {
                    "burn_fast": self._burn(samples, now,
                                            spec.fast_window_s,
                                            spec.budget),
                    "burn_slow": self._burn(samples, now,
                                            spec.slow_window_s,
                                            spec.budget),
                    "alerting": self._alerting[spec.name],
                    "budget": spec.budget,
                }
            return out

    def alerting(self):
        """Names of the SLOs currently in the alerting state."""
        with self._lock:
            return [n for n, a in self._alerting.items() if a]
