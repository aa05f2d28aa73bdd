"""SLO-aware admission control for the serving front door (the JAX
package's ``serve/admission.py``).

The intake queue bounds how much work the engine will HOLD; admission
control bounds how much work each caller may INJECT and in what order
it is sacrificed under load. Decisions are made before a request
touches the queue, in one ladder:

1. **Tenant quota** — a per-tenant token bucket (``quotas`` /
   ``default_quota_rps``, burst ``burst_s`` seconds of rate). A tenant
   over its sustained rate is shed with reason ``tenant_quota`` no
   matter how empty the queue is: quota isolation is what keeps one
   hot tenant from converting shared headroom into everyone's p99.
   The bucket refills at decision time but is debited only when the
   request is actually admitted — a request shed by a later rung
   never consumes quota, so throttling/backpressure can't push a
   tenant into ``tenant_quota`` sheds on top.
2. **SLO throttle** — :meth:`observe_slo` ingests the per-SLO state
   list the engine's :class:`obs.slo.BurnRateMonitor` produces
   (``ServeEngine.slo_check``). A tenant whose own availability or
   latency SLO is burn-rate-alerting gets its at-or-below-priority
   traffic shed with reason ``slo_throttle`` until the alert clears —
   the tenant burning its error budget is throttled before it burns
   anyone else's.
3. **Backpressure** — above ``soft_watermark`` of queue capacity,
   batch-priority traffic (``PRIORITY_BATCH``) is shed with reason
   ``backpressure`` so interactive traffic keeps the remaining
   headroom. This is the graceful first stage of degradation; the
   bounded queue's hard ``queue_full``/``intake_overflow`` shed and
   the circuit breaker's rejection stages sit behind it.

Priorities (``TimingRequest.priority``): 0 high, 1 normal, 2 batch.
Priority never enters the slot key — all classes share warm
executables; it only orders who is shed first.

Thread-safe: submitter threads decide() concurrently while the
flusher's periodic ``slo_check`` calls observe_slo(); every mutation
holds ``_lock``. The controller holds no clock calls
of its own beyond the injectable ``clock`` — deterministic under the
test clocks, and the bucket math is a pure function of the timestamps
passed in.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_BATCH = 2

# SLO names the burn-rate monitor mints per tenant (obs.slo.tenant_slos:
# "tenant_<tenant>_availability" / "tenant_<tenant>_latency_p99");
# observe_slo maps an alerting name back to its tenant by suffix, so
# tenant ids containing underscores resolve correctly.
_TENANT_SLO_SUFFIXES = ("_availability", "_latency_p99")
_TENANT_SLO_PREFIX = "tenant_"


@dataclass
class AdmissionDecision:
    """One admit/shed verdict: ``reason`` is the shed reason code
    (``tenant_quota`` / ``slo_throttle`` / ``backpressure``) when
    ``admit`` is False, ``detail`` the structured payload that rides
    the client's rejection telemetry."""

    admit: bool
    reason: str | None = None
    detail: dict = field(default_factory=dict)


class AdmissionController:
    def __init__(self, quotas=None, default_quota_rps=None, burst_s=1.0,
                 soft_watermark=0.75, throttle_priority=PRIORITY_NORMAL,
                 clock=time.monotonic):
        self.quotas = dict(quotas or {})
        self.default_quota_rps = (None if default_quota_rps is None
                                  else float(default_quota_rps))
        self.burst_s = float(burst_s)
        self.soft_watermark = float(soft_watermark)
        self.throttle_priority = int(throttle_priority)
        self.clock = clock
        self._lock = threading.RLock()
        # tenant -> [tokens, last_refill_t] token bucket
        self._buckets = {}
        # slo name -> (tenant, since_t) for currently-alerting tenant
        # SLOs; _throttled is the tenant-level view rebuilt from it
        self._burning = {}
        self._throttled = {}
        self.decisions = 0
        self.shed = 0

    # -- the admit/shed ladder ---------------------------------------

    def _quota_rps(self, tenant):
        rate = self.quotas.get(tenant, self.default_quota_rps)
        return None if rate is None else float(rate)

    def decide(self, request, depth, capacity, now=None):
        """One admission verdict for ``request`` given the current
        intake ``depth``/``capacity``. Pure bookkeeping — the caller
        (engine submit) owns the actual shed."""
        tenant = getattr(request, "tenant", "anon") or "anon"
        priority = int(getattr(request, "priority", PRIORITY_NORMAL))
        with self._lock:
            t = self.clock() if now is None else float(now)
            self.decisions += 1
            rate = self._quota_rps(tenant)
            tokens = None
            if rate is not None:
                cap = max(1.0, rate * self.burst_s)
                tokens, last = self._buckets.get(tenant, (cap, t))
                tokens = min(cap, tokens + max(0.0, t - last) * rate)
                # persist the refill now, but debit only on admission
                # (below): a request shed by a later rung must not
                # consume quota, or a throttled/backpressured tenant
                # is double-penalized into tenant_quota sheds by
                # traffic that never entered the queue
                self._buckets[tenant] = (tokens, t)
                if tokens < 1.0:
                    self.shed += 1
                    return AdmissionDecision(
                        False, "tenant_quota",
                        {"tenant": tenant, "quota_rps": rate,
                         "priority": priority})
            since = self._throttled.get(tenant)
            if since is not None and priority >= self.throttle_priority:
                self.shed += 1
                return AdmissionDecision(
                    False, "slo_throttle",
                    {"tenant": tenant, "priority": priority,
                     "burning_since": since,
                     "slos": sorted(n for n, (tn, _)
                                    in self._burning.items()
                                    if tn == tenant)})
            if capacity and depth >= self.soft_watermark * capacity \
                    and priority >= PRIORITY_BATCH:
                self.shed += 1
                return AdmissionDecision(
                    False, "backpressure",
                    {"tenant": tenant, "priority": priority,
                     "queue_depth": int(depth),
                     "soft_limit": int(self.soft_watermark * capacity)})
            if tokens is not None:
                self._buckets[tenant] = (tokens - 1.0, t)
            return AdmissionDecision(True)

    # -- SLO feedback ------------------------------------------------

    @staticmethod
    def _tenant_of(slo_name):
        """Tenant id for a per-tenant SLO name, else None."""
        name = str(slo_name)
        if not name.startswith(_TENANT_SLO_PREFIX):
            return None
        for suffix in _TENANT_SLO_SUFFIXES:
            if name.endswith(suffix):
                return name[len(_TENANT_SLO_PREFIX):-len(suffix)] or None
        return None

    def observe_slo(self, states, now=None):
        """Ingest one per-SLO state list (the return of
        ``BurnRateMonitor.ingest`` / ``ServeEngine.slo_check``):
        tenants whose own SLOs are burn-rate-alerting become
        throttled; clearing alerts un-throttle them. Returns the set
        of currently throttled tenants."""
        with self._lock:
            t = self.clock() if now is None else float(now)
            for state in states or ():
                tenant = self._tenant_of(state.get("name"))
                if tenant is None:
                    continue
                if state.get("alerting"):
                    prev = self._burning.get(state["name"])
                    self._burning[state["name"]] = (
                        tenant, prev[1] if prev else t)
                else:
                    self._burning.pop(state.get("name"), None)
            throttled = {}
            for _, (tenant, since) in sorted(self._burning.items()):
                prev = throttled.get(tenant)
                throttled[tenant] = (since if prev is None
                                     else min(prev, since))
            self._throttled = throttled
            return set(throttled)

    def throttled_tenants(self):
        with self._lock:
            return dict(self._throttled)

    def snapshot(self):
        """JSON-safe census for the engine snapshot / Prometheus
        absorb: decision counts, live bucket levels, throttled
        tenants."""
        with self._lock:
            return {
                "decisions": self.decisions,
                "shed": self.shed,
                "default_quota_rps": self.default_quota_rps,
                "tenants_tracked": len(self._buckets),
                "throttled": sorted(self._throttled),
                "burning_slos": sorted(self._burning),
            }
