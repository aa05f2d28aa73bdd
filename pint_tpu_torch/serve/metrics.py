"""Request telemetry: per-request latency phases + service counters,
exported as JSON-ready snapshots — the observability half of the
serve layer (the JAX package's ``serve/metrics.py``;
``pint_serve_bench``'s report comes from these snapshots).

Latency is recorded per phase so a slow request is attributable:
queue_wait (submit -> flush), pack (host prep + stacking), compile
(cold-executable AOT, zero on warm flushes), execute (device run,
shared by the whole flush), total (submit -> result).
"""

from __future__ import annotations

import json
import os
import threading

# The one nearest-rank implementation lives with the obs histogram
# primitives now; re-exported here so serve-layer callers (and bench)
# keep their import path.
from ..obs.metricsreg import Histogram, percentile  # noqa: F401


def tenant_cap():
    """Hard cardinality cap on per-tenant rows (env-tunable): the tail
    beyond the cap folds into one ``other`` row, mirroring the metrics
    registry's label guard."""
    try:
        return max(1, int(os.environ.get("PINT_TPU_TENANT_CAP", 32)))
    except (TypeError, ValueError):
        return 32


class ServeTelemetry:
    """Thread-safe: submitter threads, the async engine's flusher
    worker, and metric scrapers all touch the counters/records/
    histograms concurrently, so every mutation (and every read of the
    mutable aggregates) holds ``_lock``."""

    PHASES = ("queue_wait_s", "pack_s", "compile_s", "execute_s",
              "total_s")

    # Always present in snapshots (0 until first increment): the SLO
    # burn-rate monitor and Prometheus scrapes read these by name, so
    # they must exist from the first scrape, not appear on first shed.
    # The admission-control sheds (serve.admission) are standing for
    # the same reason: tenant throttling alerts key on them.
    STANDING_COUNTERS = ("shed_queue_full", "rejected_circuit_open",
                         "errors", "shed_backpressure",
                         "shed_tenant_quota", "shed_slo_throttle",
                         "shed_intake_overflow")

    def __init__(self):
        self._lock = threading.RLock()
        self.counters = {}
        self.records = []
        # live per-phase latency histograms; total_s carries exemplar
        # slots (trace id + tenant on the max-latency observations) so
        # a p99 spike resolves to a lifecycle record via `obs tail`
        self.histograms = {p: Histogram() for p in self.PHASES}

    def incr(self, name, n=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def record(self, **fields):
        """Append one per-request record (same dict the request's
        ServeResult.telemetry carries); completed requests also feed
        the per-phase histograms, total_s with an exemplar."""
        with self._lock:
            self.records.append(fields)
            if fields.get("status") != "ok":
                return
            for phase in self.PHASES:
                v = fields.get(phase)
                if v is None:
                    continue
                if phase == "total_s":
                    self.histograms[phase].record(v, exemplar={
                        "trace": fields.get("trace"),
                        "request_id": fields.get("request_id"),
                        "tenant": fields.get("tenant"),
                    })
                else:
                    self.histograms[phase].record(v)

    def latencies(self, phase="total_s", status="ok"):
        with self._lock:
            return [r[phase] for r in self.records
                    if r.get("status") == status
                    and r.get(phase) is not None]

    def tenant_rows(self, cap=None):
        """Per-tenant accounting rows behind the hard cardinality cap:
        request/outcome counts and ok-latency p50/p99 per tenant, the
        tail beyond the cap folded into one aggregate ``other`` row
        (largest tenants by request count are kept)."""
        with self._lock:
            records = list(self.records)
        by_tenant = {}
        for r in records:
            t = r.get("tenant") or "anon"
            row = by_tenant.setdefault(
                t, {"requests": 0, "ok": 0, "shed": 0, "rejected": 0,
                    "errors": 0, "_lat": []})
            row["requests"] += 1
            status = r.get("status")
            if status == "ok":
                row["ok"] += 1
                if r.get("total_s") is not None:
                    row["_lat"].append(r["total_s"])
            elif status == "shed":
                row["shed"] += 1
            elif status == "rejected":
                row["rejected"] += 1
            elif status == "error":
                row["errors"] += 1
        cap = tenant_cap() if cap is None else max(1, int(cap))
        if len(by_tenant) > cap:
            ranked = sorted(by_tenant.items(),
                            key=lambda kv: (-kv[1]["requests"], kv[0]))
            kept = dict(ranked[:cap])
            other = kept.pop("other", None) or {
                "requests": 0, "ok": 0, "shed": 0, "rejected": 0,
                "errors": 0, "_lat": []}
            for t, row in ranked[cap:]:
                for k in ("requests", "ok", "shed", "rejected",
                          "errors"):
                    other[k] += row[k]
                other["_lat"].extend(row["_lat"])
            kept["other"] = other
            by_tenant = kept
        out = {}
        for t in sorted(by_tenant):
            row = by_tenant[t]
            lat = row.pop("_lat")
            row["p50_s"] = percentile(lat, 50)
            row["p99_s"] = percentile(lat, 99)
            out[t] = row
        return out

    def snapshot(self, cache=None, health=None, breaker=None,
                 devices=None):
        """JSON-safe aggregate: request counts, per-phase p50/p99/max
        over completed requests, counters, and (optionally) the
        executable cache's hit/miss/evict counters plus the resilience
        layer's health state and circuit-breaker census.

        devices: list of DeviceLane.snapshot() dicts (the engine's
        per-device failure domains); summarized into a ``devices``
        block with alive/lost census alongside the per-lane detail."""
        counters = {name: 0 for name in self.STANDING_COUNTERS}
        with self._lock:
            counters.update(self.counters)
            records = list(self.records)
        snap = {
            "requests": len(records),
            "requests_ok": sum(1 for r in records
                               if r.get("status") == "ok"),
            "requests_rejected": sum(1 for r in records
                                     if r.get("status") == "rejected"),
            "counters": dict(sorted(counters.items())),
        }
        for phase in self.PHASES:
            vals = self.latencies(phase)
            snap[phase] = {"p50": percentile(vals, 50),
                           "p99": percentile(vals, 99),
                           "max": max(vals) if vals else None}
        snap["exemplars"] = self.histograms["total_s"].exemplars()
        snap["tenants"] = self.tenant_rows()
        if cache is not None:
            snap["cache"] = cache.counters()
        if health is not None:
            snap["health"] = health.snapshot()
        if breaker is not None:
            snap["breaker"] = breaker.snapshot()
        if devices is not None:
            snap["devices"] = {
                "n_lanes": len(devices),
                "alive_lanes": sum(1 for d in devices if d.get("alive")),
                "lost_lanes": [d["index"] for d in devices
                               if d.get("lost")],
                "lanes": list(devices),
            }
        return snap

    def to_json(self, cache=None, health=None, breaker=None,
                devices=None, **dump_kw):
        return json.dumps(self.snapshot(cache=cache, health=health,
                                        breaker=breaker, devices=devices),
                          **dump_kw)

    def export_to_registry(self, registry=None, prefix="serve.",
                           **snapshot_kw):
        """Absorb this telemetry's snapshot (counters, request census,
        per-phase quantiles, plus any cache/health/breaker/devices
        blocks) into an obs metrics registry — the bridge that puts
        serve metrics, mesh health, and breaker state into ONE
        Prometheus-exportable snapshot. Pull-model: called at export
        time, costs the flush path nothing."""
        from ..obs import metricsreg

        reg = metricsreg.REGISTRY if registry is None else registry
        snap = self.snapshot(**snapshot_kw)
        lanes = snap.get("devices", {}).pop("lanes", None)
        tenants = snap.pop("tenants", None)
        snap.pop("exemplars", None)  # ride the live histograms below
        reg.absorb(snap, prefix=prefix)
        if lanes is not None:
            for lane in lanes:
                reg.absorb(lane,
                           prefix="%slane.%s." % (prefix,
                                                  lane.get("index")))
        # live per-phase histograms join the registry by reference —
        # their quantiles AND exemplar slots render in the Prometheus
        # exposition without re-recording a single sample
        for phase, hist in self.histograms.items():
            reg.attach_histogram(prefix + "latency." + phase, hist)
        if tenants:
            # labeled per-tenant families, routed through the
            # registry's cardinality guard (fold-to-other + overflow
            # counter) rather than minting one metric name per tenant
            for t, row in tenants.items():
                labels = {"tenant": t}
                for key in ("requests", "ok", "shed", "rejected",
                            "errors"):
                    c = reg.counter(prefix + "tenant." + key,
                                    labels=labels)
                    with c._lock:
                        c.value = row[key]
                reg.gauge(prefix + "tenant.p50_s",
                          labels=labels).set(row["p50_s"])
                reg.gauge(prefix + "tenant.p99_s",
                          labels=labels).set(row["p99_s"])
        return reg

    def reset(self):
        with self._lock:
            self.counters = {}
            self.records = []
            self.histograms = {p: Histogram() for p in self.PHASES}
