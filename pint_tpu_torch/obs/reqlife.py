"""Per-request lifecycle ledger: the request plane of the observatory
(the JAX package's ``obs/reqlife.py``).

Every ``TimingRequest`` gets a trace id minted at ``ServeEngine.submit``
that rides the batcher slot into the flush span. The ledger records the
full state machine

    submitted -> queued -> packed -> executing ->
        delivered | shed(queue_full/deadline) |
        rejected(circuit_open/...) | error

with per-transition timestamps on the obs clock, so queue-wait vs
service-time decomposition exists PER REQUEST — joinable to the
``serve.*`` spans (via the flush trace id recorded on delivery) and to
the flight recorder's dumps. Recovery replays append two extra states:
``replayed_committed`` (journal returned the committed result, terminal)
and ``re_executed`` (uncommitted intake re-submitted live, non-terminal
— the normal machine then runs it to a terminal state).

The ledger is bounded (FIFO eviction at ``capacity``) and thread-safe;
evicting a record that never reached a terminal state increments
``lost_records``, which the budgets pin at 0 — bounded memory must
never silently drop in-flight accounting. All bookkeeping is host-side
dict work: instrumented serve runs stay bitwise identical to
uninstrumented ones (tests/test_torch_reqlife.py digest-asserts this).
The environment variables are the JAX package's: ``PINT_TPU_REQLIFE``
(the engine's default attachment), ``PINT_TPU_REQLIFE_CAP`` and
``PINT_TPU_TENANT_CAP``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from . import clock as obs_clock
from . import trace as obs_trace

TERMINAL_STATES = frozenset({
    "delivered", "shed", "rejected", "error", "replayed_committed",
})

#: States a healthy request passes through, in order (docs + tail
#: resolution use this to compute the queue-wait vs execute split).
HAPPY_PATH = ("submitted", "queued", "packed", "executing", "delivered")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return int(default)


class LifecycleLedger:
    """Bounded, thread-safe per-request state-machine recorder.

    One record per request id::

        {"request_id", "tenant", "kind", "trace",
         "states": [{"state", "t", "reason"?}, ...],
         "state": <latest>, "terminal": bool, "attrs": {...}}

    ``attrs`` carries delivery-time joins (flush_trace, queue_wait_s,
    execute_s, slot bucket). Timestamps default to the obs clock but
    callers holding a deterministic test clock pass ``t=`` explicitly.
    """

    TERMINAL_STATES = TERMINAL_STATES

    def __init__(self, capacity=None, clock=None):
        self._lock = threading.Lock()
        self._capacity = max(1, int(
            capacity if capacity is not None
            else _env_int("PINT_TPU_REQLIFE_CAP", 8192)))
        self._records = OrderedDict()  # request_id -> record dict
        self._by_trace = {}  # trace id -> request_id
        self._counters = {"submitted": 0, "terminal": 0,
                          "lost_records": 0, "double_terminal": 0,
                          "unknown_request": 0}
        self.clock = clock if clock is not None else obs_clock.now

    @property
    def capacity(self):
        return self._capacity

    def submitted(self, request_id, tenant="anon", kind=None, t=None):
        """Open (or re-anchor, on recovery re-submit) a record; returns
        the request's trace id. Trace ids come from the obs tracer's
        counter so they join the span namespace even when tracing is
        disabled."""
        t = self.clock() if t is None else t
        with self._lock:
            rec = self._records.get(request_id)
            if rec is not None:
                # recovery re-submit: same id rides back through
                # submit(); keep the trace, re-open the machine
                self._records.move_to_end(request_id)
                rec["states"].append({"state": "submitted", "t": t})
                rec["state"] = "submitted"
                rec["terminal"] = False
                return rec["trace"]
            trace = obs_trace.TRACER.new_trace_id()
            rec = {"request_id": request_id,
                   "tenant": str(tenant) if tenant else "anon",
                   "kind": kind, "trace": trace,
                   "states": [{"state": "submitted", "t": t}],
                   "state": "submitted", "terminal": False,
                   "attrs": {}}
            self._records[request_id] = rec
            self._by_trace[trace] = request_id
            self._counters["submitted"] += 1
            self._evict_locked()
            return trace

    def transition(self, request_id, state, t=None, reason=None,
                   **attrs):
        """Append one state transition; returns the trace id (None for
        an unknown request — evicted or never submitted). A second
        terminal transition is refused and counted (exactly-one-
        terminal-state is an acceptance criterion, not a hope)."""
        t = self.clock() if t is None else t
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None:
                self._counters["unknown_request"] += 1
                return None
            if rec["terminal"] and state in TERMINAL_STATES:
                self._counters["double_terminal"] += 1
                return rec["trace"]
            entry = {"state": state, "t": t}
            if reason is not None:
                entry["reason"] = reason
            rec["states"].append(entry)
            rec["state"] = state
            if state in TERMINAL_STATES:
                rec["terminal"] = True
                self._counters["terminal"] += 1
            if attrs:
                rec["attrs"].update(attrs)
            return rec["trace"]

    def _evict_locked(self):
        while len(self._records) > self._capacity:
            _, old = self._records.popitem(last=False)
            self._by_trace.pop(old["trace"], None)
            if not old["terminal"]:
                self._counters["lost_records"] += 1

    def record(self, request_id):
        """JSON-safe copy of one record (None if unknown)."""
        with self._lock:
            rec = self._records.get(request_id)
            return _copy_record(rec) if rec is not None else None

    def by_trace(self, trace):
        """Resolve a trace id back to its record (None if unknown)."""
        with self._lock:
            rid = self._by_trace.get(trace)
            if rid is None:
                return None
            return _copy_record(self._records[rid])

    def trace_of(self, request_id):
        with self._lock:
            rec = self._records.get(request_id)
            return rec["trace"] if rec is not None else None

    def nonterminal_ids(self):
        """Request ids still in a non-terminal state — must be empty
        after drain/recovery (kill-chaos asserts this)."""
        with self._lock:
            return [rid for rid, rec in self._records.items()
                    if not rec["terminal"]]

    def snapshot(self, tenant_cap=None):
        """Aggregate census: counts by state and by tenant (behind the
        same hard cardinality cap the metrics registry enforces — the
        tail folds into ``other``), plus the loss/double-terminal
        counters the budgets gate."""
        cap = max(1, int(tenant_cap if tenant_cap is not None
                         else _env_int("PINT_TPU_TENANT_CAP", 32)))
        with self._lock:
            by_state = {}
            by_tenant = {}
            non_terminal = 0
            for rec in self._records.values():
                by_state[rec["state"]] = by_state.get(rec["state"], 0) + 1
                by_tenant[rec["tenant"]] = by_tenant.get(
                    rec["tenant"], 0) + 1
                if not rec["terminal"]:
                    non_terminal += 1
            counters = dict(self._counters)
            resident = len(self._records)
        if len(by_tenant) > cap:
            kept = sorted(by_tenant.items(),
                          key=lambda kv: (-kv[1], kv[0]))[:cap]
            other = sum(by_tenant.values()) - sum(v for _, v in kept)
            by_tenant = dict(kept)
            by_tenant["other"] = by_tenant.get("other", 0) + other
        return {"records": counters["submitted"],
                "resident": resident,
                "capacity": self._capacity,
                "non_terminal": non_terminal,
                "lost_records": counters["lost_records"],
                "double_terminal": counters["double_terminal"],
                "unknown_request": counters["unknown_request"],
                "terminal": counters["terminal"],
                "by_state": dict(sorted(by_state.items())),
                "by_tenant": dict(sorted(by_tenant.items()))}

    def export(self):
        """All resident records, JSON-safe (the ``--tail-out`` artifact
        and the chrome-trace converter consume this)."""
        with self._lock:
            return [_copy_record(rec)
                    for rec in self._records.values()]

    def __len__(self):
        with self._lock:
            return len(self._records)

    def reset(self):
        with self._lock:
            self._records = OrderedDict()
            self._by_trace = {}
            self._counters = {"submitted": 0, "terminal": 0,
                              "lost_records": 0, "double_terminal": 0,
                              "unknown_request": 0}


def _copy_record(rec):
    out = dict(rec)
    out["states"] = [dict(s) for s in rec["states"]]
    out["attrs"] = dict(rec["attrs"])
    return out


def phase_split(record):
    """Queue-wait vs service-time decomposition from one record's
    transition timestamps: time between consecutive states, plus the
    two headline aggregates (queue_wait_s = submitted -> executing,
    execute_s = executing -> terminal)."""
    states = record.get("states") or []
    per_state = {}
    t_sub = t_exec = t_term = None
    for prev, nxt in zip(states, states[1:]):
        key = prev["state"]
        per_state[key] = per_state.get(key, 0.0) \
            + (nxt["t"] - prev["t"])
    for s in states:
        if s["state"] == "submitted" and t_sub is None:
            t_sub = s["t"]
        if s["state"] == "executing":
            t_exec = s["t"]
        if s["state"] in TERMINAL_STATES:
            t_term = s["t"]
    queue_wait = (t_exec - t_sub) if (t_sub is not None
                                      and t_exec is not None) else None
    execute = (t_term - t_exec) if (t_exec is not None
                                    and t_term is not None) else None
    return {"per_state_s": per_state, "queue_wait_s": queue_wait,
            "execute_s": execute}


def tail_artifact(telemetry_snapshot, ledger):
    """Bundle everything ``resolve_tail`` needs into one JSON-safe
    dict: the serve snapshot's p99 + exemplars and the ledger's
    records. pint_serve_bench writes this via ``--tail-out``."""
    total = telemetry_snapshot.get("total_s") or {}
    return {"p99_s": total.get("p99"),
            "exemplars": telemetry_snapshot.get("exemplars") or [],
            "tenants": telemetry_snapshot.get("tenants") or {},
            "lifecycle": ledger.export()}


def resolve_tail(artifact):
    """Answer "why was this request slow" from a tail artifact: pick
    the exemplar nearest ABOVE the p99 (falling back to the max-latency
    exemplar), join it to its lifecycle record by trace/request id, and
    return the record with its queue-wait vs execute split and the
    flush trace id the delivery rode in on."""
    exemplars = sorted(artifact.get("exemplars") or [],
                       key=lambda e: e.get("value") or 0.0)
    if not exemplars:
        return {"resolved": False, "reason": "no_exemplars"}
    p99 = artifact.get("p99_s")
    pick = exemplars[-1]
    if p99 is not None:
        above = [e for e in exemplars if (e.get("value") or 0.0) >= p99]
        if above:
            pick = above[0]
    records = artifact.get("lifecycle") or []
    by_id = {r.get("request_id"): r for r in records}
    by_tr = {r.get("trace"): r for r in records}
    rec = by_id.get(pick.get("request_id")) or by_tr.get(pick.get("trace"))
    if rec is None:
        return {"resolved": False, "reason": "exemplar_not_in_ledger",
                "exemplar": pick}
    split = phase_split(rec)
    return {"resolved": True,
            "exemplar": pick,
            "p99_s": p99,
            "trace": rec.get("trace"),
            "request_id": rec.get("request_id"),
            "tenant": rec.get("tenant"),
            "states": [s["state"] for s in rec.get("states") or []],
            "queue_wait_s": split["queue_wait_s"],
            "execute_s": split["execute_s"],
            "per_state_s": split["per_state_s"],
            "flush_trace": (rec.get("attrs") or {}).get("flush_trace"),
            "record": rec}


#: Process-wide ledger the serve engine records into by default
#: (costmodel already owns the name LEDGER in the obs namespace).
REQLIFE = LifecycleLedger()
