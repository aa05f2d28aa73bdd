"""Exporters: Chrome trace-event (Perfetto) timelines and JSON dumps
(the JAX package's ``obs/export.py``).

``chrome_trace`` turns the tracer's finished-span ring into the
Trace Event Format chrome://tracing and https://ui.perfetto.dev load
directly: one complete ("ph": "X") event per span, microsecond
timestamps rebased to the earliest span, one tid per Python thread so
the fleet pipeline's prep pool / compile pool / caller thread render
as separate timeline rows. Prometheus text rendering lives with the
registry in :mod:`pint_tpu_torch.obs.metricsreg`.
"""

from __future__ import annotations

import json


def chrome_trace(spans, process_name="pint_tpu_torch"):
    """Trace Event Format document (dict) for a list of span dicts
    (as produced by ``Tracer.snapshot()`` or a flight-recorder dump's
    span events)."""
    spans = [s for s in spans
             if s.get("t0") is not None and s.get("t1") is not None]
    epoch = min((s["t0"] for s in spans), default=0.0)
    tids = {}
    events = [{"ph": "M", "pid": 1, "tid": 0,
               "name": "process_name",
               "args": {"name": process_name}}]
    for s in spans:
        tid = tids.setdefault(s.get("thread") or "main",
                              len(tids) + 1)
        args = dict(s.get("attrs") or {})
        args["trace"] = s.get("trace")
        args["span"] = s.get("span")
        if s.get("parent") is not None:
            args["parent"] = s["parent"]
        if s.get("status") and s["status"] != "ok":
            args["status"] = s["status"]
        events.append({
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "name": s["name"],
            "cat": str(s.get("trace") or "trace"),
            "ts": round((s["t0"] - epoch) * 1e6, 3),
            "dur": round((s["t1"] - s["t0"]) * 1e6, 3),
            "args": args,
        })
    for thread, tid in tids.items():
        events.append({"ph": "M", "pid": 1, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": thread}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, spans=None, process_name="pint_tpu_torch"):
    """Export spans (default: the live tracer ring) as a Chrome
    trace-event JSON file; returns the path."""
    if spans is None:
        from . import trace

        spans = trace.spans()
    with open(path, "w") as fh:
        # default=str: span attrs carry raw site values (cache keys
        # are nested tuples) so the hot path never pays for repr()
        json.dump(chrome_trace(spans, process_name=process_name), fh,
                  default=str)
    return path


def reqlife_spans(records):
    """Convert request-lifecycle records (``LifecycleLedger.export()``)
    into span dicts for :func:`chrome_trace`: one complete span per
    consecutive state interval, one timeline row per tenant — the
    request plane rendered next to the ``serve.*`` spans it joins via
    trace ids."""
    spans = []
    for rec in records or []:
        states = rec.get("states") or []
        for prev, nxt in zip(states, states[1:]):
            spans.append({
                "name": "req.%s" % prev["state"],
                "trace": rec.get("trace"),
                "thread": "tenant:%s" % (rec.get("tenant") or "anon"),
                "t0": prev.get("t"), "t1": nxt.get("t"),
                "attrs": {"request_id": rec.get("request_id"),
                          "tenant": rec.get("tenant"),
                          "next_state": nxt.get("state"),
                          "reason": nxt.get("reason"),
                          "flush_trace": (rec.get("attrs") or {})
                          .get("flush_trace")},
            })
    return spans


def flight_spans(doc):
    """Pull the span events back out of a flight-recorder dump dict
    (``kind == "span"`` entries), ready for :func:`chrome_trace`."""
    return [{k: v for k, v in ev.items() if k != "kind"}
            for ev in doc.get("events", ()) if ev.get("kind") == "span"]
