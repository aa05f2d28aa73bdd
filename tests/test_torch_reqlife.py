"""The port's request lifecycle ledger (obs/reqlife.py), tracing spans
(obs/trace.py) and serve telemetry (serve/metrics.py) against the JAX
package's, on the CPU.

The ledger, the phase split and the tail join are host bookkeeping:
both packages get the same calls on the same fake clocks and must
return equal snapshots, records and resolutions (trace ids aside, which
each package mints from its own tracer). The engine wiring is held to
tests/test_reqlife.py's contract in both engines on the same TOAs
(test_torch_serve.py's ``pulsar``): the same state sequence, terminal
states and tenants. Left out: the ``obs tail`` CLI (``obs/__main__.py``,
ROADMAP §1 item 3's observability queue) and the journal replay's
``replayed_committed``/``re_executed`` records (the durability queue).
"""

import warnings

import pytest

from test_torch_serve import FakeClock, engine, pulsar, serve_mod, side

warnings.simplefilter("ignore")

PKGS = ("jax", "torch")


def life(pkg):
    if pkg == "jax":
        import pint_tpu.obs.reqlife as mod
    else:
        import pint_tpu_torch.obs.reqlife as mod
    return mod


def strip_traces(obj):
    """A record or resolution without its trace ids (each package mints
    its own)."""
    if isinstance(obj, dict):
        return {k: strip_traces(v) for k, v in obj.items()
                if k not in ("trace", "flush_trace")}
    if isinstance(obj, list):
        return [strip_traces(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def one():
    return pulsar(3, 24)


def test_constants_and_env_names_match_jax():
    t, j = life("torch"), life("jax")
    assert t.TERMINAL_STATES == j.TERMINAL_STATES
    assert t.HAPPY_PATH == j.HAPPY_PATH
    assert t.LifecycleLedger().capacity == j.LifecycleLedger().capacity


def _bounded(pkg):
    led = life(pkg).LifecycleLedger(capacity=512, clock=lambda: 0.0)
    for i in range(10_000):
        led.submitted(f"r{i}", tenant=f"t{i % 3}")
        led.transition(f"r{i}", "delivered")
    lost = life(pkg).LifecycleLedger(capacity=8, clock=lambda: 0.0)
    for i in range(20):
        lost.submitted(f"r{i}")
    return len(led), led.snapshot(), len(lost), lost.snapshot()


def test_ledger_bounded_and_counts_lost_like_jax():
    j, t = _bounded("jax"), _bounded("torch")
    assert t == j
    n, snap, n_lost, lost = t
    assert n <= 512 and snap["records"] == 10_000
    assert snap["lost_records"] == 0 and snap["non_terminal"] == 0
    assert n_lost == 8 and lost["lost_records"] == 12


def _state_machine(pkg):
    led = life(pkg).LifecycleLedger(capacity=8, clock=lambda: 0.0)
    led.submitted("r0")
    led.transition("r0", "delivered")
    led.transition("r0", "shed", reason="deadline")  # refused
    ghost = led.transition("ghost", "delivered")
    tr = led.submitted("r1")
    led.transition("r1", "re_executed")
    again = led.submitted("r1") == tr
    by = led.by_trace(tr)["request_id"]
    return (strip_traces(led.record("r0")), ghost,
            strip_traces(led.record("r1")), again, by, led.snapshot(),
            led.nonterminal_ids())


def test_double_terminal_unknown_and_resubmit_like_jax():
    j, t = _state_machine("jax"), _state_machine("torch")
    assert t == j
    rec0, ghost, rec1, again, by, snap, open_ids = t
    assert [s["state"] for s in rec0["states"]] == ["submitted", "delivered"]
    assert ghost is None and again and by == "r1"
    assert rec1["terminal"] is False and rec1["state"] == "submitted"
    assert snap["double_terminal"] == 1 and snap["unknown_request"] == 1
    assert open_ids == ["r1"]


def _tenant_fold(pkg):
    led = life(pkg).LifecycleLedger(capacity=64, clock=lambda: 0.0)
    for i in range(10):
        for k in range(10 - i):
            led.submitted(f"r{i}-{k}", tenant=f"t{i}")
            led.transition(f"r{i}-{k}", "delivered")
    return led.snapshot(tenant_cap=3)


def test_snapshot_folds_tenant_tail_like_jax():
    j, t = _tenant_fold("jax"), _tenant_fold("torch")
    assert t == j
    assert set(t["by_tenant"]) == {"t0", "t1", "t2", "other"}
    assert t["by_tenant"]["other"] == sum(range(1, 8))


def test_phase_split_like_jax():
    rec = {"states": [{"state": "submitted", "t": 1.0},
                      {"state": "queued", "t": 1.0},
                      {"state": "packed", "t": 1.4},
                      {"state": "executing", "t": 1.5},
                      {"state": "delivered", "t": 2.25}]}
    j, t = life("jax").phase_split(rec), life("torch").phase_split(rec)
    assert t == j
    assert t["queue_wait_s"] == pytest.approx(0.5)
    assert t["execute_s"] == pytest.approx(0.75)


def _artifact(pkg):
    mod = life(pkg)
    led = mod.LifecycleLedger(capacity=16, clock=lambda: 0.0)
    traces = {}
    for i, total in enumerate([0.01, 0.02, 0.50]):
        rid = f"r{i}"
        traces[rid] = led.submitted(rid, tenant="alice" if i < 2 else "bob")
        led.transition(rid, "queued", t=0.0)
        led.transition(rid, "executing", t=total * 0.4)
        led.transition(rid, "delivered", t=total, flush_trace="t000099")
    tele = {"total_s": {"p99": 0.45},
            "exemplars": [
                {"value": 0.02, "trace": traces["r1"], "request_id": "r1",
                 "tenant": "alice"},
                {"value": 0.50, "trace": traces["r2"], "request_id": "r2",
                 "tenant": "bob"}],
            "tenants": {"alice": {"requests": 2}, "bob": {"requests": 1}}}
    art = mod.tail_artifact(tele, led)
    return (strip_traces(art), strip_traces(mod.resolve_tail(art)),
            mod.resolve_tail({"p99_s": None, "exemplars": [],
                              "lifecycle": []}))


def test_tail_artifact_and_resolution_like_jax():
    j, t = _artifact("jax"), _artifact("torch")
    assert t == j
    out = t[1]
    assert out["resolved"] is True and out["request_id"] == "r2"
    assert out["tenant"] == "bob"
    assert out["queue_wait_s"] == pytest.approx(0.2)
    assert out["execute_s"] == pytest.approx(0.3)
    assert t[2] == {"resolved": False, "reason": "no_exemplars"}


def test_registry_label_cap_folds_to_other(monkeypatch):
    from pint_tpu_torch.obs.metricsreg import Registry

    monkeypatch.setenv("PINT_TPU_LABEL_CAP", "2")
    reg = Registry()
    for t in ("a", "b", "c", "d"):
        reg.counter("serve.tenant.requests", labels={"tenant": t}).inc()
    counters = reg.snapshot()["counters"]
    assert counters['serve.tenant.requests{tenant="other"}'] == 2
    assert counters["metrics.label_overflow"] == 2


def _tenant_rows(pkg):
    tele = serve_mod(pkg).ServeTelemetry()
    for i in range(6):
        for k in range(6 - i):
            tele.record(request_id=f"r{i}-{k}", tenant=f"t{i}",
                        status="ok" if k % 4 else "shed",
                        total_s=0.01 * (i + 1) + 0.001 * k)
    tele.incr("flushes", 3)
    snap = tele.snapshot()
    snap.pop("exemplars")
    return tele.tenant_rows(cap=2), snap


def test_serve_telemetry_like_jax():
    j, t = _tenant_rows("jax"), _tenant_rows("torch")
    assert t == j
    rows, snap = t
    assert set(rows) == {"t0", "t1", "other"}
    assert sum(r["requests"] for r in rows.values()) == 21
    assert snap["counters"]["flushes"] == 3
    assert snap["counters"]["shed_queue_full"] == 0  # standing counter


def test_export_metrics_renders_prometheus(one):
    from pint_tpu_torch.obs.metricsreg import Registry, prometheus_text

    mod = serve_mod("torch")
    m, t = side(one, "torch")
    eng = engine("torch", max_batch=1)
    eng.submit(mod.ResidualRequest(m, t, tenant="alice"))
    reg = eng.export_metrics(registry=Registry())
    text = prometheus_text(reg)
    assert "pint_tpu_serve_requests_ok 1" in text
    assert 'pint_tpu_serve_tenant_requests{tenant="alice"} 1' in text
    assert "pint_tpu_serve_reqlife_terminal" in text
    assert eng.state_dict() == {"kind": "ServeEngineState", "version": 1,
                                "drift": None}
    eng.load_state_dict(eng.state_dict())
    with pytest.raises(ValueError, match="not a ServeEngineState"):
        eng.load_state_dict({"kind": "other", "version": 1})


# -- engine wiring, both packages ----------------------------------------


def _happy(pkg, one):
    mod = serve_mod(pkg)
    m, t = side(one, pkg)
    led = life(pkg).LifecycleLedger(capacity=64)
    eng = engine(pkg, max_batch=1, reqlife=led)
    res = eng.submit(mod.ResidualRequest(m, t, tenant="alice"))
    rec = led.record(res.request.request_id)
    clock = FakeClock()
    led2 = life(pkg).LifecycleLedger(capacity=64, clock=clock)
    eng2 = engine(pkg, max_batch=8, max_latency_s=0.2, clock=clock,
                  reqlife=led2)
    shed = eng2.submit(mod.ResidualRequest(m, t, deadline_s=0.1))
    clock.advance(0.3)
    eng2.poll()
    rec2 = led2.record(shed.request.request_id)
    return {"happy": (res.status, rec["tenant"], rec["terminal"],
                      [s["state"] for s in rec["states"]],
                      bool(rec["attrs"].get("flush_trace")),
                      res.telemetry.get("trace") == rec["trace"],
                      led.nonterminal_ids()),
            "shed": (shed.status, rec2["state"], rec2["terminal"],
                     [s.get("reason") for s in rec2["states"]
                      if s["state"] == "shed"], led2.nonterminal_ids())}


def test_engine_lifecycle_like_jax(one):
    j, t = _happy("jax", one), _happy("torch", one)
    assert t == j
    assert t["happy"] == ("ok", "alice", True,
                          ["submitted", "queued", "packed", "executing",
                           "delivered"], True, True, [])
    assert t["shed"] == ("shed", "shed", True, ["deadline"], [])


def test_ledger_detached_by_env_and_flag(one, monkeypatch):
    from pint_tpu_torch.obs import reqlife

    monkeypatch.setenv("PINT_TPU_REQLIFE", "0")
    assert engine("torch").reqlife is None
    monkeypatch.delenv("PINT_TPU_REQLIFE")
    assert engine("torch").reqlife is reqlife.REQLIFE
    assert engine("torch", reqlife=False).reqlife is None


def test_serve_stream_exactly_one_terminal_and_bitwise():
    """Every request of a served stream reaches exactly one terminal
    state, the ledger-on run is bitwise the ledger-off one, and the tail
    artifact resolves a real p99 exemplar (tests/test_reqlife.py's
    contract)."""
    from pint_tpu_torch.scripts.pint_serve_bench import run_serve_stream

    rep = run_serve_stream(n_requests=12, sizes=(32,), per_combo=1,
                           maxiter=2, bucket_floor=32, compare_offline=False,
                           tenants=("alice", "bob"), device="cpu")
    assert rep["reqlife_exactly_one_terminal"] is True
    assert rep["reqlife_nonterminal"] == rep["reqlife_lost_records"] == 0
    assert rep["reqlife_double_terminal"] == 0
    assert rep["reqlife_bitwise_on_off"] is True
    assert set(rep["tenants"]) == {"alice", "bob"}
    out = life("torch").resolve_tail(rep["tail_artifact"])
    assert out["resolved"] is True and out["tenant"] in ("alice", "bob")
    assert out["queue_wait_s"] is not None and out["execute_s"] is not None


# -- tracing spans ---------------------------------------------------------


def _spans(pkg):
    if pkg == "jax":
        from pint_tpu.obs import trace
    else:
        from pint_tpu_torch.obs import trace
    trace.reset()
    assert trace.span("x") is trace.NOOP_SPAN and not trace.enabled()
    capacity = trace.TRACER._spans.maxlen
    trace.enable(capacity=4)
    try:
        with trace.span("outer", a=1) as sp:
            tid = trace.current_trace_id()
            with trace.span("inner") as inner:
                inner.set(b=2)
            sp.set(c=3)
        with pytest.raises(ZeroDivisionError):
            with trace.span("boom"):
                1 / 0
        for i in range(5):
            with trace.span(f"s{i}", trace_id="tX"):
                pass
    finally:
        trace.disable()
    got = trace.spans()
    trace.reset()
    # give the ring its capacity back: later tests in this process read
    # more than 4 spans
    trace.enable(capacity=capacity)
    trace.disable()
    return tid is not None, [(s["name"], s["status"], s["attrs"],
                              s["parent"] is None) for s in got]


def test_trace_spans_like_jax():
    j, t = _spans("jax"), _spans("torch")
    assert t == j
    assert t[1] == [("s1", "ok", {}, True), ("s2", "ok", {}, True),
                    ("s3", "ok", {}, True), ("s4", "ok", {}, True)]


def test_trace_profiler_ranges_named_by_span():
    """enable(jax_annotations=True) opens a torch profiler range per
    span, so a profile of a served flush names serve.pack and
    serve.run."""
    import torch

    from pint_tpu_torch.obs import trace

    trace.reset()
    trace.enable(jax_annotations=True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.span("serve.pack"):
                torch.ones(4).sum()
            with trace.span("serve.run"):
                torch.ones(4).sum()
        assert trace.TRACER.jax_annotations is True
    finally:
        trace.disable()
        trace.reset()
    names = {e.key for e in prof.key_averages()}
    assert {"serve.pack", "serve.run"} <= names
