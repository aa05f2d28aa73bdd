"""The port's SLO burn-rate monitor (obs/slo.py) and drift board
(obs/drift.py) against the JAX package's, and their wiring into the
serving engine.

- ``BurnRateMonitor`` over ``serve_slos`` (with ``tenant_slos``) on a
  fake clock: the same scripted snapshots give the JAX package's
  per-SLO states ingest by ingest, the same alert transitions, flight
  events and ``slo.*`` gauges.
- ``DriftBoard`` on seeded refit values with a step: the same alarms
  observation by observation, the same ``state_dict``, and each
  package's state loads into the other's board.
- ``ServeEngine.attach_slo`` / ``slo_check`` / ``attach_fit_quality``:
  a monitored stream is bitwise the plain one; ``state_dict()["drift"]``
  is the board's state and survives ``save_serve_state`` /
  ``restore_serve_state``; a lane refitted on TOAs with a step trips
  ``fit_anomaly`` and writes a flight dump; the front door's
  ``slo_check`` throttles an alerting tenant at admission.
"""

import json

import numpy as np
import pytest

from test_torch_serve import FakeClock, engine, pulsar, serve_mod, side


def _pkgs():
    import pint_tpu.obs as jobs
    import pint_tpu_torch.obs as tobs

    return {"jax": jobs, "torch": tobs}


def _snapshots():
    """A scripted serve-snapshot stream: healthy, a burst of failures
    and slow p99s (tenant "b" worst), then recovery."""
    out = []
    req = ok = shed = brk = 0
    rows = {"a": [0, 0], "b": [0, 0]}
    for k in range(60):
        bad = 20 <= k < 35
        n = 10
        req += n
        ok += n - (4 if bad else 0)
        shed += 1 if bad else 0
        brk += 1 if k == 30 else 0
        for t, r in rows.items():
            r[0] += n // 2
            r[1] += n // 2 - (3 if bad and t == "b" else 0)
        out.append((10.0 * k, {
            "requests": req, "requests_ok": ok,
            "counters": {"shed_queue_full": shed,
                         "rejected_circuit_open": brk},
            "total_s": {"p99": 0.4 if bad else 0.05},
            "devices": {"lost_lanes": []},
            "tenants": {t: {"requests": r[0], "ok": r[1],
                            "p99_s": 0.5 if bad and t == "b" else 0.02}
                        for t, r in rows.items()}}))
    return out


def _run_monitor(pkg):
    o = _pkgs()[pkg]
    reg = o.Registry()
    rec = o.FlightRecorder(capacity=256)
    mon = o.BurnRateMonitor(
        specs=o.serve_slos(tenants=["a", "b"], fast_window_s=60.0,
                           slow_window_s=300.0),
        clock=lambda: 0.0, registry=reg, recorder=rec)
    states = [mon.ingest(snap, t=t) for t, snap in _snapshots()]
    events = [{k: v for k, v in e.items() if k != "ts"}
              for e in rec.events()]
    return (states, mon.snapshot(), mon.alerting(), mon.alerts_fired,
            reg.snapshot(), events)


def test_burn_rate_monitor_matches_jax():
    j, t = _run_monitor("jax"), _run_monitor("torch")
    for sj, st in zip(j[0], t[0]):
        assert st == sj
    assert t[1:] == j[1:]
    assert t[3] > 0  # the burst fired alerts
    assert not t[2]  # and recovery cleared them
    whats = {e.get("what") for e in t[5]}
    assert {"slo_alert", "slo_resolved", "dump"} <= whats


def test_add_specs_and_spec_names_match_jax():
    o = _pkgs()
    names = {}
    for pkg in ("jax", "torch"):
        mon = o[pkg].BurnRateMonitor(specs=o[pkg].serve_slos(
            tenants=["x_y"]), registry=o[pkg].Registry())
        mon.add_specs(o[pkg].fit_quality_slos())
        names[pkg] = [s.name for s in mon.specs]
    assert names["torch"] == names["jax"]
    with pytest.raises(ValueError):
        o["torch"].SLOSpec("x", 0.0, bad="a")


def _drift_values(seed=4):
    rng = np.random.default_rng(seed)
    rounds = []
    for k in range(40):
        row = {}
        for p in range(3):
            x = np.array([1.0 + 1e-3 * p, -2.0, 0.5]) \
                + 1e-6 * rng.standard_normal(3)
            if p == 1 and k >= 30:
                x[0] += 5e-5  # a 50-sigma step in one pulsar's x[0]
            sig = np.full(3, 1e-6) * (1 + 0.01 * rng.standard_normal())
            row[f"PSR{p}"] = (x, sig, 1.0 + 0.05 * rng.standard_normal())
        rounds.append(row)
    return rounds


def _run_board(pkg):
    o = _pkgs()[pkg]
    board = o.DriftBoard(min_n=5, ledger=o.FitQualityLedger(),
                         recorder=o.FlightRecorder(capacity=64))
    alarms = []
    for row in _drift_values():
        for psr, (x, sig, rchi2) in row.items():
            alarms.append(board.observe(psr, o.drift.fit_drift_values(
                x, sig, rchi2, names=["F0", "F1", "DM"])))
    return board, alarms


def test_drift_board_matches_jax_and_state_crosses():
    jb, ja = _run_board("jax")
    tb, ta = _run_board("torch")
    assert ta == ja
    assert any(a for a in ta) and tb.alarms == jb.alarms > 0
    assert {a["pulsar"] for al in ta for a in al} == {"PSR1"}
    assert tb.snapshot() == jb.snapshot()
    st = tb.state_dict()
    assert json.loads(json.dumps(st)) == json.loads(json.dumps(
        jb.state_dict()))
    o = _pkgs()
    cross = o["jax"].DriftBoard()
    cross.load_state_dict(st)
    back = o["torch"].DriftBoard()
    back.load_state_dict(jb.state_dict())
    assert cross.state_dict() == jb.state_dict()
    assert back.state_dict() == st
    with pytest.raises(ValueError, match="not a DriftBoard"):
        back.load_state_dict({"kind": "x", "version": 1})


@pytest.fixture(scope="module")
def three():
    return [pulsar(i, 24) for i in range(3)]


def _fits(eng, ps, rounds=1):
    mod = serve_mod("torch")
    out = []
    for _ in range(rounds):
        for p in ps:
            m, t = side(p, "torch")
            out.append(eng.submit(mod.FitRequest(m, t, maxiter=2)))
        eng.drain()
    return out


def test_monitored_stream_bitwise_and_drift_state(three, tmp_path):
    from pint_tpu_torch.obs import (FITQ, DriftBoard, FitQualityLedger,
                                    FlightRecorder, Registry, fitquality,
                                    prometheus_text)
    from pint_tpu_torch.serve import result_digest
    from pint_tpu_torch.serve.recovery import (restore_serve_state,
                                               save_serve_state)

    plain = _fits(engine("torch", max_batch=3), three, rounds=2)
    eng = engine("torch", max_batch=3, durable_dir=tmp_path / "d")
    reg = Registry()
    mon = eng.attach_slo(registry=reg, recorder=FlightRecorder())
    try:
        board = eng.attach_fit_quality(board=DriftBoard(
            min_n=2, ledger=FitQualityLedger(), recorder=FlightRecorder()))
        watched = _fits(eng, three, rounds=2)
        states = eng.slo_check(t=100.0)
        snap = eng.snapshot()
        text = prometheus_text(eng.export_metrics(registry=reg))
        state = eng.state_dict()
        save_serve_state(eng)
    finally:
        fitquality.disable()
        FITQ.reset()
    assert [result_digest(r.value) for r in watched] == \
        [result_digest(r.value) for r in plain]
    assert [s["name"] for s in states] == [s.name for s in mon.specs]
    assert not any(s["alerting"] for s in states)
    assert snap["fit_quality"]["drift"] == board.snapshot()
    assert board.snapshot()["series"] == 3 * (1 + 2 * 3)
    assert "pint_tpu_fitq_drift_series 21" in text
    assert "pint_tpu_slo_availability_burn_fast" in text
    assert state["drift"] == board.state_dict()
    fresh = engine("torch", max_batch=3, durable_dir=tmp_path / "d")
    try:
        restore_serve_state(fresh, tmp_path / "d")
        assert fresh.state_dict()["drift"] == json.loads(
            json.dumps(board.state_dict()))
    finally:
        fitquality.disable()
        FITQ.reset()
    assert engine("torch").state_dict()["drift"] is None


def test_step_in_a_lane_trips_fit_anomaly(three, tmp_path):
    from pint_tpu_torch.obs import (FITQ, DriftBoard, FitQualityLedger,
                                    FlightRecorder, fitquality)

    mod = serve_mod("torch")
    rec = FlightRecorder(dump_dir=str(tmp_path))
    eng = engine("torch", max_batch=1)
    try:
        eng.attach_fit_quality(board=DriftBoard(
            min_n=3, ledger=FitQualityLedger(), recorder=rec))
        m, t = side(three[0], "torch")
        for _ in range(4):
            eng.submit(mod.FitRequest(m, t, maxiter=2))
        assert eng._fitq_board.alarms == 0
        step = t.mask(np.ones(len(t), bool))
        half = np.arange(len(step)) >= len(step) // 2
        step.adjust_times(np.where(half, 2e-5, 0.0))  # a 20 us step
        step.ensure_posvels()
        bad = eng.submit(mod.FitRequest(m, step, maxiter=2))
    finally:
        fitquality.disable()
        FITQ.reset()
    assert bad.status == "ok"
    assert eng._fitq_board.alarms > 0
    dumps = list(tmp_path.glob("flight_*fit_anomaly*.json"))
    assert dumps
    doc = json.loads(dumps[0].read_text())
    assert doc["reason"] == "fit_anomaly"


def test_front_door_slo_check_throttles_tenant():
    """The flusher's periodic slo_check (every slo_check_interval_s of
    the engine's clock) feeds admission: an alerting per-tenant SLO
    throttles that tenant at the door."""
    import time

    from pint_tpu_torch.obs import FlightRecorder, Registry, SLOSpec

    mod = serve_mod("torch")
    clock = FakeClock()
    aeng = mod.AsyncServeEngine(max_batch=2, bucket_floor=32, device="cpu",
                                clock=clock, slo_check_interval_s=1.0)
    try:
        spec = SLOSpec("tenant_bob_latency_p99", 0.01, value=lambda s: 1.0,
                       limit=0.0, fast_window_s=5.0, slow_window_s=10.0)
        aeng.attach_slo(specs=[spec], registry=Registry(),
                        recorder=FlightRecorder())
        deadline = time.monotonic() + 10.0
        while not aeng.admission.throttled_tenants():
            assert time.monotonic() < deadline, "the flusher never checked"
            clock.advance(1.0)
            time.sleep(0.02)
        assert set(aeng.admission.throttled_tenants()) == {"bob"}
        assert aeng.snapshot()["admission"]["throttled"] == ["bob"]
        states = aeng.slo_check(t=clock())
        assert states[0]["name"] == spec.name and states[0]["alerting"]
    finally:
        aeng.close()
