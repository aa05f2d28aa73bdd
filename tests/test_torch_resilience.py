"""The port's resilience layer (pint_tpu_torch/resilience/: fault
injection, retry/backoff, circuit breaker, health) and the engine's
fault handling against the JAX package's, on the CPU.

The pure-Python primitives run in both packages on the same seeds and
must agree exactly: fire patterns, backoff delays, breaker and health
transitions, state round trips (each package restores the other's
snapshot). The engine scenarios of tests/test_resilience.py (intake
rejection, injected poison, lane quarantine, retried compile failures,
bisection, the flush watchdog, the breaker through the engine,
unexpected recompiles, draining) run through both engines with a fake
clock on the same TOAs (test_torch_serve.py's ``pulsar``) and must give
the same statuses, reasons, counters and health; fit values are held at
test_torch_serve.py's tiers. Left out, with the modules that wait
(ROADMAP §1 item 3, durability): checkpoint integrity, the chaos and
kill streams, the coordinator timeout, device lanes.
"""

import copy
import json
import warnings

import numpy as np
import pytest

from test_torch_serve import FakeClock, engine, pulsar, serve_mod, side

warnings.simplefilter("ignore")

PKGS = ("jax", "torch")


def res_mod(pkg):
    if pkg == "jax":
        import pint_tpu.resilience as mod
    else:
        import pint_tpu_torch.resilience as mod
    return mod


@pytest.fixture(autouse=True)
def _disarm_everything():
    yield
    res_mod("jax").disarm()
    res_mod("torch").disarm()


@pytest.fixture(scope="module")
def two():
    return [pulsar(0, 24), pulsar(1, 24)]


def fake_engine(pkg, clock=None, **kw):
    clock = clock or FakeClock()
    return engine(pkg, clock=clock, sleep=clock.advance, **kw), clock


def both(scenario, *args):
    """The scenario's summary from each package: (jax, torch)."""
    return scenario("jax", *args), scenario("torch", *args)


# -- the fault registry ---------------------------------------------------


def test_fault_point_determinism_matches_jax():
    out = {}
    for pkg in PKGS:
        fi = res_mod(pkg)
        a = fi.FaultPoint("toa_nan", rate=0.3, seed=7)
        c = fi.FaultPoint("toa_nan", count=2, after=3)
        out[pkg] = ([a.should_fire() for _ in range(200)],
                    [c.should_fire() for _ in range(8)])
    assert out["torch"] == out["jax"]
    assert 20 < sum(out["torch"][0]) < 100
    assert out["torch"][1] == [False, False, False, True, True, False,
                               False, False]


@pytest.mark.parametrize("pkg", PKGS)
def test_fire_requires_arming(pkg):
    fi = res_mod(pkg)
    assert fi.fire("toa_nan") is None
    with fi.inject("toa_nan"):
        out = fi.fire("toa_nan", request_id="r1")
        assert out == {"request_id": "r1", "point": "toa_nan", "fire": 1}
        assert "toa_nan" in fi.armed()
    assert fi.armed() == {} and fi.fire("toa_nan") is None


def test_parse_spec_and_env_match_jax(monkeypatch):
    spec = ("toa_nan:rate=0.05,seed=7;compile_fail:count=1,retryable=false;"
            "solver_diverge:lanes=0+2;dispatch_slow:delay_s=0.5;"
            "device_loss:lane=1;flusher_stall:hang_s=0.01")
    got = {}
    for pkg in PKGS:
        fi = res_mod(pkg)
        got[pkg] = [(p.name, p.rate, p.count, p.after, p.seed, p.payload)
                    for p in fi.parse_spec(spec)]
        with pytest.raises(ValueError, match="unknown fault point"):
            fi.parse_spec("not_a_point")
        monkeypatch.setenv("PINT_TPU_FAULTS", "toa_nan:rate=0.5")
        assert [p.name for p in fi.arm_from_env()] == ["toa_nan"]
        assert fi.armed()["toa_nan"].rate == 0.5
        fi.disarm()
    assert got["torch"] == got["jax"]
    assert got["torch"][1][5] == {"retryable": False}
    assert got["torch"][2][5] == {"lanes": [0, 2]}


def test_kill_sites_peek_without_firing():
    fi = res_mod("torch")
    assert fi.POINTS == res_mod("jax").POINTS
    with fi.inject(fi.FaultPoint("process_kill",
                                 payload={"at": "pre_commit"})):
        assert fi.faultinject.kill_armed_at("pre_commit")
        assert not fi.faultinject.kill_armed_at("post_commit")
        assert fi.fire_kill("post_commit") is False
        assert fi.armed()["process_kill"].checks == 0


# -- retry / backoff / breaker -------------------------------------------


def test_backoff_matches_jax():
    d = {pkg: res_mod(pkg).BackoffPolicy(max_attempts=6, base_s=0.05,
                                         max_s=0.4, seed=3).delays(5)
         for pkg in PKGS}
    assert d["torch"] == d["jax"]
    for i, v in enumerate(d["torch"]):
        raw = min(0.4, 0.05 * 2.0 ** i)
        assert 0.5 * raw <= v <= 1.5 * raw
    nojit = res_mod("torch").BackoffPolicy(jitter_frac=0.0, base_s=0.1,
                                           max_s=0.3)
    assert nojit.delays(4) == [0.1, 0.2, 0.3, 0.3]


@pytest.mark.parametrize("pkg", PKGS)
def test_with_retries_transient_then_success(pkg):
    r = res_mod(pkg)
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise r.FaultInjected("compile_fail", retryable=True)
        return "done"

    out = r.with_retries(flaky, r.BackoffPolicy(max_attempts=4, seed=0),
                         sleep=slept.append)
    assert out == "done" and len(calls) == 3 and len(slept) == 2


def test_retry_classification_matches_jax():
    exc = [ValueError("bad request"), TimeoutError(), OSError(),
           RuntimeError("UNAVAILABLE: relay"), RuntimeError("boom"),
           KeyError("x")]
    for pkg in PKGS:
        r = res_mod(pkg)
        got = [r.is_retryable(e) for e in exc] + [
            r.is_retryable(r.FaultInjected("compile_fail", retryable=False))]
        assert got == [False, True, True, True, False, False, False]
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("bad request")

    r = res_mod("torch")
    with pytest.raises(ValueError):
        r.with_retries(broken, r.BackoffPolicy(max_attempts=5),
                       sleep=lambda s: None)
    assert len(calls) == 1


def _breaker_lifecycle(pkg):
    clock = FakeClock()
    br = res_mod(pkg).CircuitBreaker(threshold=2, cooldown_s=10.0,
                                     clock=clock)
    trail = [br.allow("slot"), br.record_failure("slot"),
             br.record_failure("slot"), br.state("slot"), br.allow("slot"),
             br.retry_after_s("slot")]
    clock.advance(10.1)
    trail += [br.state("slot"), br.allow("slot"), br.allow("slot")]
    br.record_failure("slot")
    trail.append(br.state("slot"))
    clock.advance(10.1)
    trail.append(br.allow("slot"))
    br.record_success("slot")
    trail += [br.state("slot"), br.allow("slot"), br.snapshot()]
    return trail


def test_circuit_breaker_lifecycle_matches_jax():
    j, t = both(_breaker_lifecycle)
    assert t == j
    assert t == [True, False, True, "open", False, pytest.approx(10.0),
                 "half_open", True, False, "open", True, "closed", True,
                 {"trips": 1, "open": 0, "tracked_keys": 1}]


def test_breaker_state_round_trips_across_packages():
    """An open key's cooldown serializes as remaining seconds and
    re-anchors on the restoring clock, whichever package saved it."""
    states = {}
    for pkg in PKGS:
        clock = FakeClock()
        br = res_mod(pkg).CircuitBreaker(threshold=2, cooldown_s=10.0,
                                         clock=clock)
        br.record_failure(("lane", 0))
        br.record_failure(("lane", 0))
        clock.advance(4.0)
        states[pkg] = br.state_dict()
    assert states["torch"] == states["jax"]
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        clock2 = FakeClock()
        clock2.advance(12345.0)
        br2 = res_mod(dst).CircuitBreaker(threshold=2, cooldown_s=10.0,
                                          clock=clock2)
        assert br2.load_state_dict(json.loads(json.dumps(states[src])))
        assert br2.state(("lane", 0)) == "open"
        assert br2.retry_after_s(("lane", 0)) == pytest.approx(6.0)
        clock2.advance(6.1)
        assert br2.state(("lane", 0)) == "half_open"
    br = res_mod("torch").CircuitBreaker(clock=FakeClock())
    with pytest.warns(UserWarning, match="version/kind mismatch"):
        assert not br.load_state_dict({"version": 99,
                                       "kind": "circuit_breaker"})
    assert br.state("anything") == "closed"


# -- health ---------------------------------------------------------------


def _health_transitions(pkg):
    clock = FakeClock()
    h = res_mod(pkg).HealthMonitor(clock=clock, window=8, min_events=4,
                                   degraded_shed_rate=0.25,
                                   draining_shed_rate=0.75, recovery_s=10.0)
    trail = []
    for s in ["ok"] * 3 + ["shed"] * 7:
        h.note_request(s)
        trail.append((h.state, list(h.reasons)))
    for _ in range(8):
        h.note_request("rejected", "draining")
        h.note_request("ok")
    for _ in range(2):
        clock.advance(10.1)
        h.note_request("ok")
        trail.append((h.state, list(h.reasons)))
    quiet = res_mod(pkg).HealthMonitor(clock=FakeClock(), window=8,
                                       min_events=4)
    for _ in range(20):
        quiet.note_request("rejected", "nonfinite_input")
    return trail, h.snapshot(), quiet.state, quiet.shed_rate()


def test_health_transitions_match_jax():
    j, t = both(_health_transitions)
    assert t == j
    trail = t[0]
    assert trail[3] == ("degraded", ["shed_rate"])
    assert trail[9][0] == "draining" and "shed_rate_critical" in trail[9][1]
    assert trail[-1][0] == "healthy"
    assert t[2:] == ("healthy", 0.0)


def test_health_state_round_trips_across_packages():
    states = {}
    for pkg in PKGS:
        clock = FakeClock()
        h = res_mod(pkg).HealthMonitor(clock=clock, window=8, min_events=4,
                                       degraded_shed_rate=0.25,
                                       recovery_s=10.0)
        for s in ("ok", "ok", "ok", "shed"):
            h.note_request(s)
        states[pkg] = h.state_dict()
    assert states["torch"] == states["jax"]
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        clock2 = FakeClock()
        clock2.advance(777.0)
        h2 = res_mod(dst).HealthMonitor(clock=clock2, window=8,
                                        min_events=4,
                                        degraded_shed_rate=0.25,
                                        recovery_s=10.0)
        assert h2.load_state_dict(states[src])
        assert h2.state == "degraded" and "shed_rate" in h2.reasons
        for _ in range(8):
            h2.note_request("ok")
        for _ in range(2):
            clock2.advance(10.1)
            h2.note_request("ok")
        assert h2.state == "healthy"
    h = res_mod("torch").HealthMonitor(clock=FakeClock())
    with pytest.warns(UserWarning, match="version/kind mismatch"):
        assert not h.load_state_dict({"version": 0,
                                      "kind": "health_monitor",
                                      "state": "healthy"})


# -- the engine's fault handling, both packages ---------------------------


def _intake(pkg, two):
    mod = serve_mod(pkg)
    (m0, t0), (m1, t1) = side(two[0], pkg), side(two[1], pkg)
    bad = copy.deepcopy(t0)
    bad.sec = np.array(bad.sec)
    bad.sec[3] = np.nan
    eng, _ = fake_engine(pkg, max_batch=2)
    rb = eng.submit(mod.FitRequest(m0, bad, maxiter=2))
    rg = eng.submit(mod.FitRequest(m1, t1, maxiter=2))
    eng.drain()
    inf_err = copy.deepcopy(t0)
    inf_err.error_us = np.array(inf_err.error_us)
    inf_err.error_us[0] = np.inf
    e1, _ = fake_engine(pkg, max_batch=1)
    ri = e1.submit(mod.ResidualRequest(m0, inf_err))
    bary = copy.deepcopy(t0)
    bary.freq_mhz = np.full_like(np.array(bary.freq_mhz), np.inf)
    detail = dict(rb.telemetry["detail"])
    detail.pop("request_id")  # each package mints its own ids
    return {"bad": (rb.status, rb.reason, detail),
            "good": rg.status,
            "counter": eng.telemetry.counters["rejected_nonfinite_input"],
            "health": eng.snapshot()["health"]["state"],
            "inf_err": (ri.status, ri.telemetry["detail"]),
            "inf_freq": mod.ServeEngine._nonfinite_counts(
                mod.ResidualRequest(m0, bary)),
            "x": rg.value["x"]}


def test_intake_rejects_nonfinite_like_jax(two):
    j, t = both(_intake, two)
    assert t["bad"] == j["bad"] == ("rejected", "nonfinite_input",
                                    {"nonfinite_values": 1,
                                     "nonfinite_errors": 0})
    assert t["good"] == j["good"] == "ok"
    assert t["counter"] == j["counter"] == 1
    assert t["health"] == j["health"] == "healthy"
    assert t["inf_err"][0] == j["inf_err"][0] == "rejected"
    assert t["inf_err"][1]["nonfinite_errors"] == 1
    assert t["inf_freq"] == j["inf_freq"] == (0, 0)


def _injected(pkg, two):
    r = res_mod(pkg)
    mod = serve_mod(pkg)
    m0, t0 = side(two[0], pkg)
    sec_before = np.array(t0.sec, copy=True)
    err_before = np.array(t0.error_us, copy=True)
    out = []
    for point in ("toa_nan", "toa_inf_error"):
        eng, _ = fake_engine(pkg, max_batch=1)
        with r.inject(r.FaultPoint(point)):
            req = mod.FitRequest(m0, t0, maxiter=2)
            res = eng.submit(req)
        d = dict(res.telemetry["detail"])
        d.pop("request_id")
        out.append((res.status, res.reason, d, req.toas is t0))
    assert np.array_equal(np.array(t0.sec), sec_before)
    assert np.array_equal(np.array(t0.error_us), err_before)
    return out


def test_injected_poison_never_mutates_caller_like_jax(two):
    j, t = both(_injected, two)
    assert t == j
    assert t[0] == ("rejected", "nonfinite_input",
                    {"nonfinite_values": 1, "nonfinite_errors": 0,
                     "injected_point": "toa_nan"}, True)
    assert t[1][2]["injected_point"] == "toa_inf_error"


def _quarantine(pkg, two):
    r = res_mod(pkg)
    mod = serve_mod(pkg)
    (m0, t0), (m1, t1) = side(two[0], pkg), side(two[1], pkg)
    eng, _ = fake_engine(pkg, max_batch=2)
    with r.inject(r.FaultPoint("solver_diverge", count=1,
                               payload={"lanes": [0]})):
        r0 = eng.submit(mod.FitRequest(m0, t0, maxiter=3))
        r1 = eng.submit(mod.FitRequest(m1, t1, maxiter=3))
    return (r0.status, r0.reason, r0.telemetry["detail"]["quarantined"],
            r1.status, eng.telemetry.counters["quarantined"],
            eng.executables_compiled), r1.value


def test_quarantine_isolates_poisoned_lane_like_jax(two):
    from test_torch_serve import assert_fit_close
    from pint_tpu_torch.parallel import PTABatch

    (j, jv), (t, tv) = both(_quarantine, two)
    assert t == j == ("rejected", "solver_diverged", True, "ok", 1, 1)
    x, chi2, cov = PTABatch([two[1][3]], [two[1][4]],
                            device="cpu").wls_fit(maxiter=3)
    assert_fit_close(tv, {"x": x[0], "chi2": chi2[0], "cov": cov[0]})
    assert_fit_close(tv, {"x": np.asarray(jv["x"]), "chi2": jv["chi2"],
                          "cov": np.asarray(jv["cov"])}, relative=False)


def _retries(pkg, two):
    r = res_mod(pkg)
    mod = serve_mod(pkg)
    (m0, t0), (m1, t1) = side(two[0], pkg), side(two[1], pkg)
    eng, clock = fake_engine(pkg, max_batch=1)
    with r.inject(r.FaultPoint("compile_fail", count=1)):
        res = eng.submit(mod.ResidualRequest(m0, t0))
    out = {"retried": (res.status, eng.telemetry.counters["retries"],
                       clock.t > 0)}
    eng, _ = fake_engine(pkg, max_batch=2)
    with r.inject(r.FaultPoint("compile_fail", count=1,
                               payload={"retryable": False})):
        a = eng.submit(mod.ResidualRequest(m0, t0))
        b = eng.submit(mod.ResidualRequest(m1, t1))
    out["bisect"] = (a.status, b.status,
                     eng.telemetry.counters["flush_bisects"],
                     eng.telemetry.counters.get("retries"))
    return out


def test_compile_fail_retried_and_bisected_like_jax(two):
    j, t = both(_retries, two)
    assert t == j
    assert t["retried"] == ("ok", 1, True)
    assert t["bisect"] == ("ok", "ok", 1, None)


def _watchdog(pkg, two):
    r = res_mod(pkg)
    mod = serve_mod(pkg)
    m0, t0 = side(two[0], pkg)
    clock = FakeClock()
    health = r.HealthMonitor(clock=clock, flush_watchdog_s=5.0,
                             recovery_s=30.0)
    eng, _ = fake_engine(pkg, clock=clock, max_batch=1, health=health)
    with r.inject(r.FaultPoint("dispatch_slow", count=1,
                               payload={"delay_s": 9.0})):
        res = eng.submit(mod.ResidualRequest(m0, t0))
    snap = eng.snapshot()["health"]
    clock.advance(61.0)
    eng.submit(mod.ResidualRequest(m0, t0))
    eng.drain()
    return (res.status, snap["state"], snap["reasons"],
            snap["watchdog_breaches"], eng.snapshot()["health"]["state"])


def test_dispatch_slow_trips_watchdog_like_jax(two):
    j, t = both(_watchdog, two)
    assert t == j == ("ok", "degraded", ["flush_watchdog"], 1, "healthy")


def _breaker_engine(pkg, two):
    r = res_mod(pkg)
    mod = serve_mod(pkg)
    m0, t0 = side(two[0], pkg)
    clock = FakeClock()
    breaker = r.CircuitBreaker(threshold=2, cooldown_s=30.0, clock=clock)
    eng, _ = fake_engine(pkg, clock=clock, max_batch=1, breaker=breaker)
    with r.inject(r.FaultPoint("compile_fail",
                               payload={"retryable": False})):
        r1 = eng.submit(mod.ResidualRequest(m0, t0))
        r2 = eng.submit(mod.ResidualRequest(m0, t0))
        r3 = eng.submit(mod.ResidualRequest(m0, t0))
    mid = eng.snapshot()["health"]["state"]
    clock.advance(30.1)
    r4 = eng.submit(mod.ResidualRequest(m0, t0))
    return (r1.status, r2.status, r1.reason, r3.status, r3.reason,
            r3.telemetry["detail"]["retry_after_s"], mid, r4.status,
            breaker.state(next(iter(breaker._keys))), breaker.snapshot())


def test_breaker_trips_and_recovers_through_engine_like_jax(two):
    j, t = both(_breaker_engine, two)
    assert t == j
    assert t[:2] == ("error", "error")
    assert t[2] == "FaultInjected: injected fault: compile_fail"
    assert t[3:5] == ("rejected", "circuit_open") and t[5] > 0
    assert t[6] != "healthy" and t[7:9] == ("ok", "closed")


def _recompile_and_drain(pkg, two):
    r = res_mod(pkg)
    mod = serve_mod(pkg)
    m0, t0 = side(two[0], pkg)
    clock = FakeClock()
    breaker = r.CircuitBreaker(threshold=1, cooldown_s=30.0, clock=clock)
    eng, _ = fake_engine(pkg, clock=clock, max_batch=1, breaker=breaker)
    req = mod.ResidualRequest(m0, t0)
    key = eng.batcher.slot_key(req, mod.policy.resolve(req))
    eng._slot_exec_keys[key] = {"sentinel-executable"}
    res = eng.submit(mod.ResidualRequest(m0, t0))
    follow = eng.submit(mod.ResidualRequest(m0, t0))
    health = r.HealthMonitor(clock=clock, min_events=2,
                             draining_shed_rate=0.5)
    health.note_request("shed")
    health.note_request("shed")
    d_eng, _ = fake_engine(pkg, clock=clock, max_batch=1, health=health)
    drained = d_eng.submit(mod.ResidualRequest(m0, t0))
    snap = d_eng.snapshot()
    json.dumps(snap)
    return (res.status, eng.telemetry.counters["unexpected_recompiles"],
            breaker.open_count(), follow.status, follow.reason,
            drained.status, drained.reason,
            d_eng.telemetry.counters["rejected_draining"],
            sorted(snap["breaker"]))


def test_unexpected_recompile_and_draining_like_jax(two):
    j, t = both(_recompile_and_drain, two)
    assert t == j == ("ok", 1, 1, "rejected", "circuit_open", "rejected",
                      "draining", 1, ["open", "tracked_keys", "trips"])


def test_pta_solver_diverge_isolates_lane(two):
    from pint_tpu_torch.parallel import PTABatch

    fi = res_mod("torch")
    ms, ts = [two[0][3], two[1][3]], [two[0][4], two[1][4]]
    x_clean, _, _ = PTABatch(ms, ts, device="cpu").wls_fit(maxiter=2)
    pta2 = PTABatch(ms, ts, device="cpu")
    with fi.inject(fi.FaultPoint("solver_diverge", count=1,
                                 payload={"lanes": [1]})):
        with pytest.warns(UserWarning, match="diverged"):
            x, chi2, _ = pta2.wls_fit(maxiter=2)
    assert list(pta2.diverged) == [1] and not np.isfinite(chi2[1])
    np.testing.assert_allclose(x[0], x_clean[0], rtol=1e-12)
    np.testing.assert_array_equal(x[1], pta2._x0().numpy()[1])
