"""The port's async front door (serve/frontdoor.py: IntakeQueue,
AsyncServeEngine with its flusher watchdog) and admission control
(serve/admission.py) against the JAX package's, on the CPU.

The admission ladder runs in both packages on the same fake clocks and
must decide alike. The front door is held to tests/test_async_serve.py's
contract on the same TOAs (test_torch_serve.py's ``pulsar``): async
results bitwise the port's sync engine and the JAX async engine's within
test_torch_serve.py's tiers, concurrent submits under tests/lockcheck.py's
runtime instrumentation of the port's shared classes, a stalled and a
dead flusher replaced by the watchdog, injected intake overflow, a crash
in the flusher's handler, the shutdown race and tenant isolation. Left
out with the modules that wait: the static lock-order DAG (the JAX
package's ``analysis/``, ROADMAP §1 item 5), journal commits (item 3's
durability queue) and the open-loop arrival sweep (item 3).
"""

import sys
import threading
import time
import types
import warnings

import numpy as np
import pytest

from lockcheck import assert_no_violations, instrument
from test_torch_serve import assert_fit_close, pulsar

warnings.simplefilter("ignore")

PKGS = ("jax", "torch")


def serve(pkg):
    if pkg == "jax":
        import pint_tpu.serve as mod
    else:
        import pint_tpu_torch.serve as mod
    return mod


def ledger(pkg):
    if pkg == "jax":
        from pint_tpu.obs.reqlife import LifecycleLedger
    else:
        from pint_tpu_torch.obs.reqlife import LifecycleLedger
    return LifecycleLedger()


@pytest.fixture(scope="module")
def two():
    return [pulsar(0, 24), pulsar(1, 24)]


def reqs(pkg, two, n, **kw):
    mod = serve(pkg)
    k = (1, 2) if pkg == "jax" else (3, 4)
    return [mod.FitRequest(two[i % 2][k[0]], two[i % 2][k[1]], maxiter=2,
                           **kw) for i in range(n)]


def async_engine(pkg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_latency_s", 1e9)
    kw.setdefault("bucket_floor", 32)
    if pkg == "torch":
        kw["device"] = "cpu"
    return serve(pkg).AsyncServeEngine(**kw)


def wait_for(pred, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


# -- digest parity -------------------------------------------------------


def test_async_results_bitwise_sync_and_close_to_jax(two):
    mod = serve("torch")
    sync = mod.ServeEngine(max_batch=4, max_latency_s=1e9, bucket_floor=32,
                           device="cpu")
    ref = sync.run_stream(reqs("torch", two, 6))
    got = {}
    for pkg in PKGS:
        eng = async_engine(pkg)
        try:
            handles = [eng.submit(r) for r in reqs(pkg, two, 6)]
            eng.drain()
        finally:
            eng.close()
        assert all(h.status == "ok" for h in handles)
        got[pkg] = [h.value for h in handles]
    assert [mod.result_digest(r.value) for r in ref] == \
        [mod.result_digest(v) for v in got["torch"]]
    for mine, theirs in zip(got["torch"], got["jax"]):
        assert_fit_close(mine, {"x": np.asarray(theirs["x"]),
                                "chi2": theirs["chi2"],
                                "cov": np.asarray(theirs["cov"])},
                         relative=False)


# -- concurrent submits under lock instrumentation -----------------------


def test_concurrent_stress_lock_discipline(two):
    from pint_tpu_torch.obs.reqlife import TERMINAL_STATES
    from pint_tpu_torch.serve import FitRequest
    from pint_tpu_torch.serve.admission import AdmissionController
    from pint_tpu_torch.serve.batcher import MicroBatcher
    from pint_tpu_torch.serve.frontdoor import IntakeQueue
    from pint_tpu_torch.serve.metrics import ServeTelemetry

    led = ledger("torch")
    eng = async_engine("torch", max_queue=64, reqlife=led)
    eng.prewarm(reqs("torch", two, 2))
    n_producers, per_producer = 4, 8
    tenants = ("alice", "bob", "carol", "dave")
    handles = [[None] * per_producer for _ in range(n_producers)]

    def producer(pid):
        for k in range(per_producer):
            p = two[(pid + k) % 2]
            handles[pid][k] = eng.submit(FitRequest(
                p[3], p[4], maxiter=2, tenant=tenants[pid],
                priority=k % 3))

    violations = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        with instrument(ServeTelemetry, violations,
                        dict_attrs=("counters",),
                        instances=(eng.telemetry,)), \
             instrument(MicroBatcher, violations, dict_attrs=("_slots",),
                        instances=(eng.batcher,)), \
             instrument(IntakeQueue, violations, instances=(eng.intake,)), \
             instrument(AdmissionController, violations,
                        dict_attrs=("_buckets", "_burning", "_throttled"),
                        instances=(eng.admission,)):
            threads = [threading.Thread(target=producer, args=(pid,))
                       for pid in range(n_producers)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60.0)
            assert not any(th.is_alive() for th in threads)
            eng.drain()
    finally:
        sys.setswitchinterval(switch)
        eng.close()
    assert_no_violations(violations)
    flat = [h for row in handles for h in row]
    assert all(h.done and h.status in ("ok", "shed") for h in flat)
    assert led.nonterminal_ids() == []
    for h in flat:
        rec = led.record(h.request.request_id)
        assert sum(s["state"] in TERMINAL_STATES
                   for s in rec["states"]) == 1
    assert set(tenants) <= set(eng.telemetry.tenant_rows())


# -- the watchdog --------------------------------------------------------


def test_flusher_stall_watchdog_restarts(two):
    """The injected stall is held on an event from the moment it fires
    at the loop top until the test has seen the watchdog's restart, so
    neither the firing nor the restart races the test's clock."""
    from pint_tpu_torch.resilience.faultinject import FaultPoint, inject

    hang_s = 1.0
    fired, released = threading.Event(), threading.Event()

    def sleep(s):
        if s == hang_s:  # the stalled flusher's one sleep
            fired.set()
            released.wait(10.0)
        else:
            time.sleep(s)

    led = ledger("torch")
    eng = async_engine("torch", reqlife=led, stall_timeout_s=0.1,
                       watchdog_poll_s=0.02, sleep=sleep)
    eng.prewarm(reqs("torch", two, 2))
    try:
        with inject(FaultPoint("flusher_stall", count=1,
                               payload={"hang_s": hang_s})):
            wait_for(fired.is_set, "the stall never fired at the loop top")
            handles = [eng.submit(r) for r in reqs("torch", two, 4)]
            wait_for(lambda: eng.telemetry.counters.get(
                "flusher_restarts", 0) >= 1,
                "watchdog never restarted the stalled flusher")
            released.set()
            eng.drain()
        assert all(h.status == "ok" for h in handles)
        assert led.nonterminal_ids() == []
        snap = eng.snapshot()
        assert snap["intake"]["generation"] >= 1
        assert snap["intake"]["flusher_alive"]
    finally:
        released.set()
        eng.close()


@pytest.mark.parametrize("where", ["handle", "idle_tick", "mutex_wait"])
def test_working_flusher_is_not_superseded(two, where):
    """A flusher busy for longer than stall_timeout_s (a slow _handle, a
    slow idle-tick flush, or a wait for the work mutex that another
    thread holds) is working, not stalled: the watchdog restarts
    nothing, and the one flusher serves every request."""
    slow_s = 0.5
    eng = async_engine("torch", stall_timeout_s=0.1, watchdog_poll_s=0.02)
    eng.prewarm(reqs("torch", two, 2))
    try:
        if where == "mutex_wait":
            with eng._work_mutex:  # the flusher's next tick waits on it
                handles = [eng.submit(r) for r in reqs("torch", two, 2)]
                time.sleep(slow_s)
        else:
            inner = getattr(eng, f"_{where}")

            def slow(*args):
                time.sleep(slow_s)
                return inner(*args)

            setattr(eng, f"_{where}", slow)
            handles = [eng.submit(r) for r in reqs("torch", two, 2)]
        eng.drain()
        assert all(h.status == "ok" for h in handles)
        assert eng.telemetry.counters.get("flusher_restarts", 0) == 0
        snap = eng.snapshot()
        assert snap["intake"]["generation"] == 0
        assert snap["intake"]["flusher_alive"]
    finally:
        eng.close()


def test_flusher_death_watchdog_restarts(two):
    eng = async_engine("torch", stall_timeout_s=30.0, watchdog_poll_s=0.02)
    eng.prewarm(reqs("torch", two, 2))
    try:
        eng.intake.supersede()  # the current flusher exits at loop top
        eng._flusher.join(timeout=5.0)
        assert not eng._flusher.is_alive()
        wait_for(lambda: eng._flusher.is_alive(),
                 "watchdog never replaced the dead flusher")
        handles = [eng.submit(r) for r in reqs("torch", two, 4)]
        eng.drain()
        assert all(h.status == "ok" for h in handles)
        assert eng.telemetry.counters["flusher_restarts"] >= 1
    finally:
        eng.close()


def _overflow(pkg, two):
    if pkg == "jax":
        from pint_tpu.resilience.faultinject import FaultPoint, inject
    else:
        from pint_tpu_torch.resilience.faultinject import FaultPoint, inject
    eng = async_engine(pkg)
    try:
        with inject(FaultPoint("intake_overflow", count=1)):
            h = eng.submit(reqs(pkg, two, 1)[0])
        after = eng.submit(reqs(pkg, two, 1)[0])
        eng.drain()
    finally:
        eng.close()
    detail = dict(h.telemetry["detail"])
    detail.pop("request_id")
    return (h.status, h.reason, detail,
            eng.telemetry.counters["shed_intake_overflow"], after.status)


def test_intake_overflow_shed_like_jax(two):
    j, t = _overflow("jax", two), _overflow("torch", two)
    assert t == j
    assert t[:2] == ("shed", "intake_overflow")
    assert t[2]["injected_point"] == "intake_overflow"
    assert t[3:] == (1, "ok")


def test_flusher_handle_crash_completes_request(two):
    led = ledger("torch")
    eng = async_engine("torch", reqlife=led)
    try:
        eng._screen = lambda *a, **kw: (_ for _ in ()).throw(
            RuntimeError("boom"))
        h = eng.submit(reqs("torch", two, 1)[0])
        wait_for(lambda: h.done, "crashed _handle stranded the request")
        assert h.status == "error" and "boom" in h.reason
        assert eng.telemetry.counters["flusher_handle_errors"] == 1
        assert led.nonterminal_ids() == []
        del eng._screen
        h2 = eng.submit(reqs("torch", two, 2)[1])
        eng.drain()
        assert h2.status == "ok"
    finally:
        eng.close()


# -- admission ------------------------------------------------------------


def _fake_req(tenant="anon", priority=1):
    return types.SimpleNamespace(tenant=tenant, priority=priority)


def _ladder(pkg):
    mod = serve(pkg)
    t = [0.0]
    out = []
    adm = mod.AdmissionController(quotas={"hot": 2.0}, burst_s=1.0,
                                  clock=lambda: t[0])
    for _ in range(3):
        out.append(adm.decide(_fake_req("hot"), depth=0, capacity=64))
    out.append(adm.decide(_fake_req("cold"), depth=0, capacity=64))
    t[0] += 1.0
    out.append(adm.decide(_fake_req("hot"), depth=0, capacity=64))
    bp = mod.AdmissionController(soft_watermark=0.5)
    for pr in (mod.PRIORITY_HIGH, mod.PRIORITY_NORMAL, mod.PRIORITY_BATCH):
        out.append(bp.decide(_fake_req(priority=pr), depth=40, capacity=64))
    slo = mod.AdmissionController(quotas={"hot": 2.0}, burst_s=1.0,
                                  clock=lambda: t[0])
    out.append(sorted(slo.observe_slo(
        [{"name": "tenant_hot_availability", "alerting": True},
         {"name": "tenant_good_latency_p99", "alerting": False}])))
    for _ in range(5):
        out.append(slo.decide(_fake_req("hot"), depth=0, capacity=64))
    out.append(slo.decide(_fake_req("hot", priority=mod.PRIORITY_HIGH),
                          depth=0, capacity=64))
    slo.observe_slo([{"name": "tenant_hot_availability",
                      "alerting": False}])
    for _ in range(3):
        out.append(slo.decide(_fake_req("hot"), depth=0, capacity=64))
    t[0] += 1.0
    for _ in range(3):
        out.append(slo.decide(_fake_req("hot", priority=mod.PRIORITY_BATCH),
                              depth=60, capacity=64))
    out.append(slo.decide(_fake_req("hot"), depth=0, capacity=64))
    out.append(slo.snapshot())
    return [o.__dict__ if hasattr(o, "admit") else o for o in out]


def test_admission_ladder_like_jax():
    """Quota bucket, backpressure by priority, SLO throttle, and no
    quota debit for sheds of later rungs: the JAX package's decisions,
    one for one."""
    j, t = _ladder("jax"), _ladder("torch")
    assert t == j
    reasons = [d.get("reason") if isinstance(d, dict) and "admit" in d
               else None for d in t]
    assert reasons[:5] == [None, None, "tenant_quota", None, None]
    assert reasons[5:8] == [None, None, "backpressure"]
    assert t[8] == ["hot"]
    assert reasons[9:14] == ["slo_throttle"] * 5 and reasons[14] is None
    assert reasons[15:18] == [None, "tenant_quota", "tenant_quota"]
    assert reasons[18:21] == ["backpressure"] * 3 and reasons[21] is None


def test_offer_reports_stopped_vs_full():
    from pint_tpu_torch.serve import IntakeQueue

    q = IntakeQueue(1)
    assert q.offer("a") is None and q.offer("b") == "full"
    q.stop()
    assert q.offer("c") == "stopped"


def test_stop_between_screen_and_offer_rejects_draining(two):
    eng = async_engine("torch")
    try:
        eng.intake.stop()
        eng.intake.is_running = lambda: True
        try:
            h = eng.submit(reqs("torch", two, 1)[0])
        finally:
            del eng.intake.is_running
        assert h.status == "rejected" and h.reason == "draining"
        assert eng.telemetry.counters.get("shed_queue_full", 0) == 0
    finally:
        eng.close(drain=False)


def test_hot_tenant_quota_does_not_starve_good_tenant(two):
    from pint_tpu_torch.serve import AdmissionController, FitRequest

    adm = AdmissionController(quotas={"hot": 4.0}, burst_s=1.0)
    led = ledger("torch")
    eng = async_engine("torch", max_queue=64, admission=adm, reqlife=led)
    eng.prewarm(reqs("torch", two, 2))
    hot_h, good_h = [], []

    def hot():
        for k in range(12):
            hot_h.append(eng.submit(FitRequest(
                two[k % 2][3], two[k % 2][4], maxiter=2, tenant="hot")))
            time.sleep(1.0 / 12.0)

    def good():
        for k in range(6):
            good_h.append(eng.submit(FitRequest(
                two[k % 2][3], two[k % 2][4], maxiter=2, tenant="good")))
            time.sleep(0.18)

    try:
        th, tg = threading.Thread(target=hot), threading.Thread(target=good)
        th.start()
        tg.start()
        th.join()
        tg.join()
        eng.drain()
    finally:
        eng.close()
    rows = eng.telemetry.tenant_rows()
    assert rows["hot"]["shed"] >= 1
    assert sum(h.status == "shed" for h in hot_h) == rows["hot"]["shed"]
    assert all(h.reason == "tenant_quota" for h in hot_h
               if h.status == "shed")
    assert rows["good"]["shed"] == rows["good"]["rejected"] == 0
    assert rows["good"]["ok"] == rows["good"]["requests"] == 6
    assert rows["good"]["p99_s"] is not None and rows["good"]["p99_s"] < 5.0
    assert led.nonterminal_ids() == []


def test_close_drains_then_rejects(two):
    eng = async_engine("torch")
    handles = [eng.submit(r) for r in reqs("torch", two, 4)]
    eng.close()
    assert all(h.status == "ok" for h in handles)
    assert not eng.intake.is_running()
    assert eng._flusher is None or not eng._flusher.is_alive()
    late = eng.submit(reqs("torch", two, 1)[0])
    assert late.status == "rejected" and late.reason == "draining"
