"""The port's fleet mesh (pint_tpu_torch/parallel/fleetmesh.py):
``FleetMesh`` over device lanes with work stealing, the watchdog, the
per-bucket checkpoint, the ``mesh.*`` spans — tests/test_fleet_pipeline.py's
FleetMesh tests on the port, with four logical lanes on the CPU
(``["cpu"] * 4``), and against the JAX package's FleetMesh on its eight
forced host devices.

Tolerances: the port's FleetMesh is bitwise its own PTAFleet (same
buckets, same programs); against the JAX package the batched-fit tier of
ERRORBUDGET.md, parameters to 1e-6 sigma. chi2 misses its 1e-9 tier on
these TOAs (1.23e-8 measured, the port's PTAFleet alike: ROADMAP §3), so
it is held to 5e-8 and to the PTAFleet's own gap.
"""

import copy
import threading
import time
import warnings

import numpy as np
import pytest

from test_torch_pta import port_toas

LANES = ["cpu"] * 4
TOL_SIGMA = 1e-6
TOL_CHI2 = 5e-8  # the 1e-9 tier is out of reach here (ROADMAP §3)


def _pars():
    spin = [(f"PSR FM{i}\nRAJ 1{i}:00:00.0\nDECJ {5 + i}:30:00.0\n"
             f"F0 {200 + 10 * i}.5 1\nF1 -{3 + i}e-16 1\nPEPOCH 55500\n"
             f"DM {10 + i}.5 1\n") for i in range(2)]
    noise = [(f"PSR FN{i}\nRAJ 0{2 * i}:30:00.0\nDECJ {8 + i}:00:00.0\n"
              f"F0 {310 + 4 * i}.25 1\nF1 -{2 + i}e-16 1\nPEPOCH 55500\n"
              f"DM {12 + i}.3 1\n"
              "EFAC -f L-wide 1.2\nEQUAD -f L-wide 0.5\n"
              "ECORR -f L-wide 0.9\n") for i in range(2)]
    return spin + noise


@pytest.fixture(scope="module")
def pulsars():
    """(pars, JAX models, JAX TOAs, port TOAs): 2 spin-only pulsars (the
    WLS route of method="auto") and 2 ECORR pulsars (GLS): 2 buckets."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(5)
    pars = _pars()
    jms, jts = [], []
    for i, p in enumerate(pars):
        jm = jax_model(p)
        days = np.sort(rng.uniform(55000, 56000, 10 + 2 * i))
        mjds = (days[:, None] + np.arange(3) * 0.5 / 86400.0).reshape(-1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jt = make_fake_toas_fromMJDs(
                mjds, jm, error_us=1.0, freq_mhz=np.full(len(mjds), 1400.0),
                obs="gbt", add_noise=True, seed=40 + i)
        for f in jt.flags:
            f["f"] = "L-wide"
        jms.append(jm)
        jts.append(jt)
    return pars, jms, jts, [port_toas(t) for t in jts]


def _models(pars):
    from pint_tpu_torch.models import get_model

    return [get_model(p) for p in pars]


def _mesh(pulsars, **kw):
    from pint_tpu_torch.parallel import FleetMesh

    pars, _, _, tts = pulsars
    kw.setdefault("collective_timeout_s", None)
    return FleetMesh(_models(pars), tts, devices=LANES, **kw)


@pytest.fixture(scope="module")
def healthy(pulsars):
    """The healthy FleetMesh fit every chaos test compares against."""
    fm = _mesh(pulsars)
    out = fm.fit(method="auto", maxiter=2)
    assert fm.snapshot()["lost_lanes"] == []
    return out


def _assert_bitwise(ref, got):
    rx, rc, rcov = ref
    gx, gc, gcov = got
    assert np.array_equal(np.asarray(rc), np.asarray(gc))
    for a, b in zip(rx, gx):
        assert np.array_equal(a, b)
    for a, b in zip(rcov, gcov):
        assert np.array_equal(a, b)


def test_healthy_fleetmesh_bitwise_matches_ptafleet(pulsars, healthy):
    """Spreading the buckets over lanes is scheduling only: bitwise the
    single-device PTAFleet with the same buckets."""
    from pint_tpu_torch.parallel import PTAFleet

    pars, _, _, tts = pulsars
    fleet = PTAFleet(_models(pars), tts, device="cpu")
    _assert_bitwise(fleet.fit(method="auto", maxiter=2), healthy)


def test_healthy_fleetmesh_matches_jax(pulsars, healthy):
    """Port vs the JAX package's FleetMesh on the same TOAs: parameters
    to 1e-6 sigma; chi2 to 5e-8 relative (ROADMAP §3) and no further
    from the JAX FleetMesh than the JAX PTAFleet is: the mesh adds no
    gap of its own."""
    from pint_tpu.parallel import FleetMesh as JaxMesh
    from pint_tpu.parallel import PTAFleet as JaxFleet

    _, jms, jts, _ = pulsars
    jm = JaxMesh(copy.deepcopy(jms), jts, collective_timeout_s=None)
    jx, jc, jcov = jm.fit(method="auto", maxiter=2)
    _, jfc, _ = JaxFleet(copy.deepcopy(jms), jts).fit(method="auto",
                                                        maxiter=2)
    assert np.array_equal(np.asarray(jfc), np.asarray(jc))
    tx, tc, tcov = healthy
    for i in range(len(jx)):
        sig = np.sqrt(np.diag(np.asarray(jcov[i])))
        assert np.max(np.abs(tx[i] - np.asarray(jx[i])) / sig) <= TOL_SIGMA
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=TOL_CHI2)
    assert [len(v) for v in jm.group_indices.values()] == \
        [len(v) for v in _mesh(pulsars).group_indices.values()]


def test_device_loss_completes_on_survivors_bitwise(pulsars, healthy):
    """One lane killed mid-fit: the fit completes on the survivors,
    bitwise the healthy fit; the flight recorder dumps the loss and the
    metrics count it."""
    from pint_tpu_torch.obs import metricsreg
    from pint_tpu_torch.obs.recorder import RECORDER
    from pint_tpu_torch.resilience import FaultPoint, inject

    lost0 = metricsreg.REGISTRY.counter("mesh.lanes_lost").value
    dumps = []
    real = RECORDER.dump
    RECORDER.dump = lambda reason, **ctx: (dumps.append((reason, ctx)),
                                           real(reason, **ctx))[1]
    try:
        fm = _mesh(pulsars)
        with inject(FaultPoint("device_loss", rate=1.0,
                               payload={"lane": 0})):
            got = fm.fit(method="auto", maxiter=2)
    finally:
        RECORDER.dump = real
    _assert_bitwise(healthy, got)
    snap = fm.snapshot()
    assert snap["lost_lanes"] == [0]
    assert snap["alive_lanes"] == len(LANES) - 1
    assert snap["stolen_buckets"] >= 1
    assert snap["quarantined_pulsars"] == []
    assert metricsreg.REGISTRY.counter("mesh.lanes_lost").value == lost0 + 1
    assert metricsreg.REGISTRY.gauge("mesh.alive_lanes").value == 3
    (reason, ctx), = [d for d in dumps if d[0] == "device_lost"]
    assert ctx["lane"] == 0 and ctx["fault_point"] == "device_loss"
    assert ctx["resharded"] == [list(r) for r in snap["reassignments"]]
    # the stolen bucket was rebuilt on its survivor lane
    assert {lane for (_, lane) in fm._built} >= {1}


def test_work_steal_deterministic(pulsars):
    """Reassignment after a lane loss is a pure function of the (bucket
    set, survivor set): two identical chaos runs steal identically and
    give bitwise-equal results."""
    from pint_tpu_torch.resilience import FaultPoint, inject

    runs = []
    for _ in range(2):
        fm = _mesh(pulsars)
        with inject(FaultPoint("device_loss", rate=1.0,
                               payload={"lane": 0})):
            runs.append((fm.fit(method="auto", maxiter=2), fm.snapshot()))
    (got1, snap1), (got2, snap2) = runs
    assert snap1["reassignments"] == snap2["reassignments"]
    assert snap1["lost_lanes"] == snap2["lost_lanes"]
    _assert_bitwise(got1, got2)


@pytest.mark.parametrize("hang_s,lost", [(60.0, [0]), (5.0, [])],
                         ids=["past-watchdog", "late"])
def test_collective_timeout(pulsars, healthy, hang_s, lost):
    """A pull that hangs past the watchdog raises a catchable
    CollectiveTimeout, strikes the lane's breaker, and after
    breaker_threshold strikes the lane is quarantined and its buckets
    stolen; a shorter hang is only late. Either way the fit matches the
    healthy one. The hang is simulated through the injected sleep."""
    from pint_tpu_torch.resilience import FaultPoint, inject

    slept = []
    fm = _mesh(pulsars, collective_timeout_s=30.0, sleep=slept.append,
               breaker_threshold=2)
    with inject(FaultPoint("collective_timeout", rate=1.0,
                           count=2 if lost else 1,
                           payload={"lane": 0, "hang_s": hang_s})):
        got = fm.fit(method="auto", maxiter=2)
    _assert_bitwise(healthy, got)
    snap = fm.snapshot()
    assert snap["lost_lanes"] == lost
    if lost:
        assert snap["stolen_buckets"] >= 1
        assert slept.count(30.0) == 2  # the full bound, twice
    else:
        assert 5.0 in slept


def test_straggler_slows_without_failing(pulsars, healthy):
    """straggler_delay stalls one lane's bucket (noted in its health)
    but nothing fails and nothing is stolen."""
    from pint_tpu_torch.resilience import FaultPoint, inject

    slept = []
    fm = _mesh(pulsars, sleep=slept.append)
    with inject(FaultPoint("straggler_delay", rate=1.0, count=1,
                           payload={"lane": 0, "delay_s": 7.5})):
        got = fm.fit(method="auto", maxiter=2)
    _assert_bitwise(healthy, got)
    snap = fm.snapshot()
    assert snap["lost_lanes"] == [] and snap["stolen_buckets"] == 0
    assert 7.5 in slept


def test_resume_after_fleet_loss_bitwise(tmp_path, pulsars, healthy):
    """Every lane dies once the first bucket has checkpointed; a fresh
    FleetMesh resumes from the checkpoint, bitwise the uninterrupted
    fit. A checkpoint of another fit configuration warns and restarts."""
    from pint_tpu_torch.checkpoint import FitCheckpointer
    from pint_tpu_torch.parallel import DeviceLost
    from pint_tpu_torch.resilience import FaultPoint, inject

    fm1 = _mesh(pulsars)
    with inject(FaultPoint("device_loss", rate=1.0, after=1)):
        with pytest.raises(DeviceLost):
            fm1.fit(method="auto", maxiter=2, checkpoint_dir=str(tmp_path))
    saved = FitCheckpointer(tmp_path).restore("fleetmesh")
    assert saved is not None and len(saved["done"]) == 1
    fm2 = _mesh(pulsars)
    got = fm2.fit(method="auto", maxiter=2, checkpoint_dir=str(tmp_path))
    _assert_bitwise(healthy, got)
    assert fm2.snapshot()["lost_lanes"] == []
    fm3 = _mesh(pulsars)
    with pytest.warns(UserWarning, match="different fleet/fit configuration"):
        out = fm3.fit(method="auto", maxiter=1, checkpoint_dir=str(tmp_path))
    assert np.isfinite(out[1]).all()


def test_mesh_spans_under_tracing(pulsars, healthy):
    """mesh.fit > mesh.bucket per bucket (and mesh.steal after a loss)
    under tracing; the traced fit is bitwise the untraced one."""
    from pint_tpu_torch import obs
    from pint_tpu_torch.obs import trace as obs_trace
    from pint_tpu_torch.resilience import FaultPoint, inject

    obs.enable()
    try:
        obs_trace.reset()
        fm = _mesh(pulsars)
        with inject(FaultPoint("device_loss", rate=1.0,
                               payload={"lane": 0})):
            got = fm.fit(method="auto", maxiter=2)
        spans = obs_trace.spans()
    finally:
        obs.disable()
    _assert_bitwise(healthy, got)
    names = [s["name"] for s in spans]
    assert names.count("mesh.fit") == 1
    assert names.count("mesh.bucket") >= len(fm.bucket_order)
    assert "mesh.steal" in names
    root = next(s for s in spans if s["name"] == "mesh.fit")
    assert all(s["parent"] == root["span"]
               for s in spans if s["name"] in ("mesh.bucket", "mesh.steal"))


def test_lane_and_watchdog_primitives():
    """run_watched raises CollectiveTimeout from a daemon thread and
    passes values and errors through; DeviceLane quarantine is
    idempotent; the device points are registered and classified."""
    from pint_tpu_torch.parallel import (CollectiveTimeout, DeviceLane,
                                         DeviceLost, run_watched)
    from pint_tpu_torch.resilience import DEVICE_POINTS, FaultPoint
    from pint_tpu_torch.resilience.retry import is_retryable

    gate = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(CollectiveTimeout, match="pull"):
        run_watched(gate.wait, 0.2, what="pull")
    assert time.monotonic() - t0 < 5.0
    assert any(t.daemon and t.name == "pint-tpu-collective-watchdog"
               for t in threading.enumerate())
    gate.set()
    assert run_watched(lambda: 7, 1.0) == 7 and run_watched(lambda: 8, None) == 8
    with pytest.raises(ValueError):
        run_watched(lambda: int("x"), 1.0)
    lane = DeviceLane(2, "cpu")
    assert lane.alive() and lane.mesh.shape == {"pulsar": 1}
    assert lane.quarantine() and not lane.quarantine()
    snap = lane.snapshot()
    assert snap["lost"] and not snap["alive"] and snap["device"] == "cpu"
    assert set(DEVICE_POINTS) == {"device_loss", "collective_timeout",
                                  "straggler_delay"}
    for p in DEVICE_POINTS:
        FaultPoint(p)
    assert is_retryable(CollectiveTimeout("hung"))
    assert not is_retryable(DeviceLost("lane 3 lost"))
