"""The port's fit-quality probes and observability core
(``pint_tpu_torch.obs``: clock, metricsreg, recorder, slo's SLOSpec,
fitquality) against the JAX package's, on the CPU.

- the pure probes (chi2_zscore, condition_from_covn, residual_moments)
  are bitwise the JAX package's on the same numpy inputs (the same
  numpy arithmetic in both);
- the ledger's counters, annotate and fallback accounting leave the
  same snapshot as the JAX ledger after the same events;
- a diverged lane, made by the port's ``solver_diverge`` fault point in
  a batch fit, dumps a ``fit_anomaly`` flight record naming the pulsar,
  the probe and its baseline, and the recorder's ring holds the fault;
- the SLO pack and check_report agree with the JAX package's;
- the Prometheus text and a flight dump equal the JAX package's for
  the same events (the dump's timestamps aside);
- the contract the probes keep (tests/test_fitquality.py's): a probed
  68 x 400 batch fit is bitwise the unprobed one, its probe wall under
  1% of the warm refit, and its snapshot matches the JAX batch's on the
  same data: chi2 z to 1e-9 relative (the packages' chi2 differ by
  ~1e-12 relative, the one-ulp phase gap), condition to 1e-6 relative;
- the fitters' probes (GLSFitter, the wideband fitters) leave the fit
  bitwise unchanged and record what the JAX fitters record.
"""

import copy
import json
import math
import warnings
from pathlib import Path

import numpy as np
import pytest

warnings.simplefilter("ignore")

ROOT = Path(__file__).resolve().parents[1]
TOL_Z = 1e-9  # chi2 z-score, relative (the chi2 tier)
TOL_COND = 1e-6  # condition number, relative
# a red-noise GLSFitter's whitened chi2 across the packages: the
# one-ulp phase gap (~7e-14 s on NOISE_PAR's TOAs) through the Woodbury
# cancellation rw2 - b.dxn gives 0.9-1.4e-8 relative (ROADMAP §3)
TOL_GLS_CHI2 = 1e-7
PROBE_SHARE = 0.01  # probe wall / warm refit wall


@pytest.fixture(autouse=True)
def _clean():
    """Probes off, empty ledgers and rings, no dump dir — in both
    packages, before and after every test (module-global state)."""
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu.obs import recorder as jrec
    from pint_tpu_torch.obs import fitquality as fq
    from pint_tpu_torch.obs import recorder as rec

    def clean():
        for f, r in ((jfq, jrec), (fq, rec)):
            f.disable()
            f.reset()
            r.RECORDER.reset()
            r.RECORDER.dump_dir = None

    clean()
    yield
    clean()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    dof = rng.integers(-2, 400, 64).astype(float)
    chi2 = dof * rng.uniform(0.5, 3.0, 64)
    chi2[[3, 7]] = np.nan, np.inf
    a = rng.normal(size=(16, 5, 5))
    covn = a @ np.swapaxes(a, 1, 2)
    covn[2] = np.diag([1.0, 2.0, 0.0, 1.0, 1.0])  # semidefinite -> inf
    covn[5, 0, 0] = np.nan  # a diverged lane -> NaN
    rw = rng.standard_t(4, size=5000)
    rw[[10, 20]] = np.nan, np.inf
    return chi2, dof, covn, rw


def test_pure_probes_are_bitwise_the_jax_packages():
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu_torch.obs import fitquality as fq

    chi2, dof, covn, rw = _inputs()
    np.testing.assert_array_equal(fq.chi2_zscore(chi2, dof),
                                  jfq.chi2_zscore(chi2, dof))
    np.testing.assert_array_equal(fq.condition_from_covn(covn),
                                  jfq.condition_from_covn(covn))
    c1, c2 = fq.condition_from_covn(covn[0]), jfq.condition_from_covn(covn[0])
    assert c1 == c2 and np.ndim(c1) == 0
    for z in (3.5, 2.0):
        assert fq.residual_moments(rw, z) == jfq.residual_moments(rw, z)
    assert fq.residual_moments([]) == jfq.residual_moments([])
    assert math.isinf(fq.condition_from_covn(covn)[2])
    assert math.isnan(fq.condition_from_covn(covn)[5])


def _ledger_events(mod):
    led = mod.FitQualityLedger()
    led.record("A", {"chi2_z": -2.0, "condition": 10.0, "relres": 1e-8})
    led.record("B", {"chi2_z": 1.0, "condition": 300.0, "diverged": True})
    led.record("A", {"chi2_z": 0.5, "condition": 20.0})
    led.record("C", {"chi2_z": np.nan, "condition": np.inf})
    led.annotate("A", moments={"n": 24, "n_outliers": 0})
    led.note_fallback(["A", "B"])
    led.note_drift_alarm("A", "reduced_chi2")
    led.note_pair_coherence(10, 2, max_abs_snr=4.5)
    led.note_probe_wall(0.25)
    return led


def test_ledger_counters_annotate_and_fallbacks_match_jax():
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu_torch.obs import fitquality as fq

    led, jled = _ledger_events(fq), _ledger_events(jfq)
    snap = led.snapshot()
    # JSON text: a NaN probe value compares equal only as text
    assert json.dumps(snap) == json.dumps(jled.snapshot())
    assert snap["counters"]["fits"] == 4
    assert snap["counters"]["fallbacks"] == 2
    assert snap["counters"]["diverged"] == 1
    assert snap["max_abs_chi2_z"] == 2.0 and snap["max_condition"] == 300.0
    assert led.get("A") == {"chi2_z": 0.5, "condition": 20.0,
                            "moments": {"n": 24, "n_outliers": 0}}
    assert json.dumps(led.state_dict()) == json.dumps(jled.state_dict())
    fresh = fq.FitQualityLedger()
    fresh.load_state_dict(json.loads(json.dumps(led.state_dict())))
    assert json.dumps(fresh.snapshot()) == json.dumps(snap)
    with pytest.raises(ValueError):
        fresh.load_state_dict({"kind": "Nope", "version": 1})
    led.reset()
    assert led.snapshot() == jfq.FitQualityLedger().snapshot()


def test_record_fit_batch_matches_jax():
    """record_fit_batch's per-pulsar records and bucket summary equal
    the JAX package's on the same host arrays, with a diverged lane
    dumped by each package's own recorder."""
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu.obs import recorder as jrec
    from pint_tpu_torch.obs import fitquality as fq
    from pint_tpu_torch.obs import recorder as rec

    chi2, dof, covn, _ = _inputs(1)
    labels = [f"P{i}" for i in range(16)]
    out = []
    for f, r in ((fq, rec), (jfq, jrec)):
        led = f.FitQualityLedger()
        summ = f.record_fit_batch(
            labels, chi2[:16], dof[:16], covn=covn, relres=2e-9,
            method="gls", precision="mixed", maxiter=2, diverged=[1],
            ledger=led, source="unit", recorder=r.FlightRecorder())
        snap = led.snapshot()
        snap.pop("probe_wall_s")
        out.append(json.dumps((summ, snap)))
    assert out[0] == out[1]
    assert json.loads(out[0])[0]["fitq_diverged"] == 1


def _small_batch(n_psr=3, n_toa=48):
    """(port models, port TOAs, JAX models, JAX TOAs): bench.py's noise
    par template (chip_smoke.par_text) on n_toa clustered GBT TOAs."""
    import chip_smoke
    from bench import build_batch
    from pint_tpu_torch.models import get_model
    from test_torch_pta import port_toas

    jms, jts = build_batch(n_psr, n_toa)
    return ([get_model(chip_smoke.par_text(i)) for i in range(n_psr)],
            [port_toas(t) for t in jts], jms, jts)


@pytest.fixture(scope="module")
def small_batch():
    return _small_batch()


def test_solver_diverge_dumps_an_attributed_anomaly(tmp_path, small_batch):
    """The port's solver_diverge fault point NaNs lane 1's chi2 in the
    batch finalize; the probes flag it and dump a fit_anomaly naming
    BEN1, the chi2_whitened probe and its baseline (48 TOAs - 3 free
    params - offset = 44), and the ring holds the fault's firing."""
    from pint_tpu_torch.obs import fitquality as fq
    from pint_tpu_torch.obs import recorder as rec
    from pint_tpu_torch.parallel.pta import PTABatch
    from pint_tpu_torch.resilience import FaultPoint, inject

    pms, pts, _, _ = small_batch
    batch = PTABatch(pms, pts, device="cpu")
    rec.RECORDER.dump_dir = str(tmp_path)
    fq.enable()
    with inject(FaultPoint("solver_diverge", count=1,
                           payload={"lanes": [1]})):
        batch.gls_fit(maxiter=2)
    assert batch.quality["fitq_diverged"] == 1
    assert fq.FITQ.get("BEN1")["diverged"] is True
    assert fq.FITQ.snapshot()["counters"]["diverged"] == 1
    dumps = sorted(tmp_path.glob("flight_*_fit_anomaly.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    ctx = doc["context"]
    assert (ctx["pulsar"], ctx["probe"], ctx["baseline"], ctx["source"]) \
        == ("BEN1", "chi2_whitened", 44.0, "pta.gls")
    faults = [e for e in doc["events"] if e["kind"] == "fault"]
    assert [e["point"] for e in faults] == ["solver_diverge"]
    assert faults[0]["ctx"]["lanes"] == [1]


def test_fleet_fit_quality_sequential_and_pipelined(small_batch):
    """PTAFleet.fit_quality holds one summary per bucket, the same from
    the sequential and the pipelined executor, and nothing when the
    probes are off."""
    from pint_tpu_torch.obs import fitquality as fq
    from pint_tpu_torch.parallel.pta import PTAFleet

    pms, pts, _, _ = small_batch
    fleet = PTAFleet(pms, pts, device="cpu")
    x0, c0, _ = fleet.fit(method="gls", maxiter=2)
    assert fleet.fit_quality == {}
    fq.enable()
    xs, cs, _ = fleet.fit(method="gls", maxiter=2)
    seq = dict(fleet.fit_quality)
    xp, cp, _ = fleet.fit(method="gls", maxiter=2, pipeline=True)
    assert set(seq) == set(fleet.batches) and fleet.fit_quality == seq
    assert fq.FITQ.snapshot()["counters"]["fits"] == 2 * len(pms)
    for a, b, c in zip(x0, xs, xp):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert np.array_equal(c0, cs) and np.array_equal(c0, cp)


def _healthy(**over):
    snap = {"counters": {"fits": 100, "fallbacks": 1, "diverged": 0,
                         "drift_alarms": 0},
            "max_abs_chi2_z": 2.1, "max_condition": 5e4,
            "max_relres": 3e-9, "probe_wall_s": 0.001,
            "n_pulsars": 68, "pulsars": {}}
    snap.update(over)
    return snap


SNAPSHOTS = (
    _healthy(), {}, {"requests": 10, "fit_quality": _healthy()},
    _healthy(max_abs_chi2_z=42.0),
    _healthy(counters={"fits": 100, "fallbacks": 30, "diverged": 5,
                       "drift_alarms": 2}),
    {"fit_quality": _healthy(max_condition=1e15)},
)


def test_slo_pack_and_check_report_match_jax():
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu_torch.obs import fitquality as fq
    from pint_tpu_torch.obs.slo import SLOSpec

    specs, jspecs = fq.fit_quality_slos(), jfq.fit_quality_slos()
    assert [s.name for s in specs] == [s.name for s in jspecs] == [
        "fitq_chi2_z", "fitq_fallback", "fitq_divergence",
        "fitq_condition", "fitq_drift", "gw_coherence"]
    for snap in SNAPSHOTS:
        assert fq.check_report(snap) == jfq.check_report(snap)
        for s, js in zip(specs, jspecs):
            state, jstate = [0, 0], [0, 0]
            assert s.observe(snap, state) == js.observe(snap, jstate)
            assert (s.budget, s.limit) == (js.budget, js.limit)
            assert 1.0 / s.budget > s.fast_burn
    assert not fq.check_report(SNAPSHOTS[3])["ok"]
    with pytest.raises(ValueError):
        SLOSpec("x", 0.0, bad="a")
    with pytest.raises(ValueError):
        SLOSpec("x", 0.1)


def _registry_events(mreg, fqmod):
    reg = mreg.Registry()
    reg.counter("fits").inc(3)
    reg.counter("fits", labels={"tenant": 'a"b'}).inc()
    reg.gauge("relres").set(2.5e-9)
    reg.gauge("none").set(None)
    h = reg.histogram("wall_s", capacity=8)
    for i, v in enumerate(np.linspace(0.01, 0.5, 20)):
        h.record(float(v), exemplar={"trace": f"t{i}"})
    reg.absorb({"a": {"b": 1, "c": 2.0, "d": [1.0, 2.0], "e": True,
                      "f": "skip"}}, prefix="x.")
    fqmod.export_metrics(registry=reg, ledger=_ledger_events(fqmod))
    return reg


def test_prometheus_text_and_flight_dump_match_jax(tmp_path):
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu.obs import metricsreg as jmreg
    from pint_tpu.obs import recorder as jrec
    from pint_tpu_torch.obs import fitquality as fq
    from pint_tpu_torch.obs import metricsreg as mreg
    from pint_tpu_torch.obs import recorder as rec

    reg, jreg = _registry_events(mreg, fq), _registry_events(jmreg, jfq)
    text = mreg.prometheus_text(registry=reg)
    assert text == jmreg.prometheus_text(registry=jreg)
    assert "pint_tpu_fitq_counters_fits 4" in text
    assert reg.snapshot() == jreg.snapshot()
    assert mreg.summary([3, 1, 2]) == jmreg.summary([3, 1, 2])
    docs = []
    for r, m, d in ((rec, mreg, "port"), (jrec, jmreg, "jax")):
        fr = r.FlightRecorder(capacity=4, dump_dir=str(tmp_path / d),
                              max_dumps=2)
        fr.note_fault("solver_diverge", {"lanes": [np.int64(1)]})
        fr.note("quarantine", pulsar="BEN1", x=np.float64(1.5))
        paths = [fr.dump("fit_anomaly", pulsar=f"P{i}") for i in range(3)]
        assert len(list((tmp_path / d).glob("flight_*.json"))) == 2
        assert fr.dumps == paths[1:]
        doc = json.load(open(paths[-1]))
        doc.pop("walltime")
        doc.pop("metrics")
        for e in doc["events"]:
            e.pop("ts")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert [e["kind"] for e in docs[0]["events"]] == ["event"] * 4


def test_clock_matches_jax():
    from pint_tpu.obs import clock as jclock
    from pint_tpu_torch.obs import clock

    assert clock.now is jclock.now and clock.walltime is jclock.walltime
    sw = clock.Stopwatch()
    assert sw.elapsed() >= 0.0 and sw.lap() >= 0.0


@pytest.fixture(scope="module")
def bench_batch():
    return _small_batch(68, 400)


def test_probed_batch_fit_is_bitwise_under_1pct_and_matches_jax(
        bench_batch):
    """tests/test_fitquality.py's product contract on the port at its
    size (68 pulsars x 400 TOAs, bench.py's build_batch): probing a
    batched GLS refit changes nothing bitwise, and the min-of-3 probe
    wall stays under 1% of the min-of-3 warm refit; the snapshot
    matches the JAX batch's probed fit of the same data."""
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu.parallel import PTABatch as JBatch
    from pint_tpu_torch.obs import clock
    from pint_tpu_torch.obs import fitquality as fq
    from pint_tpu_torch.parallel.pta import PTABatch

    pms, pts, jms, jts = bench_batch
    batch = PTABatch(pms, pts, device="cpu")
    batch.gls_fit(maxiter=2)  # cold
    off = float("inf")
    for _ in range(3):
        t0 = clock.now()
        x, chi2, cov = batch.gls_fit(maxiter=2)
        off = min(off, clock.now() - t0)
    fq.enable()
    walls, prev = [], 0.0
    for _ in range(3):
        x2, chi2_2, cov2 = batch.gls_fit(maxiter=2)
        wall = fq.FITQ.snapshot()["probe_wall_s"]
        walls.append(wall - prev)
        prev = wall
    fq.disable()
    snap = fq.FITQ.snapshot()
    assert np.array_equal(x, x2)
    assert np.array_equal(chi2, chi2_2)
    assert np.array_equal(cov, cov2)
    assert snap["counters"]["fits"] == 68 * 3
    assert snap["n_pulsars"] == 68
    assert min(walls) < PROBE_SHARE * off, (
        f"probe wall {min(walls):.6f} s is {100 * min(walls) / off:.2f}% "
        f"of the {off:.4f} s warm refit")
    jfq.enable()
    JBatch(jms, jts).gls_fit(maxiter=2)
    jfq.disable()
    jsnap = jfq.FITQ.snapshot()
    assert set(jsnap["pulsars"]) == set(snap["pulsars"])
    for k, j in jsnap["pulsars"].items():
        p = snap["pulsars"][k]
        assert p["dof"] == j["dof"]
        assert abs(p["chi2_z"] - j["chi2_z"]) <= TOL_Z * abs(j["chi2_z"]), k
        assert abs(p["condition"] - j["condition"]) \
            <= TOL_COND * j["condition"], k
        assert {q: p[q] for q in ("fell_back", "diverged", "method",
                                  "precision", "maxiter")} \
            == {q: j[q] for q in ("fell_back", "diverged", "method",
                                  "precision", "maxiter")}
    assert abs(snap["max_abs_chi2_z"] - jsnap["max_abs_chi2_z"]) \
        <= TOL_Z * jsnap["max_abs_chi2_z"]


NOISE_PAR = """
PSR TPKW
RAJ 6:00:00
DECJ 10:00:00
F0 200.0 1
F1 -1e-14 1
PEPOCH 55500
DM 10.0
EFAC -f L-wide 1.1
TNREDAMP -12.5
TNREDGAM 3.5
TNREDC 12
"""


def test_gls_fitter_probes_are_bitwise_and_match_jax():
    """GLSFitter with the probes on fits bitwise as with them off (f64
    and mixed), records chi2 z / condition / residual moments under
    the PSR label, and those match the JAX fitter's record: the same
    dof, chi2 to TOL_GLS_CHI2, the z-score the JAX formula gives for the
    port's chi2 bitwise, condition to 1e-6 and the residual moments to
    1e-6."""
    from pint_tpu.fitter import GLSFitter as JGLS
    from pint_tpu.models import get_model as jget
    from pint_tpu.obs import fitquality as jfq
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.fitter import GLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.obs import fitquality as fq
    from test_torch_pta import port_toas

    jt = make_fake_toas_fromMJDs(np.linspace(55000, 56000, 120),
                                 jget(NOISE_PAR), error_us=0.5,
                                 freq_mhz=1400.0, obs="gbt",
                                 flags={"f": "L-wide"}, add_noise=True,
                                 add_correlated_noise=True, seed=7)
    t = port_toas(jt)

    def fit(precision, probed):
        (fq.enable if probed else fq.disable)()
        f = GLSFitter(t, get_model(NOISE_PAR), device="cpu")
        chi2 = f.fit_toas(maxiter=2, precision=precision)
        fq.disable()
        return f, chi2

    for precision in ("f64", "mixed"):
        f0, c0 = fit(precision, False)
        f1, c1 = fit(precision, True)
        assert c0 == c1
        assert np.array_equal(f0.parameter_covariance_matrix,
                              f1.parameter_covariance_matrix)
        for p in f0.model.free_params:
            assert getattr(f0.model, p).value == getattr(f1.model, p).value
    rec = fq.FITQ.get("TPKW")
    assert rec["precision"] == "mixed" and rec["method"] == "gls"
    assert rec["residual_moments"]["n"] == 120
    fq.reset()
    fit("f64", True)
    rec = fq.FITQ.get("TPKW")
    jfq.enable()
    jf = JGLS(jt, jget(NOISE_PAR))
    jf.fit_toas(maxiter=2)
    jfq.disable()
    jrec = jfq.FITQ.get("TPKW")
    assert rec["dof"] == jrec["dof"] == 120 - 3  # F0, F1, offset
    assert abs(rec["chi2"] - jrec["chi2"]) <= TOL_GLS_CHI2 * jrec["chi2"]
    assert rec["chi2_z"] == float(jfq.chi2_zscore(rec["chi2"], rec["dof"]))
    assert abs(rec["condition"] - jrec["condition"]) \
        <= TOL_COND * jrec["condition"]
    m, jm = rec["residual_moments"], jrec["residual_moments"]
    assert m["n"] == jm["n"] and m["n_outliers"] == jm["n_outliers"]
    for k in ("mean", "std", "skew", "kurtosis"):
        assert abs(m[k] - jm[k]) <= 1e-6 * max(1.0, abs(jm[k])), k


def test_wideband_fitters_record_probes():
    """The three wideband fitters record under the pack's PSR with
    their own method names, bitwise-neutral, as the JAX fitters do."""
    from pint_tpu_torch import fitter as tf
    from pint_tpu_torch.models import get_model_and_toas
    from pint_tpu_torch.obs import fitquality as fq

    ex = ROOT / "pint_tpu_torch" / "data" / "examples"
    m, t = get_model_and_toas(str(ex / "wb_sim.par"), str(ex / "wb_sim.tim"))
    for cls, method, kw in (
            (tf.WidebandTOAFitter, "wideband_gls", {"maxiter": 1}),
            (tf.WidebandDownhillFitter, "wideband_downhill",
             {"maxiter": 2}),
            (tf.WidebandLMFitter, "wideband_lm", {"maxiter": 2})):
        f0 = cls(t, copy.deepcopy(m), device="cpu")
        c0 = f0.fit_toas(**kw)
        fq.enable()
        f1 = cls(t, copy.deepcopy(m), device="cpu")
        c1 = f1.fit_toas(**kw)
        fq.disable()
        assert c0 == c1
        rec = fq.FITQ.get(m.PSR.value)
        assert rec["method"] == method and rec["chi2"] == c1
        assert rec["condition"] is not None and rec["chi2_z"] is not None
        assert ("residual_moments" in rec) == (method == "wideband_gls")
        fq.reset()
