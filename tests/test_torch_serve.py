"""The port's serving engine (pint_tpu_torch/serve/) against the JAX
package's, on the CPU: the micro-batcher's flush semantics, the
executable cache's accounting, the degradation policy (mixed->f64,
oversize spill, queue/deadline shedding), served fit/residual/phase
values, the warm-slot reuse that a cached program must get right, the
concurrent/ladder prewarm paths, tracing spans, streaming appends
through the engine, the serve bench, and the signatures of every
public callable ported with the engine.

Both packages run on the same inputs: the JAX package's simulated TOAs
(one pass, ``iterations=0``, as tests/test_serve.py makes them) go to
the port through test_torch_pta.py's ``port_toas``, and each package
builds its model from the same par text. Tiers are tests/test_serve.py's
and ERRORBUDGET.md's: parameters 1e-12 relative and 1e-6 sigma, chi2
1e-9 relative, residuals 1e-12 s, phases 1e-9 cycles; counters,
statuses and rejection reasons equal.

The JAX engines compile per cold slot, so the JAX side of each scenario
runs once in a module fixture and the tests read it.
"""

import inspect
import warnings

import numpy as np
import pytest
import torch

from test_torch_pta import port_toas

warnings.simplefilter("ignore")

PAR = """
PSR SRVT{i}
RAJ 12:0{i}:00.0
DECJ 10:00:00.0
F0 3{i}1.25 1
F1 -4e-16 1
PEPOCH 55500
DM 12.{i} 1
"""

NOISE = "RNAMP 1e-14\nRNIDX -3.2\nTNREDC 4\n"
EFAC = "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n"
ECORR = "ECORR -f L-wide 0.8\n"

TOL_REL = 1e-12  # parameters vs the JAX engine / offline, relative
TOL_SIGMA = 1e-6  # parameters, in sigma (ERRORBUDGET batched fit)
TOL_CHI2 = 1e-9  # relative
TOL_RESID_S = 1e-12
TOL_PHASE = 1e-9


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def pulsar(i=0, n_toa=24, extra="", seed=0, epochs=False):
    """(par, JAX model, JAX TOAs, port model, port TOAs) of pulsar i:
    noisy one-pass TOAs at GBT from the JAX package's maker, the same
    TOAs in the port's form. ``epochs`` groups the TOAs 4 per epoch
    (0.5 s apart), so an ECORR has epochs to marginalize."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.models import get_model

    par = PAR.format(i=i) + extra
    jm = jax_model(par)
    rng = np.random.default_rng(seed + i)
    if epochs:
        days = np.sort(rng.uniform(54500, 56500, n_toa // 4))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
    else:
        mjds = np.sort(rng.uniform(54500, 56500, n_toa))
    jt = make_fake_toas_fromMJDs(mjds, jm, error_us=1.0, freq_mhz=1400.0,
                                 obs="gbt", add_noise=True, seed=seed + i,
                                 iterations=0)
    if extra:
        for f in jt.flags:
            f["f"] = "L-wide"
    return par, jm, jt, get_model(par), port_toas(jt)


def side(p, pkg):
    """(model, toas) of one package from a :func:`pulsar` tuple."""
    return (p[1], p[2]) if pkg == "jax" else (p[3], p[4])


def serve_mod(pkg):
    if pkg == "jax":
        import pint_tpu.serve as mod
    else:
        import pint_tpu_torch.serve as mod
    return mod


def engine(pkg, **kw):
    """A ServeEngine of ``pkg`` (the port's on the CPU) with a huge
    flush timer and a 32-TOA bucket floor unless ``kw`` says else."""
    kw.setdefault("max_latency_s", 1e9)
    kw.setdefault("bucket_floor", 32)
    if pkg == "torch":
        kw["device"] = "cpu"
    return serve_mod(pkg).ServeEngine(**kw)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def sigma_gap(a, b, cov):
    sig = np.sqrt(np.diag(np.asarray(cov)))
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / sig))


def assert_fit_close(mine, ref, relative=True):
    """A served fit value against another fit value dict (x, chi2, cov)
    at the tiers above; ``relative=False`` across the packages, whose
    one-ulp phase differences leave F1 (~3e-16) 1.5e-12 apart relative
    at 5e-10 sigma (ROADMAP §3)."""
    if relative:
        assert rel(mine["x"], ref["x"]) <= TOL_REL
    assert sigma_gap(mine["x"], ref["x"], ref["cov"]) <= TOL_SIGMA
    assert abs(mine["chi2"] - ref["chi2"]) <= TOL_CHI2 * abs(ref["chi2"])


@pytest.fixture(scope="module")
def two():
    return [pulsar(0, 24), pulsar(1, 24)]


@pytest.fixture(scope="module")
def noisy():
    return pulsar(3, 20, extra=EFAC + NOISE)


# -- the defect this slice fixes: a program table handed to another batch


def _pair(kind):
    """Two pulsars of one structure whose batches share a signature."""
    if kind == "wls":
        return [pulsar(4, 24), pulsar(5, 24)]
    if kind == "gls-dense":
        return [pulsar(4, 24, extra=EFAC + NOISE),
                pulsar(5, 24, extra=EFAC + NOISE)]
    return [pulsar(4, 24, extra=EFAC + ECORR + NOISE, epochs=True),
            pulsar(5, 24, extra=EFAC + ECORR + NOISE, epochs=True)]


@pytest.mark.parametrize("kind", ["wls", "gls-dense", "gls-ecorr"])
def test_program_table_runs_the_calling_batch(kind):
    """A batch that adopts another batch's program table (what the serve
    engine's executable cache does on every warm flush) fits ITS OWN
    pulsars — bitwise its own fresh fit — and the first batch's next fit
    is unchanged. Residual and phase programs likewise."""
    from pint_tpu_torch.parallel import PTABatch

    a, b = _pair(kind)
    ba = PTABatch([a[3]], [a[4]], pad_toas=32, device="cpu")
    bb = PTABatch([b[3]], [b[4]], pad_toas=32, device="cpu")
    assert ba.shape_signature() == bb.shape_signature()
    fit = ((lambda t: t.wls_fit(maxiter=3)) if kind == "wls"
           else (lambda t: t.gls_fit(maxiter=2)))
    own_b = fit(PTABatch([b[3]], [b[4]], pad_toas=32, device="cpu"))
    own_a = fit(ba)
    ba.time_residuals()
    ba.phases()
    bb._fns = ba._fns
    got_b = fit(bb)
    for g, o in zip(got_b, own_b):
        np.testing.assert_array_equal(g, o)
    for g, o in zip(fit(ba), own_a):
        np.testing.assert_array_equal(g, o)
    fresh = PTABatch([b[3]], [b[4]], pad_toas=32, device="cpu")
    assert torch.equal(bb.time_residuals()[0], fresh.time_residuals()[0])
    assert torch.equal(bb.phases()[0], fresh.phases()[0])
    assert not np.array_equal(got_b[0], own_a[0])


def test_program_table_packed_batch_runs_its_own_data():
    """The packed program builds its slot machinery from the prep it is
    called with: a second plan batch of the same signature served by
    the first one's table fits its own pulsars bitwise."""
    from pint_tpu_torch.parallel import PTABatch, PTAFleet

    ps = [pulsar(10 + i, n, extra=EFAC + NOISE)
          for i, n in enumerate((64, 40, 64, 40))]
    kw = dict(toa_bucket="plan", plan_quantum=8, plan_min_width=128,
              plan_max_pack=2, plan_compile_budget=1, device="cpu")
    fa = PTAFleet([p[3] for p in ps[:2]], [p[4] for p in ps[:2]], **kw)
    fb = PTAFleet([p[3] for p in ps[2:]], [p[4] for p in ps[2:]], **kw)
    (ba,), (bb,) = fa.batches.values(), fb.batches.values()
    assert ba._pack and ba.shape_signature() == bb.shape_signature()
    own_b = bb.gls_fit(maxiter=2)
    bb2 = PTABatch.from_packed(ps[2][3], bb.pack_state(), device="cpu")
    ba.gls_fit(maxiter=2)
    bb2._fns = ba._fns
    for g, o in zip(bb2.gls_fit(maxiter=2), own_b):
        np.testing.assert_array_equal(g, o)


# -- the engine against the JAX engine -----------------------------------


def _scenario_flush_timer(pkg, two):
    m0, t0 = side(two[0], pkg)
    clock = FakeClock()
    eng = engine(pkg, max_batch=8, max_latency_s=0.05, clock=clock)
    mod = serve_mod(pkg)
    res = eng.submit(mod.ResidualRequest(m0, t0))
    out = [eng.poll(), res.done]
    clock.advance(0.051)
    out += [len(eng.poll()), res.status, res.telemetry["queue_wait_s"]]
    return out, res.value["resid_s"]


def _scenario_cache(pkg, two):
    mod = serve_mod(pkg)
    m0, t0 = side(two[0], pkg)
    big = pulsar(1, 40)
    m1, t1 = side(big, pkg)  # pads to bucket 64 != 32: second shape
    eng = engine(pkg, max_batch=1, cache_capacity=1)
    trail = []
    for m, t in ((m0, t0), (m0, t0), (m1, t1), (m0, t0)):
        eng.submit(mod.ResidualRequest(m, t))
        trail.append((eng.cache.misses, eng.cache.hits,
                      eng.cache.evictions))
    return trail, len(eng.cache), eng.cache.counters(), \
        eng.executables_compiled


def _scenario_offline(pkg, two):
    mod = serve_mod(pkg)
    (m0, t0), (m1, t1) = side(two[0], pkg), side(two[1], pkg)
    eng = engine(pkg, max_batch=2)
    fits = [eng.submit(mod.FitRequest(m0, t0, maxiter=3)),
            eng.submit(mod.FitRequest(m1, t1, maxiter=3))]
    rr = eng.submit(mod.ResidualRequest(m0, t0))
    pp = eng.submit(mod.PhasePredictRequest(m0, t0))
    eng.drain()
    return ([dict(r.value) for r in fits], rr.value["resid_s"],
            pp.value["phase"], [r.status for r in fits + [rr, pp]],
            dict(eng.telemetry.counters))


def _scenario_sheds(pkg, two):
    mod = serve_mod(pkg)
    (m0, t0), (m1, t1) = side(two[0], pkg), side(two[1], pkg)
    clock = FakeClock()
    eng = engine(pkg, max_batch=8, max_latency_s=0.2, clock=clock)
    late = eng.submit(mod.ResidualRequest(m0, t0, deadline_s=0.1))
    clock.advance(0.3)
    eng.poll()
    q = engine(pkg, max_batch=8, max_queue=1)
    first = q.submit(mod.ResidualRequest(m0, t0))
    second = q.submit(mod.ResidualRequest(m1, t1))
    first_done = first.done
    q.drain()
    spill = engine(pkg, max_batch=4, oversize_toas=len(t0) - 1)
    sp = spill.submit(mod.ResidualRequest(m0, t0))
    return {
        "late": (late.status, late.reason, late.telemetry["rejected"],
                 late.telemetry["detail"]["deadline_s"],
                 eng.telemetry.counters["shed_deadline"],
                 eng.executables_compiled),
        "queue": (first_done, second.status, second.reason,
                  second.telemetry["detail"]["max_queue"],
                  q.telemetry.counters["shed_queue_full"], first.status),
        "spill": (sp.status, sp.telemetry["spilled"],
                  spill.telemetry.counters["spilled_oversize"],
                  spill.batcher.depth()),
        "spill_resid": sp.value["resid_s"],
    }


@pytest.fixture(scope="module")
def jax_runs(two):
    return {"timer": _scenario_flush_timer("jax", two),
            "cache": _scenario_cache("jax", two),
            "offline": _scenario_offline("jax", two),
            "sheds": _scenario_sheds("jax", two)}


def test_flush_on_full(two):
    mod = serve_mod("torch")
    (m0, t0), (m1, t1) = side(two[0], "torch"), side(two[1], "torch")
    eng = engine("torch", max_batch=2)
    r0 = eng.submit(mod.ResidualRequest(m0, t0))
    assert not r0.done  # slot not full, timer never fires
    r1 = eng.submit(mod.ResidualRequest(m1, t1))
    assert r0.done and r1.done  # second submit filled + flushed
    assert r0.status == "ok" and r1.status == "ok"
    assert eng.telemetry.counters["flushes"] == 1


def test_flush_on_timer_matches_jax(two, jax_runs):
    out, resid = _scenario_flush_timer("torch", two)
    jout, jresid = jax_runs["timer"]
    assert out[:4] == jout[:4] == [[], False, 1, "ok"]
    assert out[4] == pytest.approx(0.051) and jout[4] == pytest.approx(0.051)
    np.testing.assert_allclose(resid, np.asarray(jresid), rtol=0,
                               atol=TOL_RESID_S)


def test_cache_hit_miss_evict_counters_match_jax(two, jax_runs):
    got = _scenario_cache("torch", two)
    assert got[0] == jax_runs["cache"][0] == [(1, 0, 0), (1, 1, 0),
                                              (2, 1, 1), (3, 1, 2)]
    assert got[1] == jax_runs["cache"][1] == 1
    assert got[2] == jax_runs["cache"][2]
    assert got[2]["hit_rate"] == pytest.approx(0.25)
    # warm flushes reuse the cached program table: only cold flushes
    # built one (one per miss)
    assert got[3] == jax_runs["cache"][3] == 3


def test_cache_prefill_and_eviction_frees_programs():
    from pint_tpu_torch.serve import ExecutableCache

    cache = ExecutableCache(capacity=2)
    cache.prefill([(("k", i), {"fns": i}) for i in range(2)])
    assert len(cache) == 2 and cache.misses == 0 and cache.prefilled == 2
    assert cache.lookup(("k", 1)) == {"fns": 1}
    assert cache.hits == 1

    class Prog:
        pass

    import weakref

    table = {"p": Prog()}
    ref = weakref.ref(table["p"])
    cache.insert(("k", 9), table)
    del table
    cache.insert(("k", 10), {})
    assert ref() is not None and cache.evictions == 2
    cache.insert(("k", 11), {})  # evicts ("k", 9): its programs go
    assert ref() is None and cache.evictions == 3
    # a persistent tier behind the LRU: a miss consults the disk
    import tempfile

    from pint_tpu_torch.serve import PersistentExecutableCache

    with tempfile.TemporaryDirectory() as d:
        disk = ExecutableCache(persistent=PersistentExecutableCache(
            d, device="cpu"))
        assert disk.lookup(("k", 0)) is None
        c = disk.counters()
        assert c["misses"] == 1 and c["disk_hits"] == 0
        assert c["disk"]["loads"] == 1 and c["disk"]["load_misses"] == 1


def test_fit_resid_phase_match_jax_and_offline(two, jax_runs):
    from pint_tpu_torch.parallel import PTABatch

    fits, resid, phase, statuses, counters = _scenario_offline("torch",
                                                               two)
    jfits, jresid, jphase, jstatuses, jcounters = jax_runs["offline"]
    assert statuses == jstatuses == ["ok"] * 4
    assert counters == jcounters
    off = PTABatch([two[0][3], two[1][3]], [two[0][4], two[1][4]],
                   device="cpu")
    x_off, chi2_off, cov_off = off.wls_fit(maxiter=3)
    for lane, (mine, ref) in enumerate(zip(fits, jfits)):
        assert_fit_close(mine, {k: np.asarray(v) if k != "chi2" else v
                                for k, v in ref.items()}, relative=False)
        assert_fit_close(mine, {"x": x_off[lane], "chi2": chi2_off[lane],
                                "cov": cov_off[lane]})
        assert mine["free_names"] == list(ref["free_names"])
        assert mine["free_names"] == [n for n, _, _ in off.free_map()]
    r_off, mask = off.time_residuals()
    np.testing.assert_allclose(resid, r_off.numpy()[0][mask[0]], rtol=0,
                               atol=TOL_RESID_S)
    np.testing.assert_allclose(resid, np.asarray(jresid), rtol=0,
                               atol=TOL_RESID_S)
    ph_off, _ = off.phases()
    np.testing.assert_allclose(phase, ph_off.numpy()[0][mask[0]], rtol=0,
                               atol=TOL_PHASE)
    np.testing.assert_allclose(phase, np.asarray(jphase), rtol=0,
                               atol=TOL_PHASE)


def test_sheds_and_spill_match_jax(two, jax_runs):
    from pint_tpu_torch.parallel import PTABatch

    got, ref = _scenario_sheds("torch", two), jax_runs["sheds"]
    assert got["late"] == ref["late"] == ("shed", "deadline", True, 0.1,
                                          1, 0)
    assert got["queue"] == ref["queue"] == (False, "shed", "queue_full",
                                            1, 1, "ok")
    assert got["spill"] == ref["spill"] == ("ok", True, 1, 0)
    off = PTABatch([two[0][3]], [two[0][4]], device="cpu")
    r_off, mask = off.time_residuals()
    np.testing.assert_allclose(got["spill_resid"], r_off.numpy()[0][mask[0]],
                               rtol=0, atol=TOL_RESID_S)
    np.testing.assert_allclose(got["spill_resid"],
                               np.asarray(ref["spill_resid"]), rtol=0,
                               atol=TOL_RESID_S)


def test_mixed_degrades_to_f64(monkeypatch, noisy):
    """A mixed-precision GLS whose refinement reports failure (a NaN
    rel_resid) falls back to f64 inside PTABatch's finalize, whose
    warning carries the policy's marker, and the engine counts it as
    degraded — with a correct result (the JAX test's contract)."""
    from pint_tpu_torch import fitter
    from pint_tpu_torch.parallel import PTABatch, pta
    from pint_tpu_torch.serve import FitRequest, policy

    assert policy.MIXED_FALLBACK_MARK == "refitting in f64"
    real_refine = fitter.gls_eigh_refine

    def nan_refine(A, b, matvec, threshold=1e-12, iters=2):
        dxn, covn, r = real_refine(A, b, matvec, threshold, iters)
        return dxn, covn, torch.full_like(r, float("nan"))

    monkeypatch.setattr(pta, "gls_eigh_refine", nan_refine)
    _, _, _, m, t = noisy
    with pytest.warns(UserWarning, match=policy.MIXED_FALLBACK_MARK):
        PTABatch([m], [t], device="cpu").gls_fit(maxiter=2,
                                                 precision="mixed")
    eng = engine("torch", max_batch=1)
    res = eng.submit(FitRequest(m, t, method="gls", maxiter=2,
                                precision="mixed"))
    assert res.status == "ok"
    assert res.telemetry["degraded"] is True
    assert eng.telemetry.counters["degraded_mixed"] == 1
    monkeypatch.setattr(pta, "gls_eigh_refine", real_refine)
    x_off, _, _ = PTABatch([m], [t], device="cpu").gls_fit(
        maxiter=2, precision="f64")
    np.testing.assert_allclose(res.value["x"], x_off[0], rtol=1e-10,
                               atol=0)


def test_single_fitter_fallback_carries_the_marker(monkeypatch):
    from pint_tpu_torch import fitter
    from pint_tpu_torch.serve import policy

    real_refine = fitter.gls_eigh_refine

    def nan_refine(A, b, matvec, threshold=1e-12, iters=2):
        dxn, covn, r = real_refine(A, b, matvec, threshold, iters)
        return dxn, covn, torch.full_like(r, float("nan"))

    monkeypatch.setattr(fitter, "gls_eigh_refine", nan_refine)
    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.standard_normal((12, 3)))
    r = torch.as_tensor(rng.standard_normal(12))
    with pytest.warns(UserWarning, match=policy.MIXED_FALLBACK_MARK):
        fitter.gls_solve(M, r, torch.ones(12, dtype=torch.float64),
                         torch.zeros(3, dtype=torch.float64),
                         precision="mixed")


# -- warm slots serve other pulsars (the cache-reuse witness) ------------


def _slot_pulsars():
    return [pulsar(20 + i, 20 + 2 * i, extra=EFAC + NOISE)
            for i in range(4)]


def test_warm_slot_serves_other_pulsars():
    """Two flushes of one warm slot with disjoint pulsars each equal
    their own offline fit (not the other flush's), with one capture for
    the slot; a third flush of the first pulsars again still does."""
    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.serve import FitRequest

    ps = _slot_pulsars()
    eng = engine("torch", max_batch=2)
    flushes = []
    for pair in (ps[:2], ps[2:], ps[:2]):
        out = [eng.submit(FitRequest(p[3], p[4], method="gls", maxiter=2))
               for p in pair]
        flushes.append(out)
    assert eng.executables_compiled == 1
    assert (eng.cache.hits, eng.cache.misses) == (2, 1)
    for pair, out in zip((ps[:2], ps[2:], ps[:2]), flushes):
        x, chi2, cov = PTABatch([p[3] for p in pair], [p[4] for p in pair],
                                pad_toas=32, device="cpu").gls_fit(maxiter=2)
        for lane, res in enumerate(out):
            assert res.status == "ok" and res.telemetry["bucket"] == 32
            np.testing.assert_array_equal(res.value["x"], x[lane])
            assert res.value["chi2"] == chi2[lane]
    assert not np.allclose(flushes[1][0].value["x"],
                           flushes[0][0].value["x"], rtol=1e-9)
    for a, b in zip(flushes[0], flushes[2]):
        np.testing.assert_array_equal(a.value["x"], b.value["x"])


def test_prefill_from_fleet_serves_its_own_pulsars():
    """An offline pow2 fleet's program, adopted by the engine
    (``prefill_from_fleet``), fits the flush's pulsars — not the
    fleet's — and the fleet's next fit is bitwise its first."""
    from pint_tpu_torch.parallel import PTABatch, PTAFleet
    from pint_tpu_torch.serve import FitRequest

    ps = _slot_pulsars()
    # the fleet's batch must be as wide as the serve slot's bucket for
    # the entry to hit: a 32-TOA pulsar makes the pow2 batch 32 wide
    ps[0] = pulsar(20, 32, extra=EFAC + NOISE)
    fleet = PTAFleet([p[3] for p in ps[:2]], [p[4] for p in ps[:2]],
                     toa_bucket="pow2", bucket_floor=32, device="cpu")
    assert next(iter(fleet.batches.values())).batch.tdb_sec.shape[1] == 32
    fleet.precompile(method="auto", maxiter=3)
    first = fleet.fit(method="auto", maxiter=3)
    eng = engine("torch", max_batch=2)
    assert eng.prefill_from_fleet(fleet, maxiter=3) == 1
    out = [eng.submit(FitRequest(p[3], p[4], maxiter=3)) for p in ps[2:]]
    assert eng.executables_compiled == 0 and eng.cache.hits == 1
    x, chi2, _ = PTABatch([p[3] for p in ps[2:]], [p[4] for p in ps[2:]],
                          pad_toas=32, device="cpu").gls_fit(maxiter=3)
    for lane, res in enumerate(out):
        np.testing.assert_array_equal(res.value["x"], x[lane])
    again = fleet.fit(method="auto", maxiter=3)
    for a, b in zip(first[0], again[0]):
        np.testing.assert_array_equal(a, b)


# -- prewarm paths, tracing, streaming appends, the bench ---------------


def test_prewarm_concurrent_keys_match_the_lazy_path(two, noisy):
    from pint_tpu_torch.serve import FitRequest, PhasePredictRequest

    reqs = [FitRequest(two[0][3], two[0][4], maxiter=3),
            FitRequest(noisy[3], noisy[4], method="gls", maxiter=2),
            PhasePredictRequest(two[1][3], two[1][4])]
    warm = engine("torch", max_batch=2)
    assert warm.prewarm_concurrent(reqs, max_workers=2) == 3
    lazy = engine("torch", max_batch=2)
    assert lazy.prewarm(reqs) == 3
    assert sorted(map(repr, warm.cache.keys())) == \
        sorted(map(repr, lazy.cache.keys()))
    assert warm.cache.counters()["hits"] == 0
    res = warm.run_stream(reqs)
    assert all(r.status == "ok" for r in res)
    assert warm.executables_compiled == 3 and warm.cache.misses == 0


def test_prewarm_ladder_warms_every_planned_width(two):
    from pint_tpu_torch.parallel.shapeplan import plan_shapes
    from pint_tpu_torch.serve import FitRequest

    plan = plan_shapes([20, 24, 60, 90], quantum=8, max_pack=1,
                       min_width=16, compile_budget=3)
    eng = engine("torch", max_batch=2, plan=plan)
    req = FitRequest(two[0][3], two[0][4], maxiter=3)
    n = eng.prewarm_ladder(req)
    assert n == len([w for w in plan.widths if w >= 24]) >= 2
    assert all(k[-1] == plan.signature() for k in eng.cache.keys())
    with pytest.raises(ValueError, match="shape plan"):
        engine("torch").prewarm_ladder(req)


def test_traced_stream_bitwise_and_spans(two, noisy):
    from pint_tpu_torch.obs import trace
    from pint_tpu_torch.serve import FitRequest, result_digest

    reqs = [FitRequest(two[i % 2][3], two[i % 2][4], maxiter=3)
            for i in range(4)]
    reqs.append(FitRequest(noisy[3], noisy[4], method="gls", maxiter=2))
    plain = engine("torch", max_batch=2).run_stream(reqs)
    trace.reset()
    trace.enable(jax_annotations=True)
    try:
        traced = engine("torch", max_batch=2).run_stream(reqs)
    finally:
        trace.disable()
    assert [result_digest(r.value) for r in plain] == \
        [result_digest(r.value) for r in traced]
    names = {}
    for sp in trace.spans():
        names[sp["name"]] = names.get(sp["name"], 0) + 1
    assert names["serve.flush"] == 3 and names["serve.compile"] == 2
    assert names["serve.run"] == 3 and names["serve.pack"] == 3
    assert names["excache.lookup"] == 3 and names["retry.attempt"] == 3
    assert trace.TRACER.jax_annotations is False  # disable() resets it
    trace.reset()


def test_append_lanes_through_the_engine_match_direct_and_jax():
    """register_append_lane + AppendToasRequest is the refitter's append
    bitwise (a mixed lane), and the JAX engine's, same precision, within
    1e-6 sigma (chi2 1e-9) with the same counters; an unregistered
    pulsar's append is rejected with the JAX engine's reason."""
    from pint_tpu.serve import AppendToasRequest as JaxAppend
    from pint_tpu.serve import ServeEngine as JaxEngine
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.serve import AppendToasRequest, StreamingRefitter

    from test_torch_incremental import _lane_sigma

    par, jm, jt, m, t = pulsar(7, 48)
    new = [make_fake_toas_fromMJDs(np.linspace(56510 + 100 * k, 56600
                                               + 100 * k, 8), jm,
                                   error_us=1.0, freq_mhz=1400.0,
                                   obs="gbt", add_noise=True, seed=77 + k,
                                   iterations=0) for k in range(2)]
    direct = StreamingRefitter(device="cpu")
    direct.register(m, t, precision="mixed")
    for precision in ("mixed", "f64"):
        eng = engine("torch")
        jeng = JaxEngine(max_batch=8, bucket_floor=32)
        assert eng.register_append_lane(m, t, precision=precision) \
            == jeng.register_append_lane(jm, jt, precision=precision) \
            == "SRVT7"
        for k, c in enumerate(new):
            res = eng.submit(AppendToasRequest(m, port_toas(c),
                                               precision=precision))
            jres = jeng.submit(JaxAppend(jm, c, precision=precision))
            assert res.status == jres.status == "ok"
            if precision == "mixed":
                ref = direct.append(m, port_toas(c),
                                    rid=res.request.request_id)
                np.testing.assert_array_equal(res.value["x"], ref["x"])
                assert res.value["chi2"] == ref["chi2"]
            sig = _lane_sigma(eng.streaming.lanes["SRVT7"])
            x_j = np.asarray(jres.value["x"])
            assert np.max(np.abs(res.value["x"] - x_j) / sig) <= TOL_SIGMA
            assert abs(res.value["chi2"] - jres.value["chi2"]) \
                <= TOL_CHI2 * abs(jres.value["chi2"])
        assert eng.telemetry.counters == jeng.telemetry.counters
        assert eng.streaming.counters() == jeng.streaming.counters()
    lost = pulsar(8, 24)
    out = [e.submit(req(lost[1 if e is jeng else 3],
                        lost[2] if e is jeng else lost[4]))
           for e, req in ((eng, AppendToasRequest), (jeng, JaxAppend))]
    assert [r.status for r in out] == ["rejected", "rejected"]
    assert [r.reason for r in out] == ["lane_unregistered"] * 2
    assert [r.telemetry["detail"]["lane"] for r in out] == ["SRVT8"] * 2


def test_serve_bench_stream_on_cpu():
    """The slice's entry point at a tiny size: zero recompiles after
    warm-up, every status ok, fits within 1e-12 of the offline fleet,
    exactly one terminal lifecycle state, the ledger bitwise neutral."""
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    rep = bench.run_serve_stream(n_requests=12, sizes=(24, 40),
                                 per_combo=1, bucket_floor=32, maxiter=2,
                                 max_batch=2, concurrent_prewarm=True,
                                 device="cpu")
    assert rep["statuses"] == {"ok": 12}
    assert rep["recompiles_after_warmup"] == 0
    assert rep["cache"]["hit_rate"] == 1.0
    assert rep["max_param_rel_diff_vs_offline"] <= TOL_REL
    assert rep["max_param_sigma_diff_vs_offline"] <= TOL_SIGMA
    assert rep["reqlife_exactly_one_terminal"]
    assert rep["reqlife_bitwise_on_off"]
    assert rep["fleet_pipeline_bitwise"]
    assert len(rep["result_digests"]) == 12
    # the device chaos through the CLI, on a toy fleet: --devices lanes
    # and a device-level --fault-point (the request chaos and the kill
    # matrix run in tests/test_torch_crash_recovery.py)
    build = bench.build_serve_fleet
    try:
        bench.build_serve_fleet = lambda sizes, per_combo, seed, device: \
            build(sizes=(24, 40), per_combo=1, seed=seed, device=device)
        for argv in (["--chaos", "--devices", "2", "--fault-point",
                      "device_loss"],
                     ["--chaos", "--fault-point", "collective_timeout"]):
            assert bench.main(argv + ["--device", "cpu", "--requests", "8",
                                      "--max-batch", "2", "--maxiter", "2",
                                      "--bucket-floor", "32"]) == 0
    finally:
        bench.build_serve_fleet = build


def test_build_serve_fleet_matches_jax():
    """The bench fleet: the port's maker gives the JAX package's TOAs
    (1e-12 s) and the same structures."""
    from pint_tpu.scripts import pint_serve_bench as jbench
    from pint_tpu_torch.parallel import PTABatch
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    jm, jt = jbench.build_serve_fleet(sizes=(12,), per_combo=1)
    m, t = bench.build_serve_fleet(sizes=(12,), per_combo=1, device="cpu")
    assert len(m) == len(jm) == 3
    for a, b in zip(t, jt):
        np.testing.assert_array_equal(a.day, b.day)
        assert np.max(np.abs(np.asarray(a.sec) - np.asarray(b.sec))) <= 1e-12
        assert [f.get("f") for f in a.flags] == [f.get("f") for f in b.flags]
    assert len({PTABatch.structure_key(x) for x in m}) == 3


# -- signatures ---------------------------------------------------------


PUBLIC = {
    "serve.engine": ["ServeEngine"],
    "serve.frontdoor": ["AsyncServeEngine", "IntakeQueue"],
    "serve.batcher": ["MicroBatcher", "pow2_bucket"],
    "serve.excache": ["ExecutableCache"],
    "serve.admission": ["AdmissionController", "AdmissionDecision"],
    "serve.metrics": ["ServeTelemetry", "tenant_cap"],
    "serve.policy": ["resolve", "is_oversize", "expired", "rejection",
                     "mixed_fell_back", "has_correlated_noise"],
    "serve.request": ["TimingRequest", "FitRequest", "ResidualRequest",
                      "PhasePredictRequest", "AppendToasRequest",
                      "ServeResult", "ensure_request_counter_above"],
    "serve.recovery": ["result_digest"],
    "serve.streaming": ["StreamingRefitter"],
    "obs.trace": ["Span", "Tracer", "span", "current_trace_id", "enable",
                  "disable", "enabled", "spans", "reset"],
    "obs.reqlife": ["LifecycleLedger", "phase_split", "tail_artifact",
                    "resolve_tail"],
    "resilience.retry": ["is_retryable", "BackoffPolicy", "with_retries",
                         "CircuitBreaker"],
    "resilience.health": ["HealthMonitor"],
    "resilience.faultinject": ["FaultInjected", "FaultPoint", "fire",
                               "fire_kill", "kill_armed_at", "armed", "arm",
                               "disarm", "inject", "parse_spec",
                               "arm_from_env", "add_observer"],
    "scripts.pint_serve_bench": ["build_serve_fleet", "run_serve_stream",
                                 "main"],
}


def _callables(obj):
    """(name, callable) of obj and, for a class, its public methods."""
    out = [("", obj)]
    if inspect.isclass(obj):
        out += [(n, f) for n, f in vars(obj).items()
                if callable(f) and (not n.startswith("_") or n == "__init__")]
    return out


def _default(d):
    # callables (is_retryable, time.monotonic) by name: each package
    # has its own copy
    return getattr(d, "__qualname__", d) if callable(d) else d


def _params(fn):
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("module", sorted(PUBLIC))
def test_signatures_match_jax(module):
    """Every public callable ported with the engine takes the JAX
    package's parameters with the same defaults, bar a trailing
    ``device`` keyword; the module constants agree."""
    import importlib

    jmod = importlib.import_module("pint_tpu." + module)
    tmod = importlib.import_module("pint_tpu_torch." + module)
    for name in PUBLIC[module]:
        for attr, tfn in _callables(getattr(tmod, name)):
            jfn = (getattr(jmod, name) if not attr
                   else getattr(getattr(jmod, name), attr))
            if inspect.isclass(tfn) and not attr and hasattr(
                    tfn, "__dataclass_fields__"):
                assert list(tfn.__dataclass_fields__) == \
                    list(jfn.__dataclass_fields__)
                continue
            if inspect.isclass(tfn):
                continue
            tp, jp = _params(tfn), _params(jfn)
            if tp and tp[-1][0] == "device" and jp[-1:] != tp[-1:]:
                tp = tp[:-1]
            assert tp == jp, f"{module}.{name}.{attr}"
    for const in ("DEFAULT_OVERSIZE_TOAS", "MIXED_FALLBACK_MARK",
                  "POINTS", "KILL_SITES", "DEVICE_POINTS", "STATES",
                  "STATE_VERSION", "TERMINAL_STATES", "HAPPY_PATH",
                  "TRANSIENT_MARKS", "PRIORITY_HIGH", "PRIORITY_NORMAL",
                  "PRIORITY_BATCH"):
        if hasattr(jmod, const):
            assert getattr(tmod, const) == getattr(jmod, const)


def _serve_on_mesh(s):
    """ServeEngine(mesh=): a 4-lane flush sharded 2 + 2 over a CPU mesh
    serves the plain engine's fits at the f64 tier."""
    from pint_tpu_torch.parallel import make_mesh

    ps = [pulsar(10 + i, 24) for i in range(3)]
    reqs = lambda: [s.FitRequest(p[3], p[4], maxiter=2)  # noqa: E731
                    for p in ps]
    plain = engine("torch", max_batch=4).run_stream(reqs())
    meshed = engine("torch", max_batch=4,
                    mesh=make_mesh(devices=["cpu"] * 2))
    assert meshed.device == torch.device("cpu")
    for r, q in zip(plain, meshed.run_stream(reqs())):
        assert r.status == q.status == "ok"
        assert_fit_close(q.value, r.value)


def _serve_on_devices(s):
    """ServeEngine(devices=): a device_loss mid-stream quarantines the
    routed lane and re-routes its slot; every request completes, bitwise
    the fault-free stream, and the snapshot's devices block says so."""
    from pint_tpu_torch.resilience import FaultPoint, inject

    ps = [pulsar(12 + i, 24) for i in range(2)]
    reqs = lambda: [s.FitRequest(p[3], p[4], maxiter=2)  # noqa: E731
                    for p in ps]
    clean = engine("torch", max_batch=1, devices=["cpu"] * 2).run_stream(
        reqs())
    eng = engine("torch", max_batch=1, devices=["cpu"] * 2)
    with inject(FaultPoint("device_loss", rate=1.0, count=1)):
        chaos = eng.run_stream(reqs())
    assert all(r.status == "ok" for r in chaos)
    for rc, rf in zip(clean, chaos):
        assert np.array_equal(rc.value["x"], rf.value["x"])
        assert np.array_equal(rc.value["cov"], rf.value["cov"])
    assert eng.telemetry.counters.get("device_lost", 0) == 1
    snap = eng.snapshot()["devices"]
    assert len(snap["lost_lanes"]) == 1 and snap["alive_lanes"] == 1


def _refitter_on_mesh(s):
    """StreamingRefitter(mesh=): a lane on the mesh's device appends
    bitwise the device="cpu" refitter."""
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.parallel import make_mesh

    par, jm, jt, m, t = pulsar(14, 48)
    new = port_toas(make_fake_toas_fromMJDs(
        np.linspace(56510, 56600, 8), jm, error_us=1.0, freq_mhz=1400.0,
        obs="gbt", add_noise=True, seed=140, iterations=0))
    outs = []
    for kw in ({"device": "cpu"}, {"mesh": make_mesh(devices=["cpu"])}):
        ref = s.StreamingRefitter(**kw)
        ref.register(m, t, precision="mixed")
        outs.append(ref.append(m, new, rid="r0"))
    assert outs[0].keys() == outs[1].keys()
    assert np.array_equal(outs[0]["x"], outs[1]["x"])
    assert outs[0]["chi2"] == outs[1]["chi2"]
    assert outs[1]["solver"] == outs[0]["solver"] != "full_refit"


def _device_chaos(s):
    """run_device_chaos at a toy size on two CPU lanes: both legs ok."""
    from pint_tpu_torch.scripts import pint_serve_bench as bench

    rep = bench.run_device_chaos(n_requests=8, n_devices=2, max_batch=2,
                                 bucket_floor=32, sizes=(24, 40),
                                 per_combo=1, maxiter=2, device="cpu")
    assert rep["ok"] and rep["serve_bitwise_vs_clean"], rep
    assert rep["devices"] == ["cpu", "cpu"]


@pytest.mark.parametrize("call,item", [
    pytest.param(_serve_on_mesh, "item 2", id="call0-item 2"),
    pytest.param(_serve_on_devices, "item 2", id="call1-item 2"),
    pytest.param(_refitter_on_mesh, "item 2", id="call4-item 2"),
    pytest.param(_device_chaos, "item 2", id="call5-item 2"),
])
def test_waiting_keywords_raise_naming_their_item(call, item):
    """The keywords that waited on ROADMAP §1 ``item`` (multi-device) and
    raised naming it now work: each builds and serves on the CPU."""
    import pint_tpu_torch.serve as s

    call(s)


@pytest.mark.parametrize("attach,kind", [
    ("attach_slo", "BurnRateMonitor"),
    ("attach_fit_quality", "DriftBoard")])
def test_observability_keywords_attach(attach, kind):
    """attach_slo / attach_fit_quality build their monitor (obs.slo,
    obs.drift) where they once waited with the observability queue."""
    from pint_tpu_torch.obs import fitquality
    from pint_tpu_torch.serve import ServeEngine

    eng = ServeEngine(device="cpu")
    try:
        assert type(getattr(eng, attach)()).__name__ == kind
    finally:
        fitquality.disable()
        fitquality.FITQ.reset()


@pytest.mark.parametrize("kw", ["durable_dir", "excache_dir", "store_dir"])
def test_durable_keywords_construct(tmp_path, kw):
    """The durability keywords build their layer (serve/journal.py, the
    persisted tier, the stores) where they once waited; recover()
    needs a journal."""
    from pint_tpu_torch.serve import ServeEngine

    eng = ServeEngine(device="cpu", **{kw: tmp_path / kw})
    assert (eng.journal is not None) == (kw == "durable_dir")
    assert (eng.cache.persistent is not None) == (kw != "store_dir")
    assert (eng.store is not None) == (kw != "excache_dir")
    assert (eng.deltas is not None) == (kw != "excache_dir")
    if kw == "durable_dir":
        assert eng.recover()["n_replayed"] == 0
        eng.journal.close()
    else:
        with pytest.raises(ValueError, match="no journal"):
            eng.recover()


def test_engine_needs_a_card_unless_told_cpu():
    from pint_tpu_torch.serve import ServeEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine()
