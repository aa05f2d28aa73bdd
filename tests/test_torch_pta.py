"""The port's batched GLS refit (pint_tpu_torch/parallel/pta.py) against
the JAX package's, on the same TOAs: the shape-planned fleet
(``PTAFleet(toa_bucket="plan")``) with a segment-packed bucket and an
unpacked one, in f64 and in mixed precision, built from the same TOAs
and from the JAX package's ``pack_state()``.

The fleets are small (6 pulsars, 64-512 TOAs, 8 red-noise harmonics)
with a fine plan quantum so that three pulsars share a packed row.

Tolerances: parameters to 1e-6 sigma — the measured gap is ~1e-7 sigma,
set by one-ulp differences in the phase's largest term (~1e-11 cycles,
~1e-13 s against 1 us TOA errors); chi2 to 1e-9 relative; covariances
to 1e-10 relative in f64 and 1e-4 in mixed precision, where both
packages take the covariance from the factorization of an
f32-accumulated Gram, each within ~kappa * 1e-7 of the f64 covariance
in its own summation order (measured gap between them: 2e-5 on the
no-ECORR fleet).
"""

import warnings

import numpy as np
import pytest
import torch

BASE = ("PSR T{i}\nRAJ {ra}:{rm:02d}:00.0\nDECJ {dec}:15:00.0\n"
        "F0 {f0}.707 1\nF1 -{f1}e-16 1\nPEPOCH 55500\nDM {dm}.17 1\n"
        "EFAC -f L-wide 1.1{efac_fit}\nEQUAD -f L-wide 0.4\n"
        "{ecorr}RNAMP 1e-14\nRNIDX -3.1\nTNREDC 8\n")
COUNTS = [512, 100, 96, 80, 64, 120]
PLAN = dict(toa_bucket="plan", plan_quantum=32, plan_min_width=256,
            plan_max_pack=4, plan_compile_budget=2)


def par(i, ecorr=True, free_efac=False):
    return BASE.format(i=i, ra=i % 24, rm=(11 * i) % 60, dec=(i * 5) % 70 - 35,
                       f0=170 + 3 * i, f1=1 + i, dm=5 + i,
                       efac_fit=" 1" if free_efac else "",
                       ecorr="ECORR -f L-wide 0.8\n" if ecorr else "")


def port_toas(jt):
    """The JAX package's TOAs as the port's barycentred TOAs."""
    from pint_tpu_torch.mjd import Epochs
    from pint_tpu_torch.toa import TOAs
    from pint_tpu_torch.utils import PosVel

    return TOAs.from_arrays(
        jt.day, jt.sec, error_us=jt.error_us, freq_mhz=jt.freq_mhz,
        obs=jt.obs, flags=[dict(f) for f in jt.flags],
        tdb=Epochs(jt.tdb.day, jt.tdb.sec, "tdb", jt.tdb.lo),
        ssb_obs=PosVel(jt.ssb_obs.pos, jt.ssb_obs.vel),
        obs_sun=PosVel(jt.obs_sun.pos, jt.obs_sun.vel),
        planet_pos=dict(jt.planet_pos))


def make_toas(iterations=0, **par_kw):
    """(pars, JAX models, JAX TOAs): noisy TOAs of the COUNTS pulsars.
    ``iterations`` is the simulator's: with 0 the TOAs are built in one
    pass and the post-fit residuals keep a ~ms systematic."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(3)
    pars, jms, jts = [], [], []
    for i, n in enumerate(COUNTS):
        p = par(i, **par_kw)
        days = np.sort(rng.uniform(54000, 57000, n // 4))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
        jm = jax_model(p)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jt = make_fake_toas_fromMJDs(mjds, jm, error_us=1.0,
                                         freq_mhz=freqs, obs="gbt",
                                         add_noise=True, seed=i,
                                         iterations=iterations)
        for f in jt.flags:
            f["f"] = "L-wide"
        pars.append(p)
        jms.append(jm)
        jts.append(jt)
    return pars, jms, jts


def make_fleets(**par_kw):
    """(JAX fleet, port fleet, pars) from the same noisy TOAs."""
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTAFleet

    pars, jms, jts = make_toas(**par_kw)
    jf = JaxFleet(jms, jts, **PLAN)
    tf = PTAFleet([get_model(p) for p in pars], [port_toas(t) for t in jts],
                  device="cpu", **PLAN)
    return jf, tf, pars


def compare(xj, cj, covj, xt, ct, covt, cov_tol):
    sig = np.sqrt(np.array([np.diag(c) for c in covj]))
    dx = np.abs(np.array(xt) - np.array(xj)) / sig
    assert dx.max() <= 1e-6, dx.max()
    cj, ct = np.asarray(cj), np.asarray(ct)
    assert np.abs(ct - cj).max() <= 1e-9 * np.abs(cj).max()
    for a, b in zip(covt, covj):
        assert np.abs(a - b).max() <= cov_tol * np.abs(b).max()
    return dx.max()


@pytest.fixture(scope="module")
def bench_fleets():
    return make_fleets()


def test_plan_layout_matches(bench_fleets):
    jf, tf, _ = bench_fleets
    assert list(tf.group_indices) == list(jf.group_indices)
    assert list(tf.group_indices.values()) == list(jf.group_indices.values())
    assert tf.padding_ratio == jf.padding_ratio
    packed = [b for b in tf.batches.values() if b._pack]
    assert packed and packed[0]._pack["n_slots"] == 3


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_fleet_fit_matches_jax(bench_fleets, precision):
    jf, tf, _ = bench_fleets
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, cj, covj = jf.fit(method="gls", maxiter=2, precision=precision)
    xt, ct, covt = tf.fit(method="gls", maxiter=2, precision=precision)
    compare(xj, cj, covj, xt, ct, covt,
            1e-10 if precision == "f64" else 1e-4)
    relres = [m["relres_max"] for m in tf.fit_metrics.values()]
    assert not any(m["refit_f64"] for m in tf.fit_metrics.values())
    assert max(relres) <= (1e-8 if precision == "mixed" else 0.0)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_from_jax_pack_state(bench_fleets, precision):
    """PTABatch.from_packed on the JAX package's pack_state() (the
    bit-identical packed inputs) fits like the JAX batch."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTABatch

    jf, _, pars = bench_fleets
    for key, jb in jf.batches.items():
        tb = PTABatch.from_packed(get_model(pars[jf.group_indices[key][0]]),
                                  jb.pack_state(), device="cpu")
        assert (tb._pack is None) == (jb._pack is None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            xj, cj, covj = jb.gls_fit(maxiter=2, precision=precision)
        xt, ct, covt = tb.gls_fit(maxiter=2, precision=precision)
        compare(xj, cj, covj, xt, ct, covt,
                1e-10 if precision == "f64" else 1e-4)


def test_pack_state_round_trip(bench_fleets):
    """The port's own pack_state rebuilds a batch that fits bit-for-bit
    like the original."""
    from pint_tpu_torch.parallel.pta import PTABatch

    _, tf, _ = bench_fleets
    for b in tf.batches.values():
        b2 = PTABatch.from_packed(b.template, b.pack_state(), device="cpu")
        for a, c in zip(b.gls_fit(precision="mixed"),
                        b2.gls_fit(precision="mixed")):
            np.testing.assert_array_equal(a, c)


def test_packed_fused_matches_classic(bench_fleets):
    """Inside the port: the fused one-pass packed program against the
    classic three-pass one (f64), to 1e-9 sigma."""
    _, tf, _ = bench_fleets
    b = next(b for b in tf.batches.values() if b._pack)
    xf, cf, covf = b.gls_fit(precision="f64")
    xc, cc, covc = b.gls_fit(precision="f64", fused=False)
    sig = np.sqrt(np.array([np.diag(c) for c in covc]))
    assert (np.abs(xf - xc) / sig).max() <= 1e-9
    assert np.abs(cf - cc).max() <= 1e-12 * np.abs(cc).max()
    with pytest.raises(ValueError, match="f64-only"):
        b.gls_fit(precision="mixed", fused=False)


@pytest.mark.parametrize("case,precision", [("no_ecorr", "mixed"),
                                            ("free_efac", "f64")])
def test_other_gls_programs_match_jax(case, precision):
    """The dense solve (no ECORR) and the non-hoisted marginalised one
    (a free EFAC turns the noise hoist off) against the JAX package."""
    kw = {"ecorr": False} if case == "no_ecorr" else {"free_efac": True}
    jf, tf, _ = make_fleets(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, cj, covj = jf.fit(method="gls", maxiter=2, precision=precision)
    xt, ct, covt = tf.fit(method="gls", maxiter=2, precision=precision)
    if case == "free_efac":
        # EFAC does not enter the phase: its design column is zero and
        # dropped by the eigenvalue cut in both packages (zero variance)
        covj = [c[:3, :3] for c in covj]
        covt = [c[:3, :3] for c in covt]
        xj = [x[:3] for x in xj]
        xt = [x[:3] for x in xt]
    compare(xj, cj, covj, xt, ct, covt,
            1e-10 if precision == "f64" else 1e-4)


def test_solve_core_matches_jax():
    """fitter's thresholded eigh solve and mixed refinement against the
    JAX package's on random systems with one exactly degenerate
    direction (dropped by the GLS_EIG_FLOOR cut in both) and one
    ill-conditioned direction; NaN relres counts as failed."""
    import jax.numpy as jnp
    from pint_tpu import fitter as jf
    from pint_tpu_torch import fitter as tf

    rng = np.random.default_rng(5)
    Mn = rng.normal(size=(2, 300, 7))
    Mn[:, :, 6] = Mn[:, :, 5]  # degenerate pair
    Mn[:, :, 4] *= 1e-3  # ill-conditioned
    q = np.abs(rng.normal(size=(2, 7))) * 0.1
    z = rng.normal(size=(2, 300))
    for s in range(2):
        A, b, rnr = jf.gls_fused_normal(jnp.asarray(Mn[s]), jnp.asarray(z[s]),
                                        jnp.asarray(q[s]))
        dj, cj = jf.gls_eigh_solve(A, b)
        At, bt, rnrt = tf.gls_fused_normal(torch.as_tensor(Mn[s]),
                                           torch.as_tensor(z[s]),
                                           torch.as_tensor(q[s]))
        dt, ct = tf.gls_eigh_solve(At, bt)
        assert abs(float(rnrt) - float(rnr)) <= 1e-12 * float(rnr)
        assert np.abs(dt.numpy() - np.asarray(dj)).max() <= 1e-9 * np.abs(np.asarray(dj)).max()
        assert np.abs(ct.numpy() - np.asarray(cj)).max() <= 1e-9 * np.abs(np.asarray(cj)).max()
    # batched mixed refinement against the JAX per-segment form
    Mt = torch.as_tensor(Mn)
    qt = torch.as_tensor(q)
    At = tf.gls_gram(Mt, qt, "mixed")
    bt = tf._mtv(Mt, torch.as_tensor(z))
    dt, ct, rt = tf.seg_gls_eigh_refine(
        At, bt, lambda v: tf._mtv(Mt, tf._mv(Mt, v)) + qt * qt * v)
    Aj = jnp.einsum("sni,snj->sij", jnp.asarray(Mn, jnp.float32),
                    jnp.asarray(Mn, jnp.float32)).astype(jnp.float64)
    Aj = Aj + jnp.asarray(np.stack([np.diag(x * x) for x in q]))
    dj, cj, rj = jf.seg_gls_eigh_refine(
        Aj, jnp.asarray(bt.numpy()),
        lambda v: jnp.einsum("sni,sn->si", jnp.asarray(Mn),
                             jnp.einsum("snj,sj->sn", jnp.asarray(Mn), v))
        + jnp.asarray(q * q) * v)
    assert float(rt.max()) <= 1e-8 and float(np.max(rj)) <= 1e-8
    assert np.abs(dt.numpy() - np.asarray(dj)).max() <= 1e-9 * np.abs(np.asarray(dj)).max()
    assert tf.relres_failed(np.array([1e-12, np.nan]))
    assert not tf.relres_failed(rt.numpy())


@pytest.fixture(scope="module")
def three_pulsars():
    """(models, TOAs): 3 pulsars of the BASE template (96, 80, 64 TOAs)
    made by the port's simulator on the CPU."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(3)
    models, toas = [], []
    for i, n in enumerate((96, 80, 64)):
        m = get_model(par(i))
        days = np.sort(rng.uniform(54000, 57000, n // 4))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            toas.append(make_fake_toas_fromMJDs(
                mjds, m, error_us=1.0, freq_mhz=freqs, obs="gbt",
                add_noise=True, seed=i, iterations=0,
                flags={"f": "L-wide"}, device="cpu"))
        models.append(m)
    return models, toas


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_mixed_fallback_is_per_pulsar(three_pulsars, monkeypatch, layout):
    """A pulsar whose mixed refinement fails (its relres forced through
    ``_pull_rows``) takes its row of the batch's f64 fit, bitwise; the
    other pulsars keep their mixed rows, bitwise, so no pulsar's
    precision depends on its neighbours. The fallback is counted and
    flagged for that pulsar only. In the packed layout relres is per
    pulsar after ``_pull_rows`` (three pulsars share one row)."""
    import copy

    from pint_tpu_torch.obs import fitquality
    from pint_tpu_torch.parallel import PTAFleet
    from pint_tpu_torch.parallel.pta import PTABatch
    from pint_tpu_torch.serve.policy import MIXED_FALLBACK_MARK

    models, toas = three_pulsars
    fleet = PTAFleet(copy.deepcopy(models), toas, device="cpu",
                     **(PLAN if layout == "packed" else {}))
    (batch,) = fleet.batches.values()
    assert bool(batch._pack) == (layout == "packed")
    if batch._pack:
        assert batch._pack["n_rows"] == 1
    mixed = batch.gls_fit(precision="mixed")
    f64 = batch.gls_fit(precision="f64")

    def rows(out, i):
        return [np.asarray(a)[i] for a in out]

    def same(a, b):
        return all(np.array_equal(u, v) for u, v in zip(a, b))

    # the test means something: each pulsar's mixed row is not its f64 row
    assert not any(same(rows(mixed, i), rows(f64, i)) for i in range(3))
    pull = PTABatch._pull_rows

    def failing_lane_1(self, handle):
        out = pull(self, handle)
        if handle["precision"] == "mixed":
            out[4][1] = np.nan
        return out

    noted = []
    monkeypatch.setattr(PTABatch, "_pull_rows", failing_lane_1)
    monkeypatch.setattr(fitquality.FITQ, "note_fallback", noted.append)
    fitquality.reset()
    fitquality.enable()
    try:
        with pytest.warns(UserWarning, match="refitting") as caught:
            got = batch.gls_fit(precision="mixed")
        rec = {n: fitquality.FITQ.get(n) for n in ("T0", "T1", "T2")}
    finally:
        fitquality.disable()
        fitquality.reset()
    for i in (0, 2):
        assert same(rows(got, i), rows(mixed, i)), i
    assert same(rows(got, 1), rows(f64, 1))
    # the serve engine's degradation marker stays in the warning
    assert any("for 1/3 pulsars" in str(w.message)
               and MIXED_FALLBACK_MARK in str(w.message) for w in caught)
    assert noted == [["T1"]]
    assert [rec[n]["fell_back"] for n in ("T0", "T1", "T2")] == [
        False, True, False]
    assert batch.metrics["refit_f64"] is True
    assert batch.metrics["fell_back"] == [1]
    assert np.isnan(batch.metrics["relres_max"])
    assert batch.metrics["precision"] == "mixed"
    assert list(batch.diverged) == []
