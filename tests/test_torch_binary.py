"""The port's binary components (pint_tpu_torch/models/binary) against
the JAX package's, on the same TOAs: ELL1 (PB and FB orbits), ELL1H
(STIGMA and H4), ELL1k, BT, BTX, BT_piecewise, DD (also at e = 0.9),
DDS, DDH, DDGR, DDK and a BINARY T2 container, plus kepler_solve,
orbital_phase, get_barycentric_toas and delay_breakdown; and a small
fleet of chip_smoke.py's isolated, ELL1, ELL1H and DD zoo pulsars
through the packed mixed fit (the plain kernels on the CPU) against
the JAX package's ``PTAFleet`` (1e-6 sigma, tests/test_torch_pta.py's
tier).

TOAs come from the JAX package's fake-TOA maker at GBT (random epochs
from a numpy seed, 4 TOAs per epoch at 800/1400 MHz) and reach the port
through ``test_torch_models.port_toas``, which copies the barycentred
columns. Every orbit parameter a case names is free, so each has its
design column.

Tolerances (the tiers of tests/test_torch_models.py): delays 1e-12 s
per component; the total phase 1e-9 cycles with equal integer parts;
design-matrix columns 1e-9 of each column's max |entry|; residuals
1e-12 s; kepler_solve 1e-12 rad up to e = 0.9 (both packages run the
same 8 Newton steps; sin/cos differ by an ulp between XLA and torch,
which the steps amplify by at most 1/(1 - e) = 10).
"""

import warnings

import numpy as np
import pytest
import torch

from test_torch_models import port_toas

BASE = ("PSR TESTB\nRAJ 10:22:57.9\nDECJ 10:01:52.8\nF0 100.5 1\n"
        "F1 -5e-16 1\nPEPOCH 55000\nDM 20.0\n")
FB_ELL1 = 1.0 / (1.53 * 86400.0)
FB_BTX = 1.0 / (10.5 * 86400.0)
CASES = {
    "ell1": "BINARY ELL1\nPB 1.53 1\nA1 1.898 1\nTASC 55001.0 1\n"
            "EPS1 2e-8 1\nEPS2 -8e-8 1\nM2 0.21 1\nSINI 0.998 1\n"
            "PBDOT 1e-12 1\nA1DOT 1e-14 1\nEPS1DOT 1e-16 1\nEPS2DOT -1e-16 1\n",
    "ell1_fb": f"BINARY ELL1\nFB0 {FB_ELL1:.15e} 1\nFB1 -1e-20 1\n"
               "A1 1.898 1\nTASC 55001.0 1\nEPS1 2e-8 1\nEPS2 -8e-8 1\n",
    "ell1h_stigma": "BINARY ELL1H\nPB 12.32717 1\nA1 9.230780 1\n"
                    "TASC 53601.0 1\nEPS1 -2.15e-5 1\nEPS2 -3.1e-6 1\n"
                    "H3 2.7e-7 1\nSTIGMA 0.72 1\n",
    "ell1h_h4": "BINARY ELL1H\nPB 12.32717 1\nA1 9.230780 1\nTASC 53601.0 1\n"
                "EPS1 -2.15e-5 1\nEPS2 -3.1e-6 1\nH3 2.7e-7 1\nH4 1.9e-7 1\n",
    "ell1k": "BINARY ELL1K\nPB 1.5 1\nA1 2.0 1\nTASC 55001.0 1\n"
             "EPS1 1e-5 1\nEPS2 2e-5 1\nOMDOT 1.0 1\nLNEDOT 1e-12 1\n",
    "bt": "BINARY BT\nPB 10.5 1\nA1 12.3 1\nT0 55005.5 1\nECC 0.21 1\n"
          "OM 75.3 1\nGAMMA 0.002 1\nOMDOT 0.01 1\nEDOT 1e-15 1\n",
    "btx": f"BINARY BTX\nFB0 {FB_BTX:.15e} 1\nFB1 1e-21 1\nA1 12.3 1\n"
           "T0 55005.5 1\nECC 0.21 1\nOM 75.3 1\n",
    "bt_piecewise": "BINARY BT_piecewise\nPB 8.0 1\nA1 12.0 1\nT0 55300 1\n"
                    "ECC 0.1 1\nOM 45.0 1\nT0X_0000 55300.001 1\n"
                    "A1X_0000 12.0001 1\nXR1_0000 54000\nXR2_0000 55000\n"
                    "A1X_0001 11.9999 1\nXR1_0001 55500\nXR2_0001 56500\n",
    "dd": "BINARY DD\nPB 0.40 1\nA1 2.34 1\nT0 55005.5 1\nECC 0.17 1\n"
          "OM 120.0 1\nOMDOT 4.22 1\nGAMMA 0.004 1\nM2 1.3 1\nSINI 0.95 1\n"
          "PBDOT -1e-12 1\nDR 1e-6 1\nDTH 2e-6 1\nA0 1e-7 1\nB0 2e-7 1\n"
          "A1DOT 1e-14 1\nEDOT 1e-16 1\n",
    "dd_e09": "BINARY DD\nPB 0.33 1\nA1 2.34 1\nT0 55005.0 1\nECC 0.9 1\n"
              "OM 200.0 1\nM2 0.5 1\nSINI 0.8 1\n",
    "dds": "BINARY DDS\nPB 0.4 1\nA1 2.34 1\nT0 55005.5 1\nECC 0.01 1\n"
           "OM 120.0 1\nM2 1.3 1\nSHAPMAX 3.0 1\n",
    "ddh": "BINARY DDH\nPB 8.0 1\nA1 12.0 1\nT0 55300 1\nECC 0.12 1\n"
           "OM 45.0 1\nH3 1e-6 1\nSTIGMA 0.6 1\n",
    "ddgr": "BINARY DDGR\nPB 0.323 1\nA1 2.34 1\nT0 55005.0 1\nECC 0.617 1\n"
            "OM 226.0 1\nMTOT 2.83 1\nM2 1.39 1\nXOMDOT 0.001 1\n",
    "ddk": "PMRA 10.0 1\nPMDEC -5.0 1\nPX 1.2 1\nBINARY DDK\nPB 5.74 1\n"
           "A1 3.36 1\nT0 55300 1\nECC 2e-5 1\nOM 1.35 1\nKIN 42.0 1\n"
           "KOM 207.0 1\nM2 0.2 1\n",
    "t2_ell1h": "BINARY T2\nPB 10.0 1\nA1 5.0 1\nTASC 55000 1\n"
                "EPS1 1e-5 1\nEPS2 1e-5 1\nH3 1e-7 1\nSTIG 0.5\n",
}
TOL_DELAY_S = 1e-12
TOL_PHASE = 1e-9
TOL_COL = 1e-9
TOL_KEPLER = 1e-12


_TOAS = {}


def jax_toas(n_epochs, seed):
    """The JAX package's fake TOAs at GBT (made once per (n_epochs,
    seed) with the isolated BASE model and shared by the cases: the
    epochs, not the model, are the input)."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    if (n_epochs, seed) not in _TOAS:
        rng = np.random.default_rng(seed)
        days = np.sort(rng.uniform(54000, 57000, n_epochs))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jt = make_fake_toas_fromMJDs(mjds, jax_model(BASE), error_us=1.0,
                                         freq_mhz=freqs, obs="gbt",
                                         iterations=0)
        for f in jt.flags:
            f["f"] = "L-wide"
        _TOAS[n_epochs, seed] = jt
    return _TOAS[n_epochs, seed]


def jax_pair(par, n_epochs=30, seed=0, flagger=None, **model_kw):
    """(JAX model, its PreparedTiming, port model, its PreparedTiming on
    the CPU) on the same TOAs."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu_torch.models import get_model

    jt = jax_toas(n_epochs, seed)
    if flagger is not None:
        flagger(jt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jax_model(par, **model_kw)
        tm = get_model(par, **model_kw)
        tp = tm.prepare(port_toas(jt), device="cpu")
        jp = jm.prepare(jt)
    return jm, jp, tm, tp


def jax_phase_and_design(jp):
    """The JAX package's PreparedTiming.phase_frac_and_int and
    designmatrix (numpy), from one jit of the phase and its jacfwd (one
    compile instead of two: the same expressions, so the same values to
    the tiers below)."""
    import jax

    from pint_tpu.models.timing_model import _overlay_params, _phase_impl

    free_map = tuple(jp.free_param_map())

    def phase(x):
        return _phase_impl(jp.model, _overlay_params(x, jp.params0, free_map),
                           jp.batch, jp.prep)

    frac, M = jax.jit(lambda x: (phase(x), jax.jacfwd(phase)(x)))(
        jp.vector_from_params())
    frac, M = np.asarray(frac), np.asarray(M)
    n = np.floor(frac + 0.5)
    labels = [name for name, _, _ in free_map]
    if "PHOFF" not in labels:
        M = np.concatenate([np.ones((M.shape[0], 1)), M], axis=1)
        labels = ["Offset"] + labels
    return frac - n, np.asarray(jp.prep["phi_ref_int"]) + n, M, labels


def compare_prepared(jm, jp, tm, tp):
    """The measured gaps of one case: {check: (gap, tier)}."""
    out = {}
    assert list(tm.components) == list(jm.components)
    assert tm.free_params == jm.free_params
    dj = np.zeros(jp.batch.n_toas)
    dt = torch.zeros(tp.batch.n_toas, dtype=torch.float64)
    worst = 0.0
    for cj, ct in zip(jm.delay_components(), tm.delay_components()):
        a = np.asarray(cj.delay(jp.params0, jp.batch, jp.prep, dj))
        b = ct.delay(tp.params0, tp.batch, tp.prep, dt).numpy()
        worst = max(worst, float(np.abs(a - b).max()))
        dj, dt = dj + a, dt + torch.as_tensor(b)
    out["delay per component [s]"] = (worst, TOL_DELAY_S)
    fj, ij, Mj, lj = jax_phase_and_design(jp)
    ft, it = tp.phase_frac_and_int()
    out["phase [cycles]"] = (float(np.abs(fj - ft.numpy()).max()), TOL_PHASE)
    out["phase integer parts differ"] = (float(np.abs(ij - it.numpy()).max()),
                                         0.0)
    Mt, lt = tp.designmatrix()
    assert lt == lj
    scale = np.maximum(np.abs(Mj).max(0), 1e-300)
    out["design columns [of max|col|]"] = (
        float((np.abs(Mt.numpy() - Mj).max(0) / scale).max()), TOL_COL)
    # the JAX package's residual_vector_fn, from its phase and sigma
    rj = fj - np.floor(fj + 0.5)
    w = 1.0 / np.square(np.asarray(jp.scaled_sigma_us()))
    rj = (rj - np.sum(rj * w) / np.sum(w)) / float(jp.params0["F"][0])
    rt = tp.residual_vector_fn()(tp.vector_from_params()).numpy()
    out["residuals [s]"] = (float(np.abs(rt - rj).max()), TOL_DELAY_S)
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jm, jp, tm, tp = jax_pair(BASE + CASES[request.param])
    return request.param, compare_prepared(jm, jp, tm, tp), (jm, jp, tm, tp)


@pytest.mark.parametrize("check", ["delay per component [s]",
                                   "phase [cycles]",
                                   "phase integer parts differ",
                                   "design columns [of max|col|]",
                                   "residuals [s]"])
def test_binary_matches_jax(case, check):
    name, gaps, _ = case
    gap, tier = gaps[check]
    assert gap <= tier, f"{name}: {check} {gap:.3e} > {tier:.0e}"


def test_binary_pack_matches_jax(case):
    """Every numeric prep leaf of the JAX package's pack is the port's,
    bitwise (the host longdouble orbit count included)."""
    _, _, (jm, jp, tm, tp) = case
    for k, v in jp.prep.items():
        a = np.asarray(v)
        if a.dtype.kind not in "biuf" or a.dtype.itemsize > 8:
            continue
        b = tp.prep[k]
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=k)


def check_round_trip(tm, tp):
    """as_parfile -> get_model gives the same components, parameter
    values and fit flags, and the same phase on the same TOAs."""
    from pint_tpu_torch.models import get_model

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        back = get_model(tm.as_parfile())
    assert list(back.components) == list(tm.components)
    assert back.free_params == tm.free_params
    for p in tm.params:
        a, b = getattr(tm, p).value, getattr(back, p).value
        assert a == b, (p, a, b)
    tq = back.prepare(tp.toas, device="cpu")
    np.testing.assert_array_equal(tq.phase_frac_and_int()[0].numpy(),
                                  tp.phase_frac_and_int()[0].numpy())


def test_binary_parfile_round_trip(case):
    check_round_trip(*case[2][2:])


@pytest.mark.parametrize("e", [0.0, 0.1, 0.3, 0.7, 0.9])
def test_kepler_solve_matches_jax(e):
    import jax.numpy as jnp

    from pint_tpu.models.binary.base import kepler_solve as jkepler
    from pint_tpu_torch.models.binary.base import kepler_solve

    M = np.random.default_rng(1).uniform(-np.pi, np.pi, 4001)
    E = kepler_solve(torch.as_tensor(M), e).numpy()
    Ej = np.asarray(jkepler(jnp.asarray(M), e))
    assert np.abs(E - Ej).max() <= TOL_KEPLER
    # and it solves Kepler's equation
    assert np.abs(E - e * np.sin(E) - M).max() <= 1e-12


@pytest.mark.parametrize("name", ["ell1", "dd", "btx"])
def test_orbital_phase_and_barycentric_toas_match_jax(name):
    """TimingModel.orbital_phase (cycles and radians),
    get_barycentric_toas (default cutoff and by name) and
    delay_breakdown against the JAX package's."""
    jm, jp, tm, tp = jax_pair(BASE + CASES[name], n_epochs=12, seed=2)
    t, jt = tp.toas, jp.toas
    dphi = tm.orbital_phase(t, device="cpu") - jm.orbital_phase(jt)
    assert np.abs((dphi + 0.5) % 1.0 - 0.5).max() <= 1e-12
    np.testing.assert_allclose(tm.orbital_phase(t, radians=True, device="cpu"),
                               jm.orbital_phase(jt, radians=True), atol=1e-10)
    bname = next(c for c in tm.components if c.startswith("Binary"))
    for kw in ({}, {"cutoff_component": bname},
               {"cutoff_component": "DispersionDM"}):
        np.testing.assert_allclose(
            tm.get_barycentric_toas(t, device="cpu", **kw),
            jm.get_barycentric_toas(jt, **kw), rtol=0, atol=1e-16)
    with pytest.raises(KeyError):
        tm.get_barycentric_toas(t, cutoff_component="Spindown", device="cpu")
    bj, bt = jm.delay_breakdown(jt), tm.delay_breakdown(t, device="cpu")
    assert list(bt) == list(bj)
    for k in bj:
        assert np.abs(bt[k] - bj[k]).max() <= TOL_DELAY_S, k


def test_orbital_phase_needs_a_binary():
    from pint_tpu_torch.models import get_model

    jm, jp, tm, tp = jax_pair(BASE + CASES["ell1"], n_epochs=4)
    with pytest.raises(AttributeError):
        get_model(BASE).orbital_phase(tp.toas, device="cpu")


def test_choose_t2_model_matches_jax():
    from pint_tpu.models.binary import choose_t2_model as jchoose
    from pint_tpu_torch.models.binary import choose_t2_model

    for keys in ({"KIN"}, {"KOM", "EPS1"}, {"EPS1"}, {"EPS2", "H4"},
                 {"H3"}, {"STIG"}, {"SHAPMAX"}, {"M2"}, {"SINI", "ECC"},
                 {"PB", "A1"}):
        assert choose_t2_model(keys) == jchoose(keys)


def test_binary_validation_matches_jax():
    """Missing required parameters and bad windows raise in both
    packages with the same exception type."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu_torch.models import get_model

    bad = ["BINARY ELL1\nPB 1.5\nEPS1 0\nEPS2 0\n",  # no A1
           "BINARY DD\nA1 2.0\nT0 55000\n",  # no PB
           "BINARY ELL1\nPB 1.5\nA1 2.0\n",  # no TASC
           "BINARY DDGR\nPB 1\nA1 2\nT0 55000\nM2 1\n",  # no MTOT
           "BINARY DDH\nPB 1\nA1 2\nT0 55000\nH3 1e-7\n",  # no STIGMA/H4
           "BINARY BT_piecewise\nPB 1\nA1 2\nT0 55000\nA1X_0001 2\n"
           "XR1_0001 55100\nXR2_0001 55000\n",  # empty window
           "BINARY XYZ\nPB 1\nA1 2\nT0 55000\n"]
    for extra in bad:
        with pytest.raises(Exception) as ej:
            jax_model(BASE + extra)
        with pytest.raises(Exception) as et:
            get_model(BASE + extra)
        assert type(et.value).__name__ == type(ej.value).__name__, extra


# ---- a small mixed-structure fleet ----

def zoo_fleet_inputs(n_per=2, n_epochs=150):
    """(pars, JAX models, JAX TOAs): chip_smoke.py's zoo fleet (one
    isolated, ELL1, ELL1H and DD structure, each with 17 DMX windows,
    FD1/FD2 and a receiver JUMP) at n_per pulsars a structure,
    zero-residual TOAs plus white noise on the zoo frequencies; pulsars
    i and i + 4 share a packed row."""
    import chip_smoke
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(5)
    pars, jms, jts = [], [], []
    for i in range(4 * n_per):
        p = chip_smoke.zoo_par_text(i)
        days = np.sort(rng.uniform(54000, 57000, n_epochs + i))
        mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
        freqs = chip_smoke.zoo_freqs(len(mjds))
        jm = jax_model(p)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jt = make_fake_toas_fromMJDs(mjds, jm, error_us=1.0,
                                         freq_mhz=freqs, obs="gbt",
                                         add_noise=True, seed=i,
                                         iterations=2)
        for f, nu in zip(jt.flags, freqs):
            f.update(chip_smoke.zoo_flags(nu))
        pars.append(p)
        jms.append(jm)
        jts.append(jt)
    return pars, jms, jts


PLAN = dict(toa_bucket="plan", plan_quantum=128, plan_min_width=2048,
            plan_max_pack=4, plan_compile_budget=2)


@pytest.fixture(scope="module")
def zoo_fleets():
    from pint_tpu.parallel import PTAFleet as JaxFleet
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTAFleet

    pars, jms, jts = zoo_fleet_inputs()
    jf = JaxFleet(jms, jts, **PLAN)
    tf = PTAFleet([get_model(p) for p in pars], [port_toas(t) for t in jts],
                  device="cpu", **PLAN)
    return jf, tf


def test_zoo_fleet_layout_matches_jax(zoo_fleets):
    jf, tf = zoo_fleets
    assert list(tf.group_indices.values()) == list(jf.group_indices.values())
    assert len({k[0] for k in tf.group_indices}) == 4  # one per structure
    assert all(b._pack for b in tf.batches.values())


def test_zoo_fleet_fit_matches_jax(zoo_fleets):
    """The packed mixed fit (the plain f32 kernels on the CPU) against
    the JAX package's."""
    jf, tf = zoo_fleets
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        xj, cj, covj = jf.fit(method="gls", maxiter=2, precision="mixed")
    xt, ct, covt = tf.fit(method="gls", maxiter=2, precision="mixed")
    for a, b, c in zip(xt, xj, covj):
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))
                      / np.sqrt(np.diag(c))) <= 1e-6
    # zero-residual TOAs with 1 us noise: the noise-batch chi2 tier of
    # tests/test_torch_fitter.py (the ~1e-13 s one-ulp residual gap
    # weighs against 1 us errors) [measured 4.2e-9]
    np.testing.assert_allclose(ct, cj, rtol=1e-7)
    assert not any(m["refit_f64"] for m in tf.fit_metrics.values())
    assert max(m["relres_max"] for m in tf.fit_metrics.values()) <= 1e-8


def test_zoo_fleet_mixed_matches_f64(zoo_fleets):
    """The packed mixed fit against the port's own f64 fit on the zoo
    design (FD1/FD2, 17 DMX windows and a receiver JUMP over three
    sub-bands of two receivers; kept condition number ~5e4): the
    packed segments' five refinement steps reach the f64 floor where
    the JAX package's two stop early (two: relres 1.5e-9, 2.4e-7
    sigma; three: 7.5e-12, 4.4e-8) [measured: relres 2.6e-14, 1.2e-9
    sigma]."""
    _, tf = zoo_fleets
    xm, _, covm = tf.fit(method="gls", maxiter=2, precision="mixed")
    assert max(m["relres_max"] for m in tf.fit_metrics.values()) <= 1e-12
    x64, _, _ = tf.fit(method="gls", maxiter=2, precision="f64")
    for a, b, c in zip(xm, x64, covm):
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))
                      / np.sqrt(np.diag(c))) <= 1e-8
