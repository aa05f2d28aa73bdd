"""The port's single-pulsar fitters (pint_tpu_torch/fitter.py) against
the JAX package's, on the CPU: every fitter class on the unmodified
NGC6440E example read through each package's get_model_and_toas, the
GLS fitters on a 3-pulsar ECORR + red-noise batch built as
tests/test_parallel.py::_noise_batch builds it, and the fitter surface
(noise realizations, summary, F-test, derived quantities,
auto_fitter, fault injection). The last test regenerates
``pint_tpu_torch/data/examples/NGC6440E_postfit.json`` from the JAX
package and requires it to equal the committed file; ``python
tests/test_torch_fitter.py`` rewrites it.

Tolerances (ERRORBUDGET.md tiers; measured gaps in brackets):
- fitted values: 1e-6 sigma, the batched-fit-vs-reference tier
  [5e-7 sigma on NGC6440E, 2e-8 on the noise batch: one-ulp phase
  differences];
- chi2: 1e-9 relative on NGC6440E [1e-10]; 1e-7 on the noise batch
  [1.3e-8], whose whitened residuals are ~100x smaller, so the same
  ~1e-13 s residual gap weighs more;
- uncertainties of one iterate (maxiter=1): 1e-10 relative, the f64
  covariance tier [1e-14];
- uncertainties at the default maxiter: 1e-5 relative [1.8e-6]. The
  best-iterate safeguard keeps the covariance of the step that gave
  the lowest chi2; at convergence the last two chi2 values differ by
  less than the packages' 1e-10-relative chi2 gap, so each package may
  keep a different iterate, whose covariances (design matrix at x0 vs
  x1) differ by ~2e-6. The 1e-10 tier at maxiter >= 2 is out of reach
  and logged in ROADMAP §3;
- PowellFitter: derivative-free, it stops on scipy's ftol (1e-4
  relative chi2) along a path that chi2 values differing by 1e-10
  decide. Held to its own stopping rule: each package's chi2 within
  1e-4 relative of the WLS optimum's, and each value within
  sqrt(1e-4 chi2) sigma (0.08 sigma here, what that chi2 excess
  allows) of the optimum [chi2 excess 1.6e-6 relative, values 0.0075
  sigma from the optimum and 6e-5 sigma apart]. The 1e-6-sigma tier is
  out of reach; ROADMAP §3;
- noise realizations: 1e-6 of the summed realization's peak [3e-8].
"""

import copy
import json
import warnings

import numpy as np
import pytest
import torch

from test_torch_ingest import NGC_PAR, NGC_TIM, ROOT

JAX_PAR = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.par"
JAX_TIM = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.tim"
POSTFIT = ROOT / "pint_tpu_torch" / "data" / "examples" / "NGC6440E_postfit.json"
# (fixture key, fitter class, fit_toas kwargs)
FITTERS = (("WLSFitter", "WLSFitter", {}),
           ("DownhillWLSFitter", "DownhillWLSFitter", {}),
           ("GLSFitter", "GLSFitter", {}),
           ("GLSFitter_mixed", "GLSFitter", {"precision": "mixed"}),
           ("DownhillGLSFitter", "DownhillGLSFitter", {}),
           ("PowellFitter", "PowellFitter", {}))
TOL_X = 1e-6  # sigma
TOL_UNC = 1e-5  # relative, safeguarded fits (see the module docstring)


def postfit_fixture():
    """The JAX package's fits of the unmodified NGC6440E example on the
    CPU, per fitter: chi2, fitted values and uncertainties (None where
    the fitter sets none). Its numpy host path (``native._LIB =
    False``), so the file does not depend on a C++ compiler."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pint_tpu
    import pint_tpu.fitter as jf
    import pint_tpu.native as jnative

    saved = jnative._LIB
    jnative._LIB = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m, t = pint_tpu.get_model_and_toas(str(JAX_PAR), str(JAX_TIM))
            out = {"source": "pint_tpu (the JAX package) on the CPU, "
                             "numpy host path: get_model_and_toas on "
                             "NGC6440E.par/.tim, then each fitter's "
                             "fit_toas(**kwargs); written by "
                             "tests/test_torch_fitter.py",
                   "fitters": {}}
            for key, cls, kw in FITTERS:
                f = getattr(jf, cls)(t, m)
                chi2 = f.fit_toas(**kw)
                out["fitters"][key] = {
                    "class": cls, "kwargs": kw, "chi2": float(chi2),
                    "values": {p: float(getattr(f.model, p).value)
                               for p in f.model.free_params},
                    "uncertainties": {p: getattr(f.model, p).uncertainty
                                      for p in f.model.free_params}}
    finally:
        jnative._LIB = saved
    return out


@pytest.fixture(scope="module")
def ngc():
    """(port model, port TOAs, JAX model, JAX TOAs): the unmodified
    example through each package's get_model_and_toas."""
    import pint_tpu
    import pint_tpu_torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m, t = pint_tpu_torch.get_model_and_toas(str(NGC_PAR), str(NGC_TIM))
        jm, jt = pint_tpu.get_model_and_toas(str(JAX_PAR), str(JAX_TIM))
    return m, t, jm, jt


def _fit_pair(ngc, cls, **kw):
    import pint_tpu.fitter as jf
    import pint_tpu_torch.fitter as tf

    m, t, jm, jt = ngc
    fj = getattr(jf, cls)(jt, jm)
    fj.fit_toas(**kw)
    ft = getattr(tf, cls)(t, m, device="cpu")
    ft.fit_toas(**kw)
    return fj, ft


def _dx_sigma(fj, ft):
    """max |x_port - x_jax| / sigma_jax over the free parameters."""
    return max(abs(getattr(ft.model, p).value - getattr(fj.model, p).value)
               / getattr(fj.model, p).uncertainty
               for p in fj.model.free_params)


@pytest.mark.parametrize("key,cls,kw", [f for f in FITTERS
                                        if f[1] != "PowellFitter"],
                         ids=[f[0] for f in FITTERS if f[1] != "PowellFitter"])
def test_fitters_match_jax_on_ngc6440e(ngc, key, cls, kw):
    """Each fitter on the unmodified example (SOLARN0 and
    CORRECT_TROPOSPHERE kept): values to 1e-6 sigma, chi2 to 1e-9,
    uncertainties to the safeguarded tier, the same free parameters
    and post-fit residuals to 1e-9 cycles."""
    fj, ft = _fit_pair(ngc, cls, **kw)
    assert {"SolarWindDispersion", "TroposphereDelay"} <= set(ft.model.components)
    assert ft.model.free_params == fj.model.free_params
    assert _dx_sigma(fj, ft) <= TOL_X
    cj = float(getattr(fj, "chi2_whitened", None) or fj.resids.chi2)
    ct = float(getattr(ft, "chi2_whitened", None) or ft.resids.chi2)
    assert abs(ct - cj) <= 1e-9 * cj
    assert abs(ft.resids.chi2 - float(fj.resids.chi2)) <= 1e-9 * cj
    for p in fj.model.free_params:
        uj, ut = getattr(fj.model, p).uncertainty, getattr(ft.model, p).uncertainty
        assert abs(ut / uj - 1) <= TOL_UNC, p
    assert np.abs(ft.resids.phase_resids
                  - np.asarray(fj.resids.phase_resids)).max() <= 1e-9
    assert ft.converged and ft.metrics["backend"] == "cpu"
    assert ft.metrics["device_bytes_in_use"] is None
    for top in ("START", "FINISH", "NTOA", "TRES", "CHI2", "CHI2R"):
        assert abs(getattr(ft.model, top).value
                   - getattr(fj.model, top).value) <= 1e-6 * max(
                       1.0, abs(getattr(fj.model, top).value)), top


@pytest.mark.parametrize("cls,kw", [("WLSFitter", {}), ("GLSFitter", {}),
                                    ("GLSFitter", {"precision": "mixed"})])
def test_one_iterate_covariance_matches_jax(ngc, cls, kw):
    """maxiter=1: both packages keep the covariance of the same step
    (the one evaluated at the start), held to the f64 covariance tier;
    mixed to the mixed tier, 1e-4 (f32 Gram summation order)."""
    fj, ft = _fit_pair(ngc, cls, maxiter=1, **kw)
    tol = 1e-4 if kw else 1e-10
    np.testing.assert_allclose(ft.parameter_covariance_matrix,
                               np.asarray(fj.parameter_covariance_matrix),
                               rtol=tol, atol=0)
    assert _dx_sigma(fj, ft) <= TOL_X


def test_powell_matches_jax_within_its_tolerance(ngc):
    """PowellFitter in both packages held to its own stopping rule
    against the JAX package's WLS optimum: chi2 within 1e-4 relative
    (scipy's ftol), each value within the sqrt(ftol chi2) sigma that
    chi2 excess allows (see the module docstring for why 1e-6 sigma
    between the packages is out of reach)."""
    import pint_tpu.fitter as jf

    fw = jf.WLSFitter(ngc[3], ngc[2])
    chi2_opt = float(fw.fit_toas())
    sigma = {p: getattr(fw.model, p).uncertainty for p in fw.model.free_params}
    fj, ft = _fit_pair(ngc, "PowellFitter")
    for f in (fj, ft):
        assert float(f.resids.chi2) - chi2_opt <= 1e-4 * chi2_opt
        assert max(abs(getattr(f.model, p).value - getattr(fw.model, p).value)
                   / sigma[p] for p in sigma) <= np.sqrt(1e-4 * chi2_opt)
    assert abs(ft.resids.chi2 - float(fj.resids.chi2)) <= 1e-4 * chi2_opt
    assert ft.metrics["n_evaluations"] > 0


def test_parfile_round_trip(ngc):
    """as_parfile() after a fit, read back by get_model, gives the
    same values (MJD epochs and angles to their written resolution, 11
    decimals of a day and 10 of a sexagesimal second, as in the JAX
    package), uncertainties (to the 5 printed digits) and
    components."""
    from pint_tpu_torch.fitter import DownhillWLSFitter
    from pint_tpu_torch.models import get_model

    f = DownhillWLSFitter(ngc[1], ngc[0], device="cpu")
    f.fit_toas()
    m2 = get_model(f.model.as_parfile())
    assert list(m2.components) == list(f.model.components)
    for p in f.model.params:
        a, b = getattr(f.model, p), getattr(m2, p)
        if a.value is None:
            assert b.value is None, p
        elif a.kind == "mjd":
            # both packages write epochs with 11 decimals of a day
            # (format_mjd): half the last digit is 4.32e-7 s
            assert a.day == b.day and abs(a.sec - b.sec) <= 4.32e-7, p
        elif a.kind == "angle":
            # written to 1e-10 sexagesimal seconds: one tick
            tick = 1e-10 / 3600 * np.pi / 180 * (
                15.0 if a.angle_unit == "hourangle" else 1.0)
            assert abs(a.value - b.value) <= tick, p
        else:
            assert a.value == b.value, p
        assert a.frozen == b.frozen, p
        if a.uncertainty is not None:
            assert b.uncertainty == pytest.approx(a.uncertainty, rel=1e-4)


def _noise_batch(n_psr=3, n_epochs=18, per_epoch=3, harmonics=(4, 6, 8),
                 seed=7):
    """tests/test_parallel.py::_noise_batch (EFAC/EQUAD/ECORR and ragged
    red noise, clustered epochs, GBT): (par texts, JAX models, JAX
    TOAs)."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    pars, models, toas_list = [], [], []
    for i in range(n_psr):
        par = (f"PSR NZ{i}\nRAJ 0{(2 * i) % 10}:30:00.0\nDECJ {8 + i}:00:00.0\n"
               f"F0 {310 + 4 * i}.25 1\nF1 -{2 + i}e-16 1\nPEPOCH 55500\n"
               f"DM {12 + i}.3 1\n"
               "EFAC -f L-wide 1.2\nEQUAD -f L-wide 0.5\n"
               "ECORR -f L-wide 0.9\n"
               f"RNAMP 1e-14\nRNIDX -3.2\nTNREDC {harmonics[i]}\n")
        m = get_model(par)
        ne = n_epochs + 2 * i
        epoch_days = np.linspace(55000, 56000, ne)
        mjds = np.concatenate(
            [d + np.arange(per_epoch) * 0.5 / 86400.0 for d in epoch_days])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t = make_fake_toas_fromMJDs(mjds, m, error_us=1.0,
                                        freq_mhz=np.full(len(mjds), 1400.0),
                                        obs="gbt", add_noise=True,
                                        seed=100 + i)
        for f in t.flags:
            f["f"] = "L-wide"
        pars.append(par)
        models.append(m)
        toas_list.append(t)
    return pars, models, toas_list


@pytest.fixture(scope="module")
def noise_batch():
    return _noise_batch()


@pytest.mark.parametrize("cls,kw", [("GLSFitter", {}),
                                    ("GLSFitter", {"precision": "mixed"}),
                                    ("DownhillGLSFitter", {})],
                         ids=["gls-f64", "gls-mixed", "downhill-gls"])
def test_gls_noise_batch_matches_jax(noise_batch, cls, kw):
    """GLS fits with ECORR's dense epoch columns and red noise, per
    pulsar: values, uncertainties, the marginalized chi2 and each
    component's noise realization against the JAX package's, and the
    realizations attached to the residuals (calc_whitened_resids)."""
    import pint_tpu.fitter as jf
    import pint_tpu_torch.fitter as tf
    from pint_tpu_torch.models import get_model
    from test_torch_pta import port_toas

    pars, models, toas_list = noise_batch
    for par, jm, jt in zip(pars, models, toas_list):
        fj = getattr(jf, cls)(jt, copy.deepcopy(jm))
        cj = fj.fit_toas(**kw)
        ft = getattr(tf, cls)(port_toas(jt), get_model(par), device="cpu")
        ct = ft.fit_toas(**kw)
        assert _dx_sigma(fj, ft) <= TOL_X
        assert abs(ct - cj) <= 1e-7 * abs(cj)
        for p in fj.model.free_params:
            uj, ut = (getattr(fj.model, p).uncertainty,
                      getattr(ft.model, p).uncertainty)
            assert abs(ut / uj - 1) <= TOL_UNC, p
        nj, nt = fj.get_noise_resids(), ft.get_noise_resids()
        assert list(nt) == list(nj) == ["EcorrNoise", "PLRedNoise"]
        scale = np.abs(sum(np.asarray(v) for v in nj.values())).max()
        for k in nj:
            assert np.abs(nt[k] - np.asarray(nj[k])).max() <= 1e-6 * scale
        assert ft.resids.noise_resids.keys() == nt.keys()
        wj = np.asarray(fj.resids.calc_whitened_resids())
        wt = ft.resids.calc_whitened_resids().numpy()
        assert np.abs(wt - wj).max() <= 1e-5 * np.abs(wj).max()


def test_summary_ftest_derived_match_jax(ngc):
    """get_summary (same lines, numbers to the printed digits),
    ftest_add_params (freeing PX: the same p-value to 1e-6 and chi2 to
    1e-9) and get_derived_params (1e-8 relative: the value tier
    propagated) after a WLS fit."""
    fj, ft = _fit_pair(ngc, "WLSFitter", maxiter=1)
    sj, st = fj.get_summary().splitlines(), ft.get_summary().splitlines()
    assert len(sj) == len(st)
    for a, b in zip(sj, st):
        wa, wb = a.split(), b.split()
        assert len(wa) == len(wb)
        for x, y in zip(wa, wb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y
            else:
                assert abs(fx - fy) <= 1e-6 * max(abs(fx), 1e-300)
    rj, rt = fj.ftest_add_params("PX"), ft.ftest_add_params("PX")
    assert rt["dof"] == rj["dof"]
    assert abs(rt["p_value"] - rj["p_value"]) <= 1e-6
    assert abs(rt["chi2"] - rj["chi2"]) <= 1e-9 * rj["chi2"]
    assert not rt["fitter"].model.PX.frozen
    dj, dt = fj.get_derived_params(), ft.get_derived_params()
    assert dj.keys() == dt.keys() >= {"P0", "P1", "AGE_yr", "BSURF_G",
                                      "EDOT_erg_s"}
    for k in dj:
        for a, b in zip(dj[k], dt[k]):
            if a is None:
                assert b is None
            else:
                # the 1e-6-sigma value tier, propagated: F1 is known to
                # 1.4e-3 relative, so 1e-6 sigma is ~1.4e-9 of it
                assert abs(b - a) <= 1e-8 * abs(a), k
    assert ft.ftest(rt["chi2"], rt["dof"]) == pytest.approx(
        fj.ftest(rj["chi2"], rj["dof"]), abs=1e-6)
    with pytest.raises(ValueError, match="already free"):
        ft.ftest_add_params("F0")
    with pytest.raises(KeyError):
        ft.ftest_add_params("START")


def test_derived_quantities_match_jax():
    """derived_quantities, host math in both packages: every function
    on the same floats to 1e-14 relative, and on torch tensors."""
    from pint_tpu import derived_quantities as jdq
    from pint_tpu_torch import derived_quantities as tdq

    cases = {
        "p_to_f": (0.0016, 1e-20, 1e-31), "pferrs": (0.0016, 1e-14, 1e-20, 1e-24),
        "mass_function": (1.53, 1.2), "mass_funct2": (1.4, 0.3, 0.9),
        "companion_mass": (1.53, 1.2, 0.866), "pulsar_mass": (1.53, 1.2, 0.3, 0.95),
        "pulsar_age": (61.48, -1.18e-15), "pulsar_edot": (61.48, -1.18e-15),
        "pulsar_B": (61.48, -1.18e-15), "pulsar_B_lightcyl": (61.48, -1.18e-15),
        "omdot": (1.35, 1.25, 0.1, 0.09), "gamma": (1.35, 1.25, 0.1, 0.09),
        "pbdot": (1.35, 1.25, 0.1, 0.09),
        "sini_from_omdot": (1.35, 1.25, 0.1, 0.09, 1.4),
        "shklovskii_factor": (20.0, 1.2), "dispersion_slope": (223.9,),
        "pmtot": (3.0, 4.0)}
    for name, args in cases.items():
        a = np.atleast_1d(getattr(tdq, name)(*args))
        b = np.atleast_1d(getattr(jdq, name)(*args))
        np.testing.assert_allclose(a, b, rtol=1e-14, err_msg=name)
    t = tdq.pulsar_B(torch.tensor(61.48, dtype=torch.float64),
                     torch.tensor(-1.18e-15, dtype=torch.float64))
    assert isinstance(t, torch.Tensor)
    assert float(t) == pytest.approx(float(jdq.pulsar_B(61.48, -1.18e-15)),
                                     rel=1e-14)
    assert np.isnan(tdq.pulsar_B(61.48, 1e-15))  # spin-up: nan, not complex


def test_auto_fitter_choice(ngc, noise_batch):
    """auto_fitter picks DownhillWLS without correlated noise and
    DownhillGLS with it, and WidebandDownhill for TOAs with -pp_dm
    flags, as the JAX package does."""
    from pint_tpu.fitter import auto_fitter as jauto
    from pint_tpu_torch.fitter import auto_fitter
    from pint_tpu_torch.models import get_model
    from test_torch_pta import port_toas

    m, t, jm, jt = ngc
    assert type(auto_fitter(t, m, device="cpu")).__name__ == \
        type(jauto(jt, jm)).__name__ == "DownhillWLSFitter"
    pars, jms, jts = noise_batch
    pt = port_toas(jts[0])
    assert type(auto_fitter(pt, get_model(pars[0]), device="cpu")).__name__ \
        == type(jauto(jts[0], jms[0])).__name__ == "DownhillGLSFitter"
    wb = pt.mask(np.ones(len(pt), bool))
    jwb = copy.deepcopy(jts[0])
    for f in wb.flags + jwb.flags:
        f["pp_dm"] = "12.3"
    assert type(auto_fitter(wb, get_model(pars[0]), device="cpu")).__name__ \
        == type(jauto(jwb, jms[0])).__name__ == "WidebandDownhillFitter"


def test_fitter_guards(ngc, noise_batch):
    """The injected solver_diverge fault raises ConvergenceFailure; WLS
    refuses correlated noise; fit-quality probes and Fitter.plot name
    the ROADMAP items they wait for; precision is validated."""
    from pint_tpu_torch import fitter as tf
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.resilience import faultinject
    from test_torch_pta import port_toas

    m, t, _, _ = ngc
    for cls in (tf.WLSFitter, tf.GLSFitter):
        f = cls(t, m, device="cpu")
        with faultinject.inject(faultinject.FaultPoint("solver_diverge",
                                                       count=1)):
            with pytest.raises(tf.ConvergenceFailure, match="injected"):
                f.fit_toas()
        assert not f.converged
    pars, _, jts = noise_batch
    with pytest.raises(tf.CorrelatedErrors, match="EcorrNoise"):
        tf.WLSFitter(port_toas(jts[0]), get_model(pars[0]),
                     device="cpu").fit_toas()
    f = tf.GLSFitter(t, m, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="item 5, serving and observability"):
        f.fit_toas(fit_quality=True)
    with pytest.raises(ValueError, match="precision"):
        f.fit_toas(precision="f32")
    with pytest.raises(NotImplementedError, match="item 3, applications"):
        f.plot()
    with pytest.raises(ValueError, match="fit_toas"):
        f.get_noise_resids()
    assert tf.degraded_f64() is False


def test_downhill_maxiter_reached(ngc):
    """DownhillWLSFitter with raise_maxiter and one iteration from the
    prefit model: MaxiterReached carries the best chi2, and the model
    keeps the improved state."""
    from pint_tpu_torch.fitter import DownhillWLSFitter, MaxiterReached

    f = DownhillWLSFitter(ngc[1], ngc[0], device="cpu")
    prefit = f.resids.chi2
    with pytest.raises(MaxiterReached) as e:
        f.fit_toas(maxiter=1, raise_maxiter=True)
    assert e.value.chi2 < prefit
    assert f.model.F0.value != ngc[0].F0.value


def test_fitters_need_a_card_by_default(monkeypatch, ngc):
    """The fitters run on the card unless the caller asks for the CPU."""
    from pint_tpu_torch.fitter import WLSFitter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WLSFitter(ngc[1], ngc[0])


def test_postfit_fixture_regenerates():
    """NGC6440E_postfit.json is what the JAX package computes today."""
    assert postfit_fixture() == json.loads(POSTFIT.read_text())


@pytest.mark.cuda
def test_fitters_on_card_match_fixture():
    """On the card: the README quick start (get_model_and_toas ->
    DownhillWLSFitter) and GLSFitter in f64 and mixed, held to the
    committed JAX fixture at the CPU tiers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import pint_tpu_torch
    from pint_tpu_torch import fitter as tf

    fx = json.loads(POSTFIT.read_text())["fitters"]
    m, t = pint_tpu_torch.get_model_and_toas(str(NGC_PAR), str(NGC_TIM))
    for key in ("DownhillWLSFitter", "GLSFitter", "GLSFitter_mixed"):
        ref = fx[key]
        f = getattr(tf, ref["class"])(t, m)
        chi2 = f.fit_toas(**ref["kwargs"])
        assert abs(chi2 - ref["chi2"]) <= 1e-9 * ref["chi2"]
        for p, v in ref["values"].items():
            u = ref["uncertainties"][p]
            assert abs(getattr(f.model, p).value - v) <= TOL_X * u
            assert abs(getattr(f.model, p).uncertainty / u - 1) <= TOL_UNC


if __name__ == "__main__":
    POSTFIT.write_text(json.dumps(postfit_fixture(), indent=1) + "\n")
    print(f"wrote {POSTFIT}")
