"""The port's wideband (time + DM) timing against the JAX package's, on
the CPU: ScaleToaError.scale_dm_sigma, residuals.wideband_dm_model (DMX,
DMWaveX, SWX, SWM, DMJUMP), WidebandDMResiduals, the combined design
matrix, the three wideband fitters on the wideband pack
(``pint_tpu_torch/data/examples/wb_sim.*``) against the JAX package's
fits in ``WB_postfit.json``, the refusals, auto_fitter's choice and the
wideband fake TOAs. ``make_pack`` and ``postfit_fixture`` rebuild the
pack and the fixture through the JAX package
(tests/test_torch_scripts.py requires them to equal the committed
files); ``python tests/test_torch_wideband.py`` rewrites them.

The pack (``PACK_PAR``): a J1909-like ELL1 pulsar with DM free, three
free DMX windows that leave DM pinned by the TOAs outside them,
EFAC/EQUAD per GBT receiver, ECORR over the two TOAs of an epoch, red
noise (10 harmonics), DMEFAC/DMEQUAD and a free DMJUMP on Rcvr_800; 150
random epochs over MJD 55000-56460, each with one wideband TOA per
receiver (820 MHz, 1 us; 1500 MHz, 0.6 us; 0.5 s apart). The JAX
package makes the epochs zero-residual (``make_fake_toas_fromMJDs``),
the receivers' ``-fe`` flags are set, and
``make_fake_toas_fromtim(..., wideband=True)`` draws the white,
correlated and DM noise (seed 11) with the masks in place; both steps
on its numpy host path, so the files depend on no compiler.

Tolerances (ERRORBUDGET.md tiers; measured gaps in brackets):
- scale_dm_sigma 1e-15 relative [0]; the model DM 1e-12 relative
  [bitwise on these inputs]; DM residuals, errors, valid: 1e-12
  relative [bitwise];
- the combined design matrix 1e-12 of each column's max [~1e-16];
- fitted values 1e-6 sigma [2.1e-7]; LM at its default maxiter by its
  own stopping rule (below);
- uncertainties one iterate at a time (``maxiter=1``) 1e-10 relative,
  the f64 covariance tier [4e-15]; mixed 1e-4, the mixed tier [6.5e-7];
  at the default maxiter 1e-10 for WidebandTOAFitter and
  WidebandDownhillFitter (their covariance is the last solve's [3e-15])
  and 1e-5 for WidebandLMFitter, the safeguarded tier of
  tests/test_torch_fitter.py [1.4e-10]: LM's stopping rule picks the
  iterate (below);
- chi2 1e-7 relative [7.7e-9], the noise-batch tier of
  tests/test_torch_fitter.py. The 1e-9 tier is out of reach (ROADMAP
  §3): the DM half of chi2 is bitwise, the time half differs by
  one-ulp phase differences (8.6e-14 s on residuals of ~1 us with
  0.6-1 us errors: 3.5e-9 of the prefit chi2);
- WidebandLMFitter at its default maxiter: after the minimum every
  damped step is rejected or accepted on chi2 differences of ~1e-9
  relative, below the packages' chi2 gap, so each package stops at
  another iterate [2.3e-6 sigma apart, chi2 1.5e-9 apart]. Held to its
  stopping rule, as PowellFitter is in tests/test_torch_fitter.py:
  values within sqrt(tol chi2) sigma (7.1e-4 here) of the JAX fit, chi2
  at the 1e-7 tier. At maxiter 1 and 2 it meets 1e-6 sigma [5.9e-8].
"""

import copy
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "pint_tpu_torch" / "data" / "examples"
WB_PAR = EXAMPLES / "wb_sim.par"
WB_TIM = EXAMPLES / "wb_sim.tim"
WB_POSTFIT = EXAMPLES / "WB_postfit.json"
PACK_SEED, PACK_EPOCHS, PACK_NOISE_SEED = 2026, 150, 11
PACK_PAR = """PSR J1909-WBSIM
RAJ 19:09:47.4346749
DECJ -37:44:14.46674
F0 339.31568732 1
F1 -1.6148e-15 1
PEPOCH 55700
DM 10.3912 1
DMX 6.5
DMX_0001 0.0 1
DMXR1_0001 55300.0
DMXR2_0001 55500.0
DMX_0002 0.0 1
DMXR1_0002 55700.0
DMXR2_0002 55900.0
DMX_0003 0.0 1
DMXR1_0003 56100.0
DMXR2_0003 56300.0
BINARY ELL1
PB 1.533449 1
A1 1.89799 1
TASC 55001.0 1
EPS1 2e-8 1
EPS2 -8e-8 1
M2 0.21
SINI 0.998
EFAC -fe Rcvr_800 1.1
EFAC -fe Rcvr1_2 1.05
EQUAD -fe Rcvr_800 0.3
ECORR -f wb 0.5
RNAMP 1e-14
RNIDX -3.1
TNREDC 10
DMEFAC -fe Rcvr_800 1.2
DMEQUAD -fe Rcvr1_2 2e-5
DMJUMP -fe Rcvr_800 2e-4 1
"""
# (fixture key, fitter class, fit_toas kwargs)
FITTERS = (("WidebandTOAFitter", "WidebandTOAFitter", {}),
           ("WidebandTOAFitter_mixed", "WidebandTOAFitter",
            {"precision": "mixed"}),
           ("WidebandDownhillFitter", "WidebandDownhillFitter", {}),
           ("WidebandLMFitter", "WidebandLMFitter", {}))
TOL_X = 1e-6  # sigma
TOL_CHI2 = 1e-7  # relative (see the module docstring)
TOL_COV = 1e-10  # relative, f64 covariance
TOL_MIXED_UNC = 1e-4  # relative, the mixed tier
TOL_SAFEGUARD_UNC = 1e-5  # relative, LM at its default maxiter
LM_TOL = 1e-9  # WidebandLMFitter.fit_toas's default tol


def _receiver(freq_mhz):
    return "Rcvr_800" if freq_mhz < 1000.0 else "Rcvr1_2"


def make_pack(out_dir):
    """Write wb_sim.par and wb_sim.tim into ``out_dir`` with the JAX
    package (numpy host path); returns their paths."""
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pint_tpu.native as jnative
    from pint_tpu.models import get_model
    from pint_tpu.simulation import (make_fake_toas_fromMJDs,
                                     make_fake_toas_fromtim)

    out_dir = Path(out_dir)
    rng = np.random.default_rng(PACK_SEED)
    days = np.sort(rng.uniform(55000, 56460, PACK_EPOCHS))
    mjds = (days[:, None] + np.array([0.0, 0.5 / 86400.0])).reshape(-1)
    freqs = np.tile([820.0, 1500.0], PACK_EPOCHS)
    errs = np.tile([1.0, 0.6], PACK_EPOCHS)
    saved = jnative._LIB
    jnative._LIB = False
    try:
        with warnings.catch_warnings(), \
                tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("ignore")
            m = get_model(PACK_PAR)
            t = make_fake_toas_fromMJDs(mjds, m, error_us=errs,
                                        freq_mhz=freqs, obs="gbt",
                                        flags={"f": "wb"})
            for f, nu in zip(t.flags, freqs):
                f["fe"] = _receiver(nu)
            base = Path(tmp) / "epochs.tim"
            t.write_TOA_file(base, name="wbsim")
            t = make_fake_toas_fromtim(base, m, add_noise=True,
                                       add_correlated_noise=True,
                                       seed=PACK_NOISE_SEED, wideband=True)
            t.write_TOA_file(out_dir / "wb_sim.tim", name="wbsim")
    finally:
        jnative._LIB = saved
    (out_dir / "wb_sim.par").write_text(PACK_PAR)
    return out_dir / "wb_sim.par", out_dir / "wb_sim.tim"


def _fit_record(f, chi2, cls, kw):
    return {"class": cls, "kwargs": kw, "chi2": float(chi2),
            "values": {p: float(getattr(f.model, p).value)
                       for p in f.model.free_params},
            "uncertainties": {p: getattr(f.model, p).uncertainty
                              for p in f.model.free_params}}


def postfit_fixture(par=WB_PAR, tim=WB_TIM):
    """The JAX package's prefit residuals (time [s] and DM) and fits of
    the pack on the CPU (numpy host path): each wideband fitter's chi2,
    values and uncertainties, and
    ``pintempo --fitter auto``'s post-fit par file read back by its
    get_model (values, uncertainties to the printed 5 digits, CHI2)."""
    import contextlib
    import io
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pint_tpu
    import pint_tpu.fitter as jf
    import pint_tpu.native as jnative
    from pint_tpu.models import get_model
    from pint_tpu.residuals import WidebandTOAResiduals
    from pint_tpu.scripts import pintempo

    saved = jnative._LIB
    jnative._LIB = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m, t = pint_tpu.get_model_and_toas(str(par), str(tim))
            wb = WidebandTOAResiduals(t, m)
            out = {"source": "pint_tpu (the JAX package) on the CPU, numpy "
                             "host path: get_model_and_toas on "
                             "wb_sim.par/.tim, the prefit "
                             "WidebandTOAResiduals, then each fitter's "
                             "fit_toas(**kwargs), and pintempo --fitter "
                             "auto --outfile read back by get_model; "
                             "written by tests/test_torch_wideband.py",
                   "prefit": {
                       "time_resids_s": [float(v) for v in wb.time_resids],
                       "dm_resids": [float(v) for v in wb.dm.resids],
                       "chi2": float(wb.chi2)},
                   "fitters": {}}
            for key, cls, kw in FITTERS:
                f = getattr(jf, cls)(t, copy.deepcopy(m))
                out["fitters"][key] = _fit_record(f, f.fit_toas(**kw),
                                                  cls, kw)
            with tempfile.TemporaryDirectory() as tmp:
                post = Path(tmp) / "post.par"
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = pintempo.main([str(par), str(tim), "--fitter",
                                        "auto", "--outfile", str(post)])
                pm = get_model(str(post))
            out["pintempo_auto"] = {
                "rc": rc, "chi2": float(pm.CHI2.value),
                "values": {p: float(getattr(pm, p).value)
                           for p in pm.free_params},
                "uncertainties": {p: getattr(pm, p).uncertainty
                                  for p in pm.free_params}}
    finally:
        jnative._LIB = saved
    return out


@pytest.fixture(scope="module")
def pack():
    """(port model, port TOAs, JAX model, JAX TOAs): the committed pack
    through each package's get_model_and_toas on its numpy host path,
    the fixture's."""
    import pint_tpu
    import pint_tpu.native as jnative
    import pint_tpu_torch
    from pint_tpu_torch import native

    saved = native._LIB, jnative._LIB
    native._LIB = jnative._LIB = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m, t = pint_tpu_torch.get_model_and_toas(str(WB_PAR), str(WB_TIM),
                                                     usepickle=False)
            jm, jt = pint_tpu.get_model_and_toas(str(WB_PAR), str(WB_TIM))
    finally:
        native._LIB, jnative._LIB = saved
    return m, t, jm, jt


def _dx_sigma(values, sigmas, model):
    return max(abs(getattr(model, p).value - values[p]) / sigmas[p]
               for p in values)


# ---- components ----

def test_scale_dm_sigma_matches_jax():
    """DMEFAC/DMEQUAD scaling on the same params and masks, from a numpy
    seed: 1e-15 relative."""
    import jax.numpy as jnp
    from pint_tpu.models.noise import ScaleToaError as JScale
    from pint_tpu_torch.models.noise import ScaleToaError

    rng = np.random.default_rng(5)
    n = 64
    params = {"DMEFAC": rng.uniform(0.8, 1.5, 3),
              "DMEQUAD": rng.uniform(0.0, 3e-4, 2)}
    prep = {"dmefac_masks": (rng.uniform(size=(3, n)) < 0.4).astype(float),
            "dmequad_masks": (rng.uniform(size=(2, n)) < 0.5).astype(float)}
    sigma = rng.uniform(5e-5, 5e-4, n)
    a = np.asarray(JScale().scale_dm_sigma(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in prep.items()}, jnp.asarray(sigma)))
    b = ScaleToaError().scale_dm_sigma(
        {k: torch.as_tensor(v) for k, v in params.items()},
        {k: torch.as_tensor(v) for k, v in prep.items()},
        torch.as_tensor(sigma)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-15, atol=0)
    assert not np.allclose(b, sigma)


BASE = ("PSR TESTWB\nRAJ 16:00:51.9\nDECJ -30:53:49.3\nF0 277.94 1\n"
        "F1 -7.3e-16 1\nPEPOCH 55300\nDM 52.33 1\nDM1 1e-4 1\n")
DM_CASES = {
    "dmx": "DMX 14.0\nDMX_0001 1e-3 1\nDMXR1_0001 54000\nDMXR2_0001 55000\n"
           "DMX_0002 -2e-3 1\nDMXR1_0002 55000\nDMXR2_0002 56000\n",
    "dmwavex": "DMWXEPOCH 55300\nDMWXFREQ_0001 0.002\nDMWXSIN_0001 1e-4 1\n"
               "DMWXCOS_0001 -2e-4 1\nDMWXFREQ_0002 0.004\n"
               "DMWXSIN_0002 5e-5 1\nDMWXCOS_0002 3e-5 1\n",
    "swx": "SWXDM_0001 1e-3 1\nSWXP_0001 2.0\nSWXR1_0001 54000\n"
           "SWXR2_0001 55500\nSWXDM_0002 2e-3 1\nSWXP_0002 2.0\n"
           "SWXR1_0002 55500\nSWXR2_0002 57000\n",
    "swm": "NE_SW 7.9 1\nSWM 1\nSWP 2.5\n",
    "dmjump": "DMJUMP -fe Rcvr_800 2e-4 1\nDMJUMP -fe Rcvr1_2 -1e-4 1\n",
}


def _fe_flags(jt):
    for f, nu in zip(jt.flags, jt.freq_mhz):
        f["fe"] = _receiver(nu)


@pytest.mark.parametrize("name", list(DM_CASES))
def test_wideband_dm_model_matches_jax(name):
    """The model DM with and without the DMJUMP offsets, f64, to 1e-12
    relative; a DMJUMP enters with the minus sign on its receiver's
    TOAs alone; a solar-wind model needs ``batch=``."""
    from pint_tpu.residuals import wideband_dm_model as jdm
    from pint_tpu_torch.residuals import wideband_dm_model as tdm
    from test_torch_binary import jax_pair

    jm, jp, tm, tp = jax_pair(BASE + DM_CASES[name], n_epochs=24, seed=3,
                              flagger=_fe_flags)
    for jumps in (True, False):
        a = np.asarray(jdm(jm, jp.params0, jp.prep, batch=jp.batch,
                           include_jumps=jumps))
        b = tdm(tm, tp.params0, tp.prep, batch=tp.batch,
                include_jumps=jumps).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    if name == "dmjump":
        with_j = tdm(tm, tp.params0, tp.prep, batch=tp.batch).numpy()
        without = tdm(tm, tp.params0, tp.prep, batch=tp.batch,
                      include_jumps=False).numpy()
        fe = np.array([f["fe"] for f in tp.toas.flags])
        np.testing.assert_allclose(without - with_j,
                                   np.where(fe == "Rcvr_800", 2e-4, -1e-4),
                                   rtol=1e-9)
    if name in ("swx", "swm"):
        with pytest.raises(ValueError, match="batch="):
            tdm(tm, tp.params0, tp.prep)
    np.testing.assert_allclose(tm.total_dm(tp.toas, device="cpu"),
                               np.asarray(jm.total_dm(jp.toas)), rtol=1e-12)


def _wb_flags(jt, bad=()):
    rng = np.random.default_rng(9)
    for i, f in enumerate(jt.flags):
        f["pp_dm"] = repr(52.33 + 1e-4 * rng.standard_normal())
        f["pp_dme"] = "0.0001"
    for i, kind in bad:
        if kind == "missing":
            del jt.flags[i]["pp_dme"]
        elif kind == "zero":
            jt.flags[i]["pp_dme"] = "0"
        else:
            del jt.flags[i]["pp_dm"]
            del jt.flags[i]["pp_dme"]


@pytest.mark.parametrize("bad", [(), ((1, "missing"), (4, "zero"),
                                      (5, "zero"), (7, "none"))],
                         ids=["clean", "excluded"])
def test_wideband_dm_residuals_match_jax(bad):
    """WidebandDMResiduals: dm_observed, valid, dm_error (DMEFAC/DMEQUAD
    scaled), resids and chi2 as the JAX package's, and the same
    warning for a missing or a non-positive -pp_dme."""
    from pint_tpu.residuals import WidebandTOAResiduals as JWB
    from pint_tpu_torch.residuals import WidebandTOAResiduals
    from test_torch_binary import jax_pair
    from test_torch_models import port_toas

    par = (BASE + DM_CASES["dmjump"] + "DMEFAC -fe Rcvr_800 1.3\n"
           "DMEQUAD -fe Rcvr1_2 5e-5\n")

    def flagger(jt):
        _fe_flags(jt)
        _wb_flags(jt, bad)

    jm, jp, tm, tp = jax_pair(par, n_epochs=12, seed=4, flagger=flagger)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        a = JWB(jp.toas, jm, prepared=jp)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        b = WidebandTOAResiduals(tp.toas, tm, prepared=tp)
    mj = [str(w.message) for w in wj if "excluded" in str(w.message)]
    mt = [str(w.message) for w in wt if "excluded" in str(w.message)]
    assert mt == mj and len(mt) == (1 if bad else 0)
    if bad:
        assert "2 with non-positive -pp_dme" in mt[0]
        assert "1 with -pp_dm but no -pp_dme" in mt[0]
    np.testing.assert_array_equal(b.dm.valid, a.dm.valid)
    np.testing.assert_array_equal(np.isnan(b.dm.dm_observed),
                                  np.isnan(a.dm.dm_observed))
    ok = b.dm.valid
    np.testing.assert_allclose(b.dm.dm_observed[ok], a.dm.dm_observed[ok],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(b.dm.dm_error[ok], a.dm.dm_error[ok],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(b.dm.resids, np.asarray(a.dm.resids),
                               rtol=1e-12, atol=1e-12 * 52.33)
    assert b.dm.chi2 == pytest.approx(a.dm.chi2, rel=1e-12)
    assert b.dof == a.dof and b.chi2 == pytest.approx(a.chi2, rel=1e-9)
    assert b.rms_weighted() == pytest.approx(a.rms_weighted(), rel=1e-9)


def test_combined_residuals():
    """CombinedResiduals sums chi2 and dof over datasets and concatenates
    their time residuals, as the JAX package's does."""
    from pint_tpu.residuals import CombinedResiduals as JC
    from pint_tpu.residuals import Residuals as JR
    from pint_tpu_torch.residuals import CombinedResiduals, Residuals
    from test_torch_binary import jax_pair

    pairs = [jax_pair(BASE, n_epochs=8, seed=s) for s in (1, 2)]
    a = JC([JR(jp.toas, jm, prepared=jp) for jm, jp, _, _ in pairs])
    b = CombinedResiduals([Residuals(tp.toas, tm, prepared=tp)
                           for _, _, tm, tp in pairs])
    assert b.dof == a.dof and b.chi2 == pytest.approx(a.chi2, rel=1e-9)
    assert b.reduced_chi2 == pytest.approx(a.reduced_chi2, rel=1e-9)
    np.testing.assert_allclose(b.calc_time_resids(), a.calc_time_resids(),
                               rtol=0, atol=1e-12)


def test_combined_design_matrix_matches_jax(pack):
    """The wideband fitter's combined design (time rows with the Offset
    column, DM rows without): the same names, units, row segments and
    entries to 1e-12 of each column's max; d(DM resid)/d(DMJUMP) = +1
    on the jump's receiver."""
    import pint_tpu.fitter as jf
    import pint_tpu_torch.fitter as tf

    m, t, jm, jt = pack
    fj = jf.WidebandTOAFitter(jt, copy.deepcopy(jm))
    ft = tf.WidebandTOAFitter(t, copy.deepcopy(m), device="cpu")
    sj, st = fj._wideband_system(), ft._wideband_system()
    cj, ct = sj[1], st[1]
    assert ct.param_names == cj.param_names
    assert ct.units(1) == cj.units(1)
    assert ct.axis_labels[0] == cj.axis_labels[0]
    assert st[4] == sj[4] == 1
    a, b = np.asarray(cj.matrix), ct.matrix.numpy()
    scale = np.abs(a).max(axis=0)
    assert np.all(np.abs(b - a) <= 1e-12 * scale)
    n = len(t)
    col = ct.param_names.index("DMJUMP1")
    fe = np.array([f["fe"] for f in t.flags])
    np.testing.assert_array_equal(b[n:, col], (fe == "Rcvr_800") * 1.0)
    np.testing.assert_array_equal(b[:n, 0], 1.0 / ft.model.F0.value)
    np.testing.assert_array_equal(b[n:, 0], 0.0)
    np.testing.assert_allclose(st[2].numpy(), np.asarray(sj[2]), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(st[3].numpy(), np.asarray(sj[3]),
                               rtol=1e-14)


def test_prefit_residuals_match_fixture(pack):
    """The pack's prefit WidebandTOAResiduals against the JAX package's
    in WB_postfit.json: DM residuals 1e-12 of the DM, time residuals
    1e-12 s, chi2 at the 1e-7 tier."""
    from pint_tpu_torch.residuals import WidebandTOAResiduals

    fx = json.loads(WB_POSTFIT.read_text())["prefit"]
    m, t, _, _ = pack
    wb = WidebandTOAResiduals(t, m, device="cpu")
    assert wb.dm.valid.all() and len(wb.dm.resids) == len(t) == 300
    assert np.abs(wb.dm.resids - fx["dm_resids"]).max() <= \
        1e-12 * m.DM.value
    assert np.abs(wb.time_resids - fx["time_resids_s"]).max() <= 1e-12
    assert abs(wb.chi2 - fx["chi2"]) <= TOL_CHI2 * fx["chi2"]


# ---- fitters ----

@pytest.mark.parametrize("key,cls,kw", FITTERS, ids=[f[0] for f in FITTERS])
def test_wideband_fits_match_fixture(pack, key, cls, kw):
    """Each wideband fitter on the pack against the JAX package's fit
    in WB_postfit.json: values 1e-6 sigma (LM: its stopping rule),
    uncertainties at their tier, chi2 1e-7, the summary's residuals,
    the post-fit par file's CHI2 and the noise realizations."""
    import pint_tpu_torch.fitter as tf

    fx = json.loads(WB_POSTFIT.read_text())["fitters"][key]
    m, t, _, _ = pack
    f = getattr(tf, cls)(t, copy.deepcopy(m), device="cpu")
    chi2 = f.fit_toas(**kw)
    sig = fx["uncertainties"]
    assert f.model.free_params == list(fx["values"])
    tol_x = (np.sqrt(LM_TOL * fx["chi2"]) if cls == "WidebandLMFitter"
             else TOL_X)
    assert _dx_sigma(fx["values"], sig, f.model) <= tol_x
    tol_u = (TOL_MIXED_UNC if kw.get("precision") == "mixed"
             else TOL_SAFEGUARD_UNC if cls == "WidebandLMFitter" else TOL_COV)
    for p in sig:
        assert abs(getattr(f.model, p).uncertainty / sig[p] - 1) <= tol_u, p
    assert abs(chi2 - fx["chi2"]) <= TOL_CHI2 * fx["chi2"]
    assert f.chi2_whitened == chi2 and f.model.CHI2.value == chi2
    assert type(f.resids).__name__ == "WidebandTOAResiduals"
    assert f.resids.dof == len(t) - len(f.model.free_params) - 1 + len(t)
    assert set(f.get_noise_resids()) == {"EcorrNoise", "PLRedNoise"}
    assert f.converged and f.metrics["backend"] == "cpu"
    assert "Fitted model using " + cls in f.get_summary()


@pytest.mark.parametrize("maxiter", [1, 2])
@pytest.mark.parametrize("cls", ["WidebandTOAFitter", "WidebandDownhillFitter",
                                 "WidebandLMFitter"])
def test_wideband_iterates_match_jax(pack, cls, maxiter):
    """One and two iterates at a time: values 1e-6 sigma, uncertainties
    1e-10 relative and each covariance entry to 1e-10 of
    sigma_i sigma_j (the f64 covariance tier; an entry of a nearly
    uncorrelated pair is a difference of products and meets it only on
    that scale [6e-9 of itself]), chi2 1e-7, the noise amplitudes 1e-5
    of the largest, against the JAX package's fit from the same
    start."""
    import pint_tpu.fitter as jf
    import pint_tpu_torch.fitter as tf

    m, t, jm, jt = pack
    fj = getattr(jf, cls)(jt, copy.deepcopy(jm))
    cj = fj.fit_toas(maxiter=maxiter)
    ft = getattr(tf, cls)(t, copy.deepcopy(m), device="cpu")
    ct = ft.fit_toas(maxiter=maxiter)
    sig = {p: getattr(fj.model, p).uncertainty for p in fj.model.free_params}
    vals = {p: getattr(fj.model, p).value for p in fj.model.free_params}
    assert _dx_sigma(vals, sig, ft.model) <= TOL_X
    covj = np.asarray(fj.parameter_covariance_matrix)
    covt = ft.parameter_covariance_matrix
    d = np.sqrt(np.diag(covj))
    np.testing.assert_allclose(np.sqrt(np.diag(covt)), d, rtol=TOL_COV,
                               atol=0)
    assert np.all(np.abs(covt - covj) <= TOL_COV * np.outer(d, d))
    assert abs(ct - float(cj)) <= TOL_CHI2 * float(cj)
    np.testing.assert_allclose(ft.noise_ampls, np.asarray(fj.noise_ampls),
                               rtol=1e-5, atol=1e-5 * np.abs(
                                   np.asarray(fj.noise_ampls)).max())


@pytest.mark.parametrize("cls", ["WidebandTOAFitter", "WidebandLMFitter"])
def test_wideband_mixed_matches_f64(pack, cls):
    """precision="mixed" (f32 Gram + f64 refinement) against f64 in the
    port: values 1e-6 sigma, uncertainties at the mixed tier, no
    fallback to the f64 Gram."""
    import pint_tpu_torch.fitter as tf

    m, t, _, _ = pack
    f64 = getattr(tf, cls)(t, copy.deepcopy(m), device="cpu")
    f64.fit_toas(maxiter=2)
    fm = getattr(tf, cls)(t, copy.deepcopy(m), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fm.fit_toas(maxiter=2, precision="mixed")
    sig = {p: getattr(f64.model, p).uncertainty for p in f64.model.free_params}
    vals = {p: getattr(f64.model, p).value for p in f64.model.free_params}
    assert _dx_sigma(vals, sig, fm.model) <= TOL_X
    for p in sig:
        assert abs(getattr(fm.model, p).uncertainty / sig[p] - 1) \
            <= TOL_MIXED_UNC


@pytest.mark.cuda
@pytest.mark.parametrize("key,cls,kw", FITTERS, ids=[f[0] for f in FITTERS])
def test_wideband_fits_on_card_match_fixture(key, cls, kw):
    """On the card: each wideband fitter on the pack held to the JAX
    fixture at the CPU test's tiers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import pint_tpu_torch
    import pint_tpu_torch.fitter as tf

    fx = json.loads(WB_POSTFIT.read_text())["fitters"][key]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m, t = pint_tpu_torch.get_model_and_toas(str(WB_PAR), str(WB_TIM))
    f = getattr(tf, cls)(t, m, device="cuda")
    chi2 = f.fit_toas(**kw)
    sig = fx["uncertainties"]
    tol_x = (np.sqrt(LM_TOL * fx["chi2"]) if cls == "WidebandLMFitter"
             else TOL_X)
    assert _dx_sigma(fx["values"], sig, f.model) <= tol_x
    tol_u = (TOL_MIXED_UNC if kw.get("precision") == "mixed"
             else TOL_SAFEGUARD_UNC if cls == "WidebandLMFitter" else TOL_COV)
    for p in sig:
        assert abs(getattr(f.model, p).uncertainty / sig[p] - 1) <= tol_u, p
    assert abs(chi2 - fx["chi2"]) <= TOL_CHI2 * fx["chi2"]
    assert f.metrics["backend"] == "cuda"


def test_dmjump_recovers_receiver_offset():
    """tests/test_wideband.py::test_dmjump_recovers_receiver_offset in
    both packages: a 3e-4 DM offset on one receiver's measurements is
    recovered by a free DMJUMP (d(DM resid)/d(DMJUMP) = +1), and the
    packages agree to 1e-6 sigma."""
    import pint_tpu.fitter as jf
    import pint_tpu_torch.fitter as tf
    from pint_tpu.models import get_model as jget
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.models import get_model
    from test_torch_models import port_toas

    par = ("PSR TESTJ\nRAJ 12:00:00.0\nDECJ 15:00:00.0\nF0 218.8 1\n"
           "F1 -4e-16 1\nPEPOCH 55500\nDM 15.99 1\n"
           "DMJUMP -fe Rcvr_800 0.0 1\n")
    rng = np.random.default_rng(2)
    mjds = np.linspace(55000, 56000, 60)
    freqs = np.where(np.arange(60) % 2, 1400.0, 800.0)
    jm = jget(par)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = make_fake_toas_fromMJDs(mjds, jm, error_us=1.0,
                                     freq_mhz=freqs, obs="gbt",
                                     add_noise=True, seed=2)
    for f, nu in zip(jt.flags, freqs):
        f["fe"] = _receiver(nu)
        off = 3e-4 if f["fe"] == "Rcvr_800" else 0.0
        f["pp_dm"] = repr(15.99 + off + 1e-5 * rng.standard_normal())
        f["pp_dme"] = "1e-5"
    fj = jf.WidebandTOAFitter(jt, jm)
    fj.fit_toas(maxiter=3)
    ft = tf.WidebandTOAFitter(port_toas(jt), get_model(par), device="cpu")
    ft.fit_toas(maxiter=3)
    for f in (fj, ft):
        assert abs(f.model.DMJUMP1.value + 3e-4) < 1e-5
    sig = {p: getattr(fj.model, p).uncertainty for p in fj.model.free_params}
    vals = {p: getattr(fj.model, p).value for p in fj.model.free_params}
    assert _dx_sigma(vals, sig, ft.model) <= TOL_X


def test_refusals_keep_the_jax_messages(pack):
    """A free DMEFAC is refused by every wideband fitter and a free
    DMJUMP by every narrowband fitter, each with the JAX package's
    words; the wideband fit_toas take the JAX package's parameters, so
    ``fit_quality=True`` is a TypeError in both."""
    import inspect

    import pint_tpu.fitter as jf
    import pint_tpu_torch.fitter as tf

    m, t, jm, jt = pack
    for pkg, model, toas, kw in ((jf, jm, jt, {}),
                                 (tf, m, t, {"device": "cpu"})):
        mm = copy.deepcopy(model)
        mm.DMEFAC1.frozen = False
        for cls in ("WidebandTOAFitter", "WidebandDownhillFitter",
                    "WidebandLMFitter"):
            with pytest.raises(ValueError, match=r"free DMEFAC/DMEQUAD "
                               r"parameters \['DMEFAC1'\] scale wideband"):
                getattr(pkg, cls)(toas, mm, **kw).fit_toas()
        for cls in ("WLSFitter", "DownhillWLSFitter", "GLSFitter",
                    "DownhillGLSFitter", "PowellFitter"):
            nb = copy.deepcopy(model)
            if cls in ("WLSFitter", "DownhillWLSFitter"):
                nb.remove_component("EcorrNoise")
                nb.remove_component("PLRedNoise")
            with pytest.raises(ValueError, match=r"free DMJUMP parameters "
                               r"\['DMJUMP1'\] affect only wideband DM"):
                getattr(pkg, cls)(toas, nb, **kw).fit_toas()
    for cls in ("WidebandTOAFitter", "WidebandDownhillFitter",
                "WidebandLMFitter"):
        assert inspect.signature(getattr(tf, cls).fit_toas) \
            == inspect.signature(getattr(jf, cls).fit_toas)
        for pkg, model, toas, kw in ((jf, jm, jt, {}),
                                     (tf, m, t, {"device": "cpu"})):
            with pytest.raises(TypeError, match="fit_quality"):
                getattr(pkg, cls)(toas, model, **kw).fit_toas(
                    fit_quality=True)


def test_auto_fitter_picks_wideband_downhill(pack):
    from pint_tpu.fitter import auto_fitter as jauto
    from pint_tpu_torch.fitter import auto_fitter

    m, t, jm, jt = pack
    assert type(auto_fitter(t, m, device="cpu")).__name__ == \
        type(jauto(jt, jm)).__name__ == "WidebandDownhillFitter"


def test_wideband_fake_toas_match_jax(tmp_path):
    """make_fake_toas_fromMJDs and make_fake_toas_fromtim with
    ``wideband=True`` and noise: the flags (-pp_dm/-pp_dme included) are
    bitwise the JAX package's for a shared seed, and the epochs agree
    to 1e-12 s; a model without DM and a non-positive DM error are
    refused."""
    from pint_tpu.models import get_model as jget
    from pint_tpu.simulation import make_fake_toas_fromMJDs as jfake
    from pint_tpu.simulation import make_fake_toas_fromtim as jfake_tim
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import (make_fake_toas_fromMJDs,
                                           make_fake_toas_fromtim)

    par = BASE + DM_CASES["dmx"] + DM_CASES["dmjump"]
    mjds = np.linspace(54100, 55900, 24)
    kw = dict(error_us=1.0, freq_mhz=np.tile([820.0, 1500.0], 12),
              add_noise=True, seed=5, wideband=True, dm_error_pccm3=2e-4,
              iterations=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jfake(mjds, jget(par), **kw)
        t = make_fake_toas_fromMJDs(mjds, get_model(par), device="cpu",
                                    **kw)
    assert t.flags == j.flags
    assert all(f["pp_dme"] == repr(2e-4) for f in t.flags)
    d = (t.day - j.day) * 86400.0 + (t.sec - j.sec)
    assert np.abs(d).max() <= 1e-12
    j.write_TOA_file(tmp_path / "in.tim")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j2 = jfake_tim(tmp_path / "in.tim", jget(par), add_noise=True,
                       seed=8, wideband=True)
        t2 = make_fake_toas_fromtim(tmp_path / "in.tim", get_model(par),
                                    add_noise=True, seed=8, wideband=True,
                                    device="cpu")
    assert t2.flags == j2.flags
    with pytest.raises(ValueError, match="needs a dispersion model"):
        make_fake_toas_fromMJDs(mjds, get_model(BASE.replace(
            "DM 52.33 1\nDM1 1e-4 1\n", "")), wideband=True, device="cpu")
    with pytest.raises(ValueError, match="must be > 0"):
        make_fake_toas_fromMJDs(mjds, get_model(par), wideband=True,
                                dm_error_pccm3=0.0, device="cpu")


def main():
    sys.path.insert(0, str(ROOT))
    make_pack(EXAMPLES)
    WB_POSTFIT.write_text(json.dumps(postfit_fixture(), indent=1) + "\n")
    print(f"wrote {WB_PAR}, {WB_TIM} and {WB_POSTFIT}", file=sys.stderr)


if __name__ == "__main__":
    main()
