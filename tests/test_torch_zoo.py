"""The port's model zoo (pint_tpu_torch/models) against the JAX
package's: DMX, DMJUMP, JUMP, FD, FDJUMP (log and linear), PHOFF,
glitches, piecewise spindown, IFUNC (both modes), Wave/WaveX/DMWaveX,
CM/CMX/CMWaveX, PLDM/PLChrom/PLSW noise, SWX windows, DelayJump, UNITS
TCB; every par file the JAX package's zoo tests load; and the b1855sim
golden pack through the fitters (the mixed-structure fleet is in
tests/test_torch_binary.py).

TOAs come from the JAX package's fake-TOA maker at GBT
(``test_torch_binary.jax_pair``: numpy-seeded epochs, 4 TOAs per epoch
at 800/1400 MHz, ``-fe Rcvr_800``/``-fe Rcvr1_2`` by frequency where a
case selects by receiver).

Tolerances (the tiers of tests/test_torch_models.py): delays 1e-12 s
per component; the total phase 1e-9 cycles with equal integer parts;
design-matrix columns 1e-9 of each column's max |entry|; residuals
1e-12 s; noise bases and weights 1e-12 relative; the model DM 1e-12
relative; d_phase_d_toa 1e-9 Hz (a 1 s central difference of phases
that agree to 1e-9 cycles... held at 1e-9 cycles / 2 s); the b1855sim
golden residuals 1e-3 us and chi2_whitened 0.01 (the JAX package's own
tiers, tests/test_golden.py); fitted values 1e-6 sigma of the JAX fit
fixture, uncertainties of the safeguarded fits 1e-5 relative (ROADMAP
§3); chi2 1e-7 relative (the noise-batch tier of
tests/test_torch_fitter.py: with 1 us errors the ~1e-13 s one-ulp
residual gap weighs).

``python tests/test_torch_zoo.py`` rewrites
``pint_tpu_torch/data/examples/B1855SIM_postfit.json`` (the JAX
package's fits on the CPU); ``python tests/test_torch_zoo.py --corpus``
rewrites ``tests/torch_zoo_pars.json`` by running the JAX package's zoo
test files (``ZOO_TESTS``) with ``get_model`` recording every par file
it is given (several minutes).
"""

import copy
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_binary import check_round_trip, compare_prepared, jax_pair

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "pint_tpu_torch" / "data" / "examples"
B1855_PAR = EXAMPLES / "b1855sim.par"
B1855_TIM = EXAMPLES / "b1855sim.tim"
B1855_POSTFIT = EXAMPLES / "B1855SIM_postfit.json"
CORPUS = Path(__file__).resolve().parent / "torch_zoo_pars.json"
ZOO_TESTS = ("tests/test_binary.py", "tests/test_binary_variants.py",
             "tests/test_chromatic.py", "tests/test_breadth.py",
             "tests/test_components.py", "tests/test_components2.py",
             "tests/test_derivatives_binaries.py", "tests/test_noise_gls.py")

BASE = ("PSR TESTZ\nRAJ 16:00:51.9\nDECJ -30:53:49.3\nF0 277.94 1\n"
        "F1 -7.3e-16 1\nPEPOCH 55300\nDM 52.33\n")
WINDOWS = "".join(f"DMX_{k:04d} {1e-3 * (k - 2)} 1\nDMXR1_{k:04d} "
                  f"{54000 + 1000 * (k - 1)}\nDMXR2_{k:04d} "
                  f"{54999.9 + 1000 * (k - 1)}\n" for k in (1, 2, 3))
CASES = {
    "dmx_jump_fd": WINDOWS + "DMJUMP -fe Rcvr_800 0.002 1\n"
                   "JUMP -fe Rcvr_800 1e-4 1\nJUMP mjd 55000 55500 2e-5 1\n"
                   "FD1 1e-5 1\nFD2 -2e-6 1\nFD3 1e-7 1\n"
                   "FD1JUMP -fe Rcvr_800 1e-6 1\nFDJUMP2 -fe Rcvr1_2 2e-7 1\n"
                   "PHOFF 0.01 1\n",
    "fdjump_linear": "FDJUMPLOG N\nFD1JUMP -fe Rcvr_800 1e-6 1\n"
                     "FD2JUMP -fe Rcvr_800 -3e-7 1\n",
    "glitch_piecewise": "GLEP_1 55000\nGLPH_1 0.1 1\nGLF0_1 1e-7 1\n"
                        "GLF1_1 -1e-15 1\nGLF0D_1 2e-8 1\nGLTD_1 50 1\n"
                        "GLEP_2 56000 1\nGLF0_2 3e-8 1\nGLF2_2 1e-24 1\n"
                        "PWEP_0001 55500\nPWSTART_0001 55000\n"
                        "PWSTOP_0001 56000\nPWPH_0001 0.01 1\n"
                        "PWF0_0001 1e-9 1\nPWF1_0001 -1e-17 1\n",
    "ifunc_linear": "SIFUNC 2\nIFUNC1 54000 1e-5 1\nIFUNC2 56500 -2e-5 1\n"
                    "IFUNC3 55200 3e-5 1\nIFUNC4 57000 1e-6 1\n",
    "ifunc_constant": "SIFUNC 0\nIFUNC1 54500 1e-5 1\nIFUNC2 55500 -2e-5 1\n"
                      "IFUNC3 56500 3e-5 1\n",
    "waves": "WAVE_OM 0.01 1\nWAVEEPOCH 55000\nWAVE1 1e-5 -2e-5\n"
             "WAVE2 3e-6 1e-6\nWXEPOCH 55300\nWXFREQ_0001 0.0011\n"
             "WXSIN_0001 1e-6 1\nWXCOS_0001 -2e-6 1\nWXFREQ_0002 0.0023\n"
             "WXSIN_0002 5e-7 1\nWXCOS_0002 1e-7 1\nDMWXEPOCH 55300\n"
             "DMWXFREQ_0001 0.0009\nDMWXSIN_0001 1e-4 1\n"
             "DMWXCOS_0001 -3e-4 1\n",
    "chromatic": "CM 0.5 1\nCM1 0.01 1\nCMEPOCH 55000\nTNCHROMIDX 4.2 1\n"
                 "CMX_0001 0.1 1\nCMXR1_0001 54000\nCMXR2_0001 55000\n"
                 "CMX_0002 -0.2 1\nCMXR1_0002 55500\nCMXR2_0002 56500\n"
                 "CMWXEPOCH 55300\nCMWXFREQ_0001 0.001\nCMWXSIN_0001 0.01 1\n"
                 "CMWXCOS_0001 0.02 1\n",
    "noise": "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\nECORR -f L-wide 0.8\n"
             "TNDMAMP -13 \nTNDMGAM 3\nTNDMC 10\nTNCHROMAMP -14\n"
             "TNCHROMGAM 2.5\nTNCHROMC 8\nTNCHROMIDX 4\nNE_SW 5\n"
             "TNSWAMP -4\nTNSWGAM 2\nTNSWC 6\n",
    "swx": "NE_SW 6 1\nSWXDM_0001 1e-3 1\nSWXR1_0001 54000\nSWXR2_0001 55000\n"
           "SWXP_0001 2.5\nSWX_0002 2e-3 1\nSWXR1_0002 55500\n"
           "SWXR2_0002 56500\nTNSWAMP -4\nTNSWGAM 2\nTNSWC 6\n",
    "swm1": "NE_SW 6 1\nSWM 1\nSWP 2.5 1\nTNSWAMP -4\nTNSWGAM 2\nTNSWC 6\n",
    "tcb": "UNITS TCB\n" + WINDOWS + "BINARY ELL1\nPB 1.53 1\nA1 1.898 1\n"
           "TASC 55001.0 1\nEPS1 2e-8 1\nEPS2 -8e-8 1\nM2 0.21\nSINI 0.998\n",
}
NOISE = ("EcorrNoise", "PLDMNoise", "PLChromNoise", "PLSWNoise")
TOL_BASIS = 1e-12
# chi2 of the b1855sim fits, relative: the noise-batch tier of
# tests/test_torch_fitter.py. With 1 us errors the packages' ~1e-13 s
# residual gap (one-ulp phase differences, 8e-14 s here) weighs
# [measured 2e-9 GLS, 3.5e-9 DownhillGLS, 4.8e-8 white WLS]
TOL_CHI2 = 1e-7
# mixed-precision uncertainties of the b1855sim GLS fit, relative: out
# of the 1e-4 mixed tier (ROADMAP §3); each package's f32 Gram in its
# own summation order on this pack's wider spectrum [measured 1.7e-4]
TOL_MIXED_UNC = 3e-4


def receivers(jt):
    """-fe by frequency, as NANOGrav's GBT receivers."""
    for f, nu in zip(jt.flags, jt.freq_mhz):
        f["fe"] = "Rcvr_800" if nu < 1000.0 else "Rcvr1_2"


def zoo_pair(name, n_epochs=30, seed=0):
    kw = {"allow_tcb": True} if name == "tcb" else {}
    return jax_pair(BASE + CASES[name], n_epochs=n_epochs, seed=seed,
                    flagger=receivers, **kw)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jm, jp, tm, tp = zoo_pair(request.param)
    return request.param, compare_prepared(jm, jp, tm, tp), (jm, jp, tm, tp)


@pytest.mark.parametrize("check", ["delay per component [s]",
                                   "phase [cycles]",
                                   "phase integer parts differ",
                                   "design columns [of max|col|]",
                                   "residuals [s]"])
def test_zoo_matches_jax(case, check):
    name, gaps, _ = case
    gap, tier = gaps[check]
    assert gap <= tier, f"{name}: {check} {gap:.3e} > {tier:.0e}"


def test_zoo_pack_matches_jax(case):
    """Every numeric prep leaf of the JAX package's pack equals the
    port's: bitwise, except the PLSWNoise basis, whose line-of-sight
    quadrature rounds differently in XLA and torch (1e-12 relative)."""
    _, _, (jm, jp, tm, tp) = case
    for k, v in jp.prep.items():
        a = np.asarray(v)
        if a.dtype.kind not in "biuf" or a.dtype.itemsize > 8:
            continue
        b = tp.prep[k]
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if k == "swrn_F":
            assert np.abs(b - a).max() <= TOL_BASIS * np.abs(a).max(), k
        else:
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=k)


def test_zoo_parfile_round_trip(case):
    check_round_trip(*case[2][2:])


@pytest.mark.parametrize("name", NOISE)
def test_noise_bases_and_weights_match_jax(name):
    jm, jp, tm, tp = zoo_pair("noise")
    Bj, wj = jm.components[name].basis_weight(jp.params0, jp.prep)
    Bt, wt = tm.components[name].basis_weight(tp.params0, tp.prep)
    Bj, wj = np.asarray(Bj), np.asarray(wj)
    assert Bt.shape == Bj.shape and Bj.shape[1] > 0
    assert np.abs(Bt.numpy() - Bj).max() <= TOL_BASIS * np.abs(Bj).max()
    assert np.abs(wt.numpy() - wj).max() <= TOL_BASIS * np.abs(wj).max()


def test_swx_noise_basis_follows_window_index():
    """Under SWX, PLSWNoise's basis uses each window's SWXP."""
    jm, jp, tm, tp = zoo_pair("swx")
    Bj, _ = jm.components["PLSWNoise"].basis_weight(jp.params0, jp.prep)
    Bt, _ = tm.components["PLSWNoise"].basis_weight(tp.params0, tp.prep)
    assert np.abs(Bt.numpy() - np.asarray(Bj)).max() \
        <= TOL_BASIS * np.abs(np.asarray(Bj)).max()


def test_phoff_replaces_the_offset_column():
    jm, jp, tm, tp = zoo_pair("dmx_jump_fd", n_epochs=6)
    _, labels = tp.designmatrix()
    assert "Offset" not in labels and "PHOFF" in labels
    assert labels == jp.designmatrix()[1]


@pytest.mark.parametrize("name", ["dmx_jump_fd", "swx", "waves"])
def test_total_dm_matches_jax(name):
    jm, jp, tm, tp = zoo_pair(name, n_epochs=10)
    a = jm.total_dm(jp.toas)
    b = tm.total_dm(tp.toas, device="cpu")
    assert np.abs(b - a).max() <= 1e-12 * np.abs(a).max()


def test_d_phase_d_toa_matches_jax():
    """The central-difference spin frequency through every delay of a
    binary + DMX model (TOAs re-barycentred by each package's own
    chain after the shift)."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs as tmake

    par = BASE + CASES["tcb"].replace("UNITS TCB\n", "")
    mjds = np.linspace(54100, 56900, 16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jax_model(par)
        jt = make_fake_toas_fromMJDs(mjds, jm, freq_mhz=1400.0, obs="gbt",
                                     iterations=0)
        tm = get_model(par)
        tt = tmake(mjds, tm, freq_mhz=1400.0, obs="gbt", iterations=0,
                   device="cpu")
        fj = jm.d_phase_d_toa(jt)
        ft = tm.d_phase_d_toa(tt, device="cpu")
    assert np.abs(ft - fj).max() <= 1e-9


def test_tcb_conversion_matches_jax():
    """convert_tcb_tdb both ways gives the JAX package's values
    bitwise, and backwards undoes forwards; allow_tcb False raises,
    "raw" keeps the TCB values."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.models.tcb_conversion import convert_tcb_tdb as jconv
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.tcb_conversion import convert_tcb_tdb

    par = BASE + CASES["tcb"] + "F2 1e-27\nGLEP_1 55000\nGLF0_1 1e-7\n"
    for get in (get_model, jax_model):
        with pytest.raises(ValueError, match="TCB"):
            get(par)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        raw, jraw = get_model(par, allow_tcb="raw"), jax_model(par, allow_tcb="raw")
        conv = get_model(par, allow_tcb=True)
    assert raw.UNITS.value == "TCB" and conv.UNITS.value == "TDB"
    for back in (False, True):
        m = copy.deepcopy(raw if not back else conv)
        jm = copy.deepcopy(jraw)
        if back:
            jconv(jm)
        convert_tcb_tdb(m, backwards=back)
        jconv(jm, backwards=back)
        assert m.UNITS.value == jm.UNITS.value
        for p in m.params:
            assert getattr(m, p).value == getattr(jm, p).value, p
    m = copy.deepcopy(raw)
    convert_tcb_tdb(m)
    convert_tcb_tdb(m, backwards=True)
    for p in ("F0", "F1", "PB", "A1", "DMX_0001", "PEPOCH", "TASC"):
        assert getattr(m, p).value == pytest.approx(getattr(raw, p).value,
                                                    rel=1e-15), p
    for p in raw.params:
        assert getattr(conv, p).value == getattr(
            get_model(conv.as_parfile()), p).value, p


def test_jump_flags_to_params_matches_jax():
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.models.jump import jump_flags_to_params as jflags
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.jump import jump_flags_to_params

    jm, jp, tm, tp = zoo_pair("fdjump_linear", n_epochs=8)
    jt, tt = jp.toas, tp.toas
    for i, (fj, ft) in enumerate(zip(jt.flags, tt.flags)):
        if i % 3:
            fj["tim_jump"] = ft["tim_jump"] = str(1 + i % 2)
    jm, tm = jax_model(BASE), get_model(BASE)
    assert jump_flags_to_params(tt, tm) == jflags(jt, jm)
    assert jump_flags_to_params(tt, tm) == jflags(jt, jm) == []
    tp2, jp2 = tm.prepare(tt, device="cpu"), jm.prepare(jt)
    np.testing.assert_array_equal(tp2.prep["jump_masks"],
                                  np.asarray(jp2.prep["jump_masks"]))
    assert tm.free_params == jm.free_params


def test_delay_jump_matches_jax():
    """DelayJump (built programmatically; no par spelling selects it)."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu.models.jump import DelayJump as JDelayJump
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.models.jump import DelayJump

    jm0, jp0, _, tp0 = zoo_pair("fdjump_linear", n_epochs=8)
    jm, tm = jax_model(BASE), get_model(BASE)
    for m, cls in ((jm, JDelayJump), (tm, DelayJump)):
        c = cls()
        m.add_component(c)
        c.add_jump(key="-fe", key_value=["Rcvr_800"], value=3e-6)
        c.add_jump(key="mjd", key_value=["55000", "56000"], value=-1e-6,
                   frozen=True)
    gaps = compare_prepared(jm, jm.prepare(jp0.toas), tm,
                            tm.prepare(tp0.toas, device="cpu"))
    for check, (gap, tier) in gaps.items():
        assert gap <= tier, check


def _corpus():
    return json.loads(CORPUS.read_text())


@pytest.mark.parametrize("index", range(len(_corpus())))
def test_corpus_par_builds_like_jax(index):
    """Each par file the JAX package's zoo tests load builds in the
    port with the same components, parameters, values and fit flags, or
    raises the same exception class; and reads back from as_parfile."""
    from pint_tpu.models import get_model as jax_model
    from pint_tpu_torch.models import get_model

    e = _corpus()[index]
    kw = {"allow_tcb": e["allow_tcb"]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            jm, jerr = jax_model(e["par"], **kw), None
        except Exception as exc:  # noqa: BLE001 - compared below
            jm, jerr = None, type(exc).__name__
        if jerr is not None:
            with pytest.raises(Exception) as et:
                get_model(e["par"], **kw)
            assert type(et.value).__name__ == jerr
            return
        tm = get_model(e["par"], **kw)
        back = get_model(tm.as_parfile())
    assert list(tm.components) == list(jm.components)
    assert tm.params == jm.params and tm.free_params == jm.free_params
    for p in jm.params:
        a, b = getattr(jm, p), getattr(tm, p)
        assert a.value == b.value and a.frozen == b.frozen, p
        assert getattr(back, p).value == b.value, p


def test_corpus_covers_every_component():
    """The corpus plus this file's cases reach every component class
    the port's builder can choose."""
    from pint_tpu_torch.models import get_model

    seen = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for e in _corpus():
            try:
                seen |= set(get_model(e["par"], allow_tcb=e["allow_tcb"]).components)
            except Exception:  # noqa: BLE001 - the corpus has bad pars too
                pass
        for name, extra in CASES.items():
            seen |= set(get_model(BASE + extra, allow_tcb=True).components)
    want = {"DispersionDMX", "DispersionJump", "PhaseJump", "FD", "FDJump",
            "PhaseOffset", "Glitch", "PiecewiseSpindown", "IFunc", "Wave",
            "WaveX", "DMWaveX", "ChromaticCM", "ChromaticCMX", "CMWaveX",
            "PLDMNoise", "PLChromNoise", "PLSWNoise", "SolarWindDispersionX",
            "BinaryELL1", "BinaryELL1H", "BinaryDD", "BinaryBT"}
    assert want <= seen, want - seen


# ---- the b1855sim golden pack ----

def _drop_correlated(m):
    for name in ("EcorrNoise", "PLRedNoise"):
        m.remove_component(name)
    return m


B1855_FITTERS = (("GLSFitter", "GLSFitter", {"maxiter": 2}, False),
                 ("GLSFitter_mixed", "GLSFitter",
                  {"maxiter": 2, "precision": "mixed"}, False),
                 ("DownhillGLSFitter", "DownhillGLSFitter", {}, False),
                 ("WLSFitter_white", "WLSFitter", {}, True))


def b1855_fixture():
    """The JAX package's fits of the b1855sim pack on the CPU, numpy
    host path: chi2, chi2_whitened, values, uncertainties. WLSFitter
    runs on the model without its ECORR and red noise (both packages
    refuse correlated noise in a WLS fit)."""
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
            out = {"source": "pint_tpu (the JAX package) on the CPU, numpy "
                             "host path: get_model_and_toas on "
                             "b1855sim.par/.tim, then each fitter's "
                             "fit_toas(**kwargs) (WLSFitter_white: EcorrNoise "
                             "and PLRedNoise removed first); written by "
                             "tests/test_torch_zoo.py",
                   "fitters": {}}
            for key, cls, kw, white in B1855_FITTERS:
                m, t = pint_tpu.get_model_and_toas(str(B1855_PAR),
                                                   str(B1855_TIM))
                if white:
                    _drop_correlated(m)
                f = getattr(jf, cls)(t, m)
                chi2 = f.fit_toas(**kw)
                out["fitters"][key] = {
                    "class": cls, "kwargs": kw, "white": white,
                    "chi2": float(chi2),
                    "chi2_whitened": (float(f.chi2_whitened)
                                      if hasattr(f, "chi2_whitened") else None),
                    "values": {p: float(getattr(f.model, p).value)
                               for p in f.model.free_params},
                    "uncertainties": {p: getattr(f.model, p).uncertainty
                                      for p in f.model.free_params}}
    finally:
        jnative._LIB = saved
    return out


@pytest.fixture(scope="module")
def b1855():
    """The pack through the port's numpy host path, the fixture's."""
    from pint_tpu_torch import native
    from pint_tpu_torch.models import get_model_and_toas

    saved = native._LIB
    native._LIB = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return get_model_and_toas(str(B1855_PAR), str(B1855_TIM),
                                      usepickle=False)
    finally:
        native._LIB = saved


def test_b1855sim_golden_residuals(b1855):
    from pint_tpu_torch.residuals import Residuals

    m, t = b1855
    assert len(t) == 300
    assert list(m.components) == [
        "Spindown", "AstrometryEquatorial", "DispersionDM", "DispersionDMX",
        "SolarSystemShapiro", "BinaryELL1H", "ScaleToaError", "EcorrNoise",
        "PLRedNoise"]
    golden = np.load(EXAMPLES / "b1855sim_prefit_resids_us.npy")
    r = Residuals(t, m, device="cpu")
    resid_us = r.calc_time_resids().numpy() * 1e6
    assert np.abs(resid_us - golden).max() <= 1e-3
    assert abs(r.rms_weighted() * 1e6 - 1.044006) < 1e-4


@pytest.mark.parametrize("key,cls,kw,white", B1855_FITTERS)
def test_b1855sim_fits_match_fixture(b1855, key, cls, kw, white):
    import pint_tpu_torch.fitter as tf

    fx = json.loads(B1855_POSTFIT.read_text())["fitters"][key]
    m, t = b1855
    m = copy.deepcopy(m)
    if white:
        with pytest.raises(tf.CorrelatedErrors):
            tf.WLSFitter(t, m, device="cpu").fit_toas()
        _drop_correlated(m)
    f = getattr(tf, cls)(t, m, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chi2 = f.fit_toas(**kw)
    if key == "GLSFitter":
        assert abs(f.chi2_whitened - 207.511488) < 0.01
    assert abs(chi2 - fx["chi2"]) <= TOL_CHI2 * fx["chi2"]
    assert f.model.free_params == list(fx["values"])
    for p, v in fx["values"].items():
        unc = fx["uncertainties"][p]
        assert abs(getattr(f.model, p).value - v) <= 1e-6 * unc, p
        tol = TOL_MIXED_UNC if kw.get("precision") == "mixed" else 1e-5
        assert abs(getattr(f.model, p).uncertainty - unc) <= tol * unc, p


def test_b1855sim_fixture_regenerates():
    assert b1855_fixture() == json.loads(B1855_POSTFIT.read_text())


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_case_on_card_matches_cpu(name):
    """Each zoo case's delay, phase and design matrix on the card
    against the port on the CPU (the phase tier; columns 1e-9 of
    max|col|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    kw = {"allow_tcb": True} if name == "tcb" else {}
    m = get_model(BASE + CASES[name], **kw)
    mjds = np.linspace(54000, 57000, 64)
    freqs = np.where(np.arange(64) % 2, 1400.0, 800.0)
    t = make_fake_toas_fromMJDs(mjds, m, freq_mhz=freqs, device="cpu")
    for f, nu in zip(t.flags, freqs):
        f["f"] = "L-wide"
        f["fe"] = "Rcvr_800" if nu < 1000 else "Rcvr1_2"
    pc, pg = m.prepare(t, device="cpu"), m.prepare(t, device="cuda")
    assert (pg.delay().cpu() - pc.delay()).abs().max() <= 1e-12
    assert (pg.phase_frac_and_int()[0].cpu()
            - pc.phase_frac_and_int()[0]).abs().max() <= 1e-9
    Mc, _ = pc.designmatrix()
    Mg, _ = pg.designmatrix()
    scale = Mc.abs().amax(0).clamp(min=1e-300)
    assert ((Mg.cpu() - Mc).abs().amax(0) / scale).max() <= 1e-9


def main():
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:] == ["--corpus"]:
        record_corpus()
    else:
        B1855_POSTFIT.write_text(json.dumps(b1855_fixture(), indent=1) + "\n")


def record_corpus():
    """Rewrite tests/torch_zoo_pars.json: run the JAX package's zoo
    tests with its get_model recording every par file (deduplicated,
    in first-seen order)."""
    import os

    import pint_tpu.models as pm
    import pint_tpu.models.builder as pb

    class Recorder:
        pars = []

        def pytest_collection_finish(self, session):
            orig = pb.get_model

            def get_model(parfile, *a, **kw):
                text = parfile
                if (isinstance(parfile, (str, os.PathLike))
                        and "\n" not in str(parfile)
                        and os.path.exists(parfile)):
                    text = Path(parfile).read_text()
                self.pars.append({"par": str(text),
                                  "allow_tcb": kw.get("allow_tcb", False)})
                return orig(parfile, *a, **kw)

            pb.get_model = pm.get_model = get_model
            for item in session.items:
                if getattr(item.module, "get_model", None) is orig:
                    item.module.get_model = get_model

    rec = Recorder()
    pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                 *ZOO_TESTS], plugins=[rec])
    seen, out = set(), []
    for e in rec.pars:
        key = (e["par"], str(e["allow_tcb"]))
        if key not in seen:
            seen.add(key)
            out.append(e)
    CORPUS.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
