"""The port's utils.py (now whole), the P0/P1/P2 builder, the tempo and
tempo2 par spellings, config.py and logging_setup.py against the JAX
package's, on the CPU.

Tolerances: host numpy code copied from the JAX package is held bitwise
(dmx_ranges, dmxparse and its file, p_to_f/pferrs, ELL1_check, the
WaveX helpers, list_parameters, the P0/P1/P2 conversion); the torch
taylor_horner to 1e-15 relative (the same Horner steps in f64); the
information criteria to 1e-9 relative (a white-noise lnlikelihood over
residuals that differ by one-ulp phase differences, ~1e-13 s, against
the ~1e-9-relative chi2 gap of tests/test_torch_fitter.py).

The tempo/tempo2 spellings run over the 170-par corpus
(tests/torch_zoo_pars.json): the port's text and the JAX package's
carry the same keys in the same order, the MODE 1 header (tempo) and a
UNITS line; each package's get_model reads the other's text back to the
values of the model that wrote it. The texts themselves differ where
ROADMAP §3 says the port writes differently (16 decimals of an MJD
epoch against 11, a free pair parameter's fit flag, angle
uncertainties), so values are compared as read back: exactly, but an
epoch the JAX package wrote to 4.32e-7 s (half its last digit) and an
angle to one tick of its 10 decimals of a sexagesimal second.
"""

import io
import json
import logging
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CORPUS = Path(__file__).resolve().parent / "torch_zoo_pars.json"

BASE = ("PSR TESTU\nRAJ 16:00:51.9\nDECJ -30:53:49.3\nF0 277.94 1\n"
        "F1 -7.3e-16 1\nPEPOCH 55300\nDM 52.33 1\n")
DMX = "".join(f"DMX_{k:04d} {1e-3 * (k - 2)} 1\nDMXR1_{k:04d} "
              f"{54000 + 1000 * (k - 1)}\nDMXR2_{k:04d} "
              f"{54999.9 + 1000 * (k - 1)}\n" for k in (1, 2, 3))


def _models(par, **kw):
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.models import get_model

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jget(par, **kw), get_model(par, **kw)


def test_taylor_horner_matches_jax():
    from pint_tpu import utils as ju
    from pint_tpu_torch import utils as tu

    rng = np.random.default_rng(1)
    dt = rng.uniform(-3e8, 3e8, 50)
    coeffs = [0.3, 277.94, -7.3e-16, 1e-26, -2e-35]
    for fn, kw in (("taylor_horner", {}), ("taylor_horner_deriv", {}),
                   ("taylor_horner_deriv", {"deriv_order": 3}),
                   ("taylor_horner_deriv", {"deriv_order": 7})):
        a = np.asarray(getattr(ju, fn)(dt, coeffs, **kw))
        b = getattr(tu, fn)(torch.as_tensor(dt), coeffs, **kw)
        assert isinstance(b, torch.Tensor)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-15, atol=0)


def test_period_helpers_and_ell1_check_match_jax():
    from pint_tpu import utils as ju
    from pint_tpu_torch import utils as tu

    assert tu.p_to_f(0.0016) == ju.p_to_f(0.0016)
    assert tu.p_to_f(0.0016, 1e-20) == ju.p_to_f(0.0016, 1e-20)
    assert tu.p_to_f(0.0016, 1e-20, 1e-31) == ju.p_to_f(0.0016, 1e-20, 1e-31)
    assert tu.pferrs(0.0016, 1e-14) == ju.pferrs(0.0016, 1e-14)
    assert tu.pferrs(0.0016, 1e-14, 1e-20, 1e-24) == \
        ju.pferrs(0.0016, 1e-14, 1e-20, 1e-24)
    for args in ((1.9, 1e-7, 0.5, 5000), (30.0, 0.01, 1.0, 100)):
        assert tu.ELL1_check(*args) == ju.ELL1_check(*args)
        assert tu.ELL1_check(*args, outstring=False) == \
            ju.ELL1_check(*args, outstring=False)


def test_dmx_ranges_and_dmxparse_match_jax(tmp_path):
    """dmx_ranges on the same TOAs; dmxparse on a fitted-like model
    (values and uncertainties set) with its dmxparse.out file."""
    from pint_tpu import utils as ju
    from pint_tpu_torch import utils as tu
    from test_torch_binary import jax_pair

    jm, jp, tm, tp = jax_pair(BASE + "DMX 14.0\n" + DMX, n_epochs=30, seed=2)
    for width in (6.5, 40.0, 400.0):
        assert tu.dmx_ranges(tp.toas, width) == ju.dmx_ranges(jp.toas, width)
    for m in (jm, tm):
        for k, u in ((1, 2e-5), (2, None), (3, 4e-5)):
            getattr(m, f"DMX_{k:04d}").uncertainty = u

    class Fit:
        def __init__(self, model):
            self.model = model

    a = ju.dmxparse(Fit(jm), save=str(tmp_path / "j.out"))
    b = tu.dmxparse(Fit(tm), save=str(tmp_path / "t.out"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    assert (tmp_path / "t.out").read_text() == (tmp_path / "j.out").read_text()
    with pytest.raises(ValueError, match="no DispersionDMX"):
        tu.dmxparse(Fit(_models(BASE)[1]))


WAVE = "WAVE_OM 0.01 1\nWAVEEPOCH 55000\nWAVE1 1e-5 -2e-5\nWAVE2 3e-6 1e-6\n"
WAVEX = ("WXEPOCH 55300\n" + "".join(
    f"WXFREQ_{k:04d} {0.002 * k}\nWXSIN_{k:04d} {1e-6 / k} 1\n"
    f"WXCOS_{k:04d} {-2e-6 / k ** 1.5} 1\n" for k in (1, 2, 3, 4)))


def _same_params(jm, tm):
    assert list(tm.components) == list(jm.components)
    assert tm.params == jm.params and tm.free_params == jm.free_params
    for p in jm.params:
        a, b = getattr(jm, p), getattr(tm, p)
        assert a.value == b.value and a.frozen == b.frozen, p


def test_wavex_helpers_match_jax():
    """wavex/dmwavex/cmwavex_setup, translate_wave_to_wavex and back,
    get_wavex_freqs/amps, plrednoise_to_wavex and wavex_to_plrednoise:
    the same components, parameters and values."""
    from pint_tpu import utils as ju
    from pint_tpu_torch import utils as tu

    for fn, args, kw in (("wavex_setup", (1200.0,), {"n_freqs": 3}),
                         ("dmwavex_setup", (1200.0,), {"freqs": [0.001, 0.003]}),
                         ("cmwavex_setup", (900.0,), {"n_freqs": 2})):
        jm, tm = _models(BASE)
        assert getattr(tu, fn)(tm, *args, **kw) == \
            getattr(ju, fn)(jm, *args, **kw)
        _same_params(jm, tm)
    jm, tm = _models(BASE + WAVE)
    ju.translate_wave_to_wavex(jm)
    tu.translate_wave_to_wavex(tm)
    _same_params(jm, tm)
    assert tu.get_wavex_freqs(tm) == ju.get_wavex_freqs(jm)
    ju.translate_wavex_to_wave(jm)
    tu.translate_wavex_to_wave(tm)
    _same_params(jm, tm)
    jm, tm = _models(BASE + WAVEX)
    for a, b in zip(tu.get_wavex_amps(tm), ju.get_wavex_amps(jm)):
        np.testing.assert_array_equal(a, b)
    for m in (jm, tm):
        for k in (1, 2, 3, 4):
            getattr(m, f"WXSIN_{k:04d}").uncertainty = 1e-7
            getattr(m, f"WXCOS_{k:04d}").uncertainty = 2e-7
    ju.wavex_to_plrednoise(jm)
    tu.wavex_to_plrednoise(tm)
    _same_params(jm, tm)
    jm, tm = _models(BASE + "RNAMP 1e-14\nRNIDX -3.1\nTNREDC 6\n")
    ju.plrednoise_to_wavex(jm, t_span_days=1500.0)
    tu.plrednoise_to_wavex(tm, t_span_days=1500.0)
    _same_params(jm, tm)
    with pytest.raises(ValueError, match="already has a WaveX"):
        tu.plrednoise_to_wavex(_models(BASE + WAVEX + "RNAMP 1e-14\n"
                                       "RNIDX -3.1\n")[1], t_span_days=1.0)


def test_information_criteria_match_jax():
    """AIC and BIC over the white-noise likelihood (1e-9 relative), and
    the refusal of a model with correlated noise."""
    from pint_tpu import utils as ju
    from pint_tpu_torch import utils as tu
    from pint_tpu_torch.fitter import CorrelatedErrors
    from test_torch_binary import jax_pair

    jm, jp, tm, tp = jax_pair(BASE + "EFAC -f L-wide 1.2\n", n_epochs=20,
                              seed=6)
    for fn in ("akaike_information_criterion",
               "bayesian_information_criterion"):
        a = getattr(ju, fn)(jm, jp.toas)
        b = getattr(tu, fn)(tm, tp.toas, device="cpu")
        assert b == pytest.approx(a, rel=1e-9)
    _, tr = _models(BASE + "RNAMP 1e-14\nRNIDX -3.1\n")
    with pytest.raises(CorrelatedErrors):
        tu.akaike_information_criterion(tr, tp.toas, device="cpu")


def test_list_parameters_matches_jax():
    from pint_tpu import utils as ju
    from pint_tpu_torch import utils as tu

    a, b = ju.list_parameters(), tu.list_parameters()
    assert len(b) == len(a) > 250
    assert b == a


PERIOD_CASES = {
    "p0": "P0 0.006438 1\n",
    "p0_unc": "P0 0.00643812345678 1 2e-17\n",
    "p0_p1": "P0 0.006438 1 3e-15\nP1 1.2e-20 1 4e-24\n",
    "p0_p1_frozen": "P0 0.0128 0\nP1 3.3e-19 0\n",
    "p0_p2": "P0 0.5 1 1e-12\nP2 1e-30 1 2e-31\n",
    "p0_p1_p2": "P0 0.089 1 2e-13\nP1 1.2e-13 1 1e-18\nP2 -3e-26 0 1e-27\n",
}


@pytest.mark.parametrize("name", list(PERIOD_CASES))
def test_period_par_builds_like_jax(name):
    """tempo1 P0/P1/P2 spin parameters: F0/F1/F2 values, fit flags and
    uncertainties bitwise the JAX package's, with its warning. Where P0
    or P1 carries an uncertainty the JAX package's F1 line keeps none (numpy
    2 writes the propagated float as "np.float64(...)", which its
    reader refuses with a "bad par line" warning; ROADMAP §3): the
    port's F1 uncertainty is then bitwise that float, from the JAX
    package's pferrs."""
    from pint_tpu.models import get_model as jget
    from pint_tpu.utils import pferrs
    from pint_tpu_torch.models import get_model

    spin = PERIOD_CASES[name]
    par = BASE.replace("F0 277.94 1\nF1 -7.3e-16 1\n", spin)
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        tm = get_model(par)
    msgs = [str(w.message) for w in wl]
    assert any("converted P0/P1/P2" in m for m in msgs)
    assert not any("bad par line" in m for m in msgs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jget(par)
    assert tm.params == jm.params and tm.free_params == jm.free_params
    fields = {k: [float(v) for v in rest.split()]
              for k, rest in (ln.split(None, 1) for ln in spin.splitlines())}
    p0, _, *u0 = fields["P0"]
    p1, _, *u1 = fields.get("P1", [0.0, 0.0])
    for p in ("F0", "F1", "F2"):
        if p not in jm.params:
            continue
        a, b = getattr(jm, p), getattr(tm, p)
        assert (a.value, a.frozen) == (b.value, b.frozen), p
        if p == "F1" and (u0 or u1):
            assert a.uncertainty is None
            assert b.uncertainty == float(pferrs(p0, (u0 or [0.0])[0], p1,
                                                 (u1 or [0.0])[0])[3])
        else:
            assert a.uncertainty == b.uncertainty, p
    assert tm.F0.value == 1.0 / float(spin.split()[1])


def _corpus():
    return json.loads(CORPUS.read_text())


def _read_back_equal(ref, back, mjd_tol_s):
    """back (a model read from ref's text) carries ref's values: exact,
    MJD epochs to ``mjd_tol_s``, angles to one written tick."""
    assert [p for p in back.params if p not in ("MODE", "UNITS")] == \
        [p for p in ref.params if p not in ("MODE", "UNITS")]
    for p in ref.params:
        a, b = getattr(ref, p), getattr(back, p)
        assert a.frozen == b.frozen, p
        if a.value is None:
            assert b.value is None, p
        elif a.kind == "mjd":
            assert a.day == b.day and abs(a.sec - b.sec) <= mjd_tol_s, p
        elif a.kind == "angle":
            tick = 1e-10 / 3600 * np.pi / 180 * (
                15.0 if a.angle_unit == "hourangle" else 1.0)
            assert abs(a.value - b.value) <= tick, p
        else:
            assert a.value == b.value, p


@pytest.mark.parametrize("index", range(len(_corpus())))
def test_corpus_tempo_spellings_match_jax(index):
    """tempo and tempo2 as_parfile over each corpus par that builds:
    the same keys in the same order as the JAX package's text (the
    renames T2EFAC/VARSIGMA/LAMBDA/SOLARN0/..., MODE 1 first for tempo,
    a UNITS line), and each package's get_model reads the other's text
    back to the writer's values. A par file the JAX package refuses,
    the port refuses with the same exception class."""
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.models import get_model

    e = _corpus()[index]
    kw = {"allow_tcb": e["allow_tcb"]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            jm = jget(e["par"], **kw)
        except Exception as exc:  # noqa: BLE001 - compared below
            with pytest.raises(Exception) as et:
                get_model(e["par"], **kw)
            assert type(et.value).__name__ == type(exc).__name__
            return
        tm = get_model(e["par"], **kw)
        for fmt in ("tempo", "tempo2"):
            tt, jt = tm.as_parfile(format=fmt), jm.as_parfile(format=fmt)
            keys = [[ln.split()[0] for ln in x.splitlines()] for x in (tt, jt)]
            assert keys[0] == keys[1], fmt
            assert "UNITS" in keys[0]
            if fmt == "tempo":
                assert tt.splitlines()[0].split() == ["MODE", "1"]
                assert keys[0].count("MODE") == 1
            else:
                assert not {"EFAC", "EQUAD", "STIGMA", "ELONG"} & set(keys[0])
            _read_back_equal(tm, jget(tt), 4e-12)
            _read_back_equal(jm, get_model(jt), 4.32e-7)
    with pytest.raises(ValueError, match="unknown par file format"):
        tm.as_parfile(format="tempo3")


def test_config_and_logging_setup():
    """examplefile/runtimefile resolve in the port's own data directory;
    the logger dedups repeated warnings as the JAX package's does."""
    from pint_tpu import logging_setup as jlog
    from pint_tpu_torch import config, logging_setup

    path = config.examplefile("wb_sim.par")
    assert Path(path).is_file()
    assert Path(config.datadir()) == ROOT / "pint_tpu_torch" / "data"
    assert Path(config.runtimefile("observatories.json")).is_file()
    assert Path(config.runtimefile("leap-seconds.list")).parent == \
        Path(config.datadir())
    with pytest.raises(FileNotFoundError):
        config.examplefile("no_such.par")
    with pytest.raises(FileNotFoundError):
        config.runtimefile("no_such.dat")
    out = []
    for mod in (jlog, logging_setup):
        buf = io.StringIO()
        log = mod.setup(level="DEBUG", stream=buf)
        for _ in range(3):
            log.warning("clock file missing")
        log.info("fit done")
        log.info("fit done")
        mod.get_logger("fitter").error("bad step")
        out.append([ln.split(" ", 1)[1] for ln in buf.getvalue().splitlines()])
        log.handlers.clear()
    assert logging_setup.get_logger().name == "pint_tpu_torch"
    assert logging_setup.get_logger("x").name == "pint_tpu_torch.x"
    assert [ln.replace("pint_tpu_torch", "pint_tpu") for ln in out[1]] == out[0]
    assert len(out[1]) == 4
    assert logging.getLogger("pint_tpu_torch").propagate is False
