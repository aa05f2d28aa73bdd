"""The port's ``binaryconvert.convert_binary`` against the JAX package's,
on the CPU: every conversion the JAX package's tests make
(tests/test_breadth.py, tests/test_binary_variants.py) and the ones
``chip_smoke.py``'s ``[apps]`` phase makes, as cases of one test.

For each case both packages convert the same source par file. The
converted models' parameters (value, uncertainty, fit flag of every
parameter) agree at 1e-12 relative, and their residuals on the same
TOAs (the JAX package's fake TOAs of the source model, handed to the
port barycentred) agree at 1e-12 s.
"""

import warnings

import numpy as np
import pytest

warnings.simplefilter("ignore")

TOL_PAR = 1e-12  # relative
TOL_RESID_S = 1e-12
N_TOA = 40  # one TOA count throughout: the JAX package compiles per shape

BASE = """
PSR TESTBR
RAJ 06:30:49.4
DECJ -28:34:42.7
F0 301.5 1
F1 -7e-16 1
PEPOCH 55100
DM 22.0 1
"""
_E, _OM = 1e-5, np.deg2rad(37.0)
ELL1 = BASE + ("BINARY ELL1\nPB 2.5 1\nA1 4.2 1\nTASC 55101.0 1\n"
               f"EPS1 {_E * np.sin(_OM):.15e} 1\n"
               f"EPS2 {_E * np.cos(_OM):.15e} 1\n")
DD = BASE + ("BINARY DD\nPB 3.1 1\nA1 6.0 1\nT0 55100.0 1\n"
             "ECC 1e-4 1\nOM 45.0 1\nM2 0.3\nSINI 0.95\n")
ELL1_SHAPIRO = BASE + ("BINARY ELL1\nPB 1.8 1\nA1 3.0 1\nTASC 55101.0 1\n"
                       "EPS1 1e-6 1\nEPS2 -2e-6 1\nM2 0.25\nSINI 0.9\n")
DD_CONV = ("PSR TCONV\nRAJ 10:00:00\nDECJ 20:00:00\nF0 150.0 1\n"
           "PEPOCH 55300\nDM 5.0\nBINARY DD\nPB 8.0\nA1 12.0\nT0 55300\n"
           "ECC 0.12\nOM 45.0\nM2 0.35 1\nSINI 0.92 1\n")
_ST = 0.92 / (1 + np.sqrt(1 - 0.92**2))
DDH = ("PSR TC2\nRAJ 10:00:00\nDECJ 20:00:00\nF0 150.0 1\n"
       "PEPOCH 55300\nDM 5.0\nBINARY DDH\nPB 8.0\nA1 12.0\nT0 55300\n"
       f"ECC 0.12\nOM 45.0\nH3 {4.925490947e-6 * 0.35 * _ST**3} 1\n"
       f"STIGMA {_ST} 1\n")
ELL1H = BASE + ("BINARY ELL1H\nPB 12.32717 1\nA1 9.230780 1\n"
                "TASC 55101.0 1\nEPS1 -2.15e-5 1\nEPS2 -3.1e-6 1\n"
                "H3 2.7e-7\nSTIGMA 0.72\n")
# source uncertainties the JAX tests set before converting
UNC = {"ELL1": {"EPS1": 1e-8, "EPS2": 1e-8}, "DD": {"SINI": 0.01}}
SOURCES = {"ELL1": ELL1, "DD": DD, "ELL1_SHAPIRO": ELL1_SHAPIRO,
           "DD_CONV": DD_CONV, "DDH": DDH, "ELL1H": ELL1H}
CASES = [
    ("ELL1", ("DD",)), ("ELL1", ("DD", "ELL1")),
    ("DD", ("DDS",)), ("DD", ("DDS", "DD")),
    ("ELL1_SHAPIRO", ("ELL1H",)), ("ELL1_SHAPIRO", ("ELL1H", "ELL1")),
    ("DD_CONV", ("DDH",)), ("DD_CONV", ("DDH", "DD")),
    ("DDH", ("DDS",)),
    ("ELL1H", ("ELL1",)), ("ELL1H", ("DD",)), ("DD_CONV", ("BT",)),
]


def _source(mod, name):
    m = mod.get_model(SOURCES[name])
    for p, u in UNC.get(name, {}).items():
        getattr(m, p).uncertainty = u
    return m


_TOAS = {}


def _toas(name):
    """The JAX package's fake TOAs of source ``name`` (cached per source:
    one set of TOAs for every case of a source)."""
    if name not in _TOAS:
        from pint_tpu import models as jmodels
        from pint_tpu.simulation import make_fake_toas_fromMJDs
        from test_torch_pta import port_toas

        t0 = float(_source(jmodels, name).PEPOCH.value)
        jt = make_fake_toas_fromMJDs(
            np.linspace(t0 - 50, t0 + 50, N_TOA), _source(jmodels, name),
            error_us=1.0, freq_mhz=1400.0, obs="gbt", add_noise=False)
        _TOAS[name] = (jt, port_toas(jt))
    return _TOAS[name]


def _same(a, b, tol):
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= tol * abs(a)
    return a == b


@pytest.mark.parametrize("source,chain", CASES,
                         ids=[f"{s}-{'-'.join(c)}" for s, c in CASES])
def test_convert_binary_matches_jax(source, chain):
    from pint_tpu import models as jmodels
    from pint_tpu.binaryconvert import convert_binary as jconvert
    from pint_tpu.residuals import Residuals as JResiduals
    from pint_tpu_torch import models
    from pint_tpu_torch.binaryconvert import convert_binary
    from pint_tpu_torch.residuals import Residuals

    m, jm = _source(models, source), _source(jmodels, source)
    for out in chain:
        m, jm = convert_binary(m, out), jconvert(jm, out)
    assert list(m.components) == list(jm.components)
    assert f"Binary{chain[-1]}" in m.components
    assert set(m.params) == set(jm.params)
    for p in jm.params:
        a, b = getattr(jm, p), getattr(m, p)
        for attr in ("value", "uncertainty", "frozen"):
            va, vb = getattr(a, attr, None), getattr(b, attr, None)
            if isinstance(va, (float, np.floating)) and vb is not None:
                va, vb = float(va), float(vb)
            assert _same(va, vb, TOL_PAR), (p, attr, va, vb)
    jt, t = _toas(source)
    r = Residuals(t, m, device="cpu").calc_time_resids().numpy()
    jr = np.asarray(JResiduals(jt, jm).calc_time_resids())
    assert np.max(np.abs(r - jr)) <= TOL_RESID_S
