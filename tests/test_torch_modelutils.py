"""The port's modelutils (equatorial <-> ecliptic astrometry) against the
JAX package's, on the CPU, and photonphase --weightcol CALC with an
ecliptic par file.

Tolerances: positions 1e-15 rad, proper motions and uncertainties 1e-12
relative (host numpy in both packages: in practice bitwise); the round
trips to 1e-12 rad, and proper motions to 1e-7 relative: the Jacobian
is a one-sided difference of step 1e-8 rad, whose O(h) error (1.8e-9
per round trip here) the JAX package's conversion shares; CALC's H to
1e-9 relative of the JAX package's.
"""

import contextlib
import io

import numpy as np
import pytest

EQ_PAR = """PSR MUTEST
RAJ 10:00:00.0 1 0.001
DECJ 15:00:00.0 1 0.01
PMRA 5.0 1 0.1
PMDEC -3.0 1 0.2
PX 1.0 1 0.3
POSEPOCH 56700
F0 29.946923 1
F1 -3.77e-10 1
PEPOCH 56700
DM 0.0
"""
ECL_PAR = """PSR MUTEST
ELONG 140.5 1 1e-6
ELAT -2.25 1 2e-6
PMELONG 4.0 1 0.05
PMELAT -7.0 1 0.07
PX 0.5
POSEPOCH 56700
ECL IERS2010
F0 29.946923 1
F1 -3.77e-10 1
PEPOCH 56700
DM 0.0
"""
PARAMS = {"eq2ecl": ("ELONG", "ELAT", "PMELONG", "PMELAT", "PX"),
          "ecl2eq": ("RAJ", "DECJ", "PMRA", "PMDEC", "PX")}


def _convert(direction, pkg):
    if pkg == "jax":
        from pint_tpu.models import get_model
        from pint_tpu import modelutils as mu
    else:
        from pint_tpu_torch.models import get_model
        from pint_tpu_torch import modelutils as mu
    if direction == "eq2ecl":
        return mu.model_equatorial_to_ecliptic(get_model(EQ_PAR))
    return mu.model_ecliptic_to_equatorial(get_model(ECL_PAR))


@pytest.mark.parametrize("direction", ["eq2ecl", "ecl2eq"])
def test_conversion_matches_jax(direction):
    t, j = _convert(direction, "torch"), _convert(direction, "jax")
    for name in PARAMS[direction]:
        a, b = getattr(t, name), getattr(j, name)
        tol = 1e-15 if name in ("ELONG", "ELAT", "RAJ", "DECJ") else 0.0
        assert abs(a.value - b.value) <= tol + 1e-12 * abs(b.value), name
        assert (a.uncertainty is None) == (b.uncertainty is None), name
        if b.uncertainty is not None:
            assert a.uncertainty == pytest.approx(b.uncertainty, rel=1e-12,
                                                  abs=0.0), name
        assert a.frozen == b.frozen, name
    assert set(t.components) == set(j.components)


def test_round_trips_hold():
    from pint_tpu_torch import modelutils as mu
    from pint_tpu_torch.models import get_model

    eq = get_model(EQ_PAR)
    back = mu.model_ecliptic_to_equatorial(
        mu.model_equatorial_to_ecliptic(eq))
    assert abs(back.RAJ.value - eq.RAJ.value) <= 1e-12
    assert abs(back.DECJ.value - eq.DECJ.value) <= 1e-12
    for name in ("PMRA", "PMDEC"):
        assert getattr(back, name).value == pytest.approx(
            getattr(eq, name).value, rel=1e-7)
    ecl = get_model(ECL_PAR)
    back = mu.model_equatorial_to_ecliptic(
        mu.model_ecliptic_to_equatorial(ecl), ecl="IERS2010")
    assert abs(back.ELONG.value - ecl.ELONG.value) <= 1e-12
    assert abs(back.ELAT.value - ecl.ELAT.value) <= 1e-12
    with pytest.raises(ValueError, match="AstrometryEquatorial"):
        mu.model_equatorial_to_ecliptic(ecl)
    with pytest.raises(ValueError, match="AstrometryEcliptic"):
        mu.model_ecliptic_to_equatorial(eq)


def _fermi_events(path, n=20_000, seed=6):
    """A barycentred FT1 file (TIMESYS TDB; TIME, RA, DEC, ENERGY)
    around the ecliptic par's position."""
    from pint_tpu_torch.io.fits import write_fits_table

    rng = np.random.default_rng(seed)
    ref = 51910.00074287037
    met = np.sort(rng.uniform(0, 86400.0, n) + (56700 - ref) * 86400)
    eq = _convert("ecl2eq", "torch")
    ra0, dec0 = np.degrees(eq.RAJ.value), np.degrees(eq.DECJ.value)
    write_fits_table(path, {
        "TIME": met, "RA": ra0 + rng.normal(0, 1.5, n),
        "DEC": dec0 + rng.normal(0, 1.5, n),
        "ENERGY": 10 ** rng.uniform(2, 5, n)},
        {"MJDREFI": int(ref), "MJDREFF": ref - int(ref), "TIMESYS": "TDB",
         "TELESCOP": "GLAST"}, extname="EVENTS")


def test_photonphase_calc_with_ecliptic_par_matches_jax(tmp_path):
    """photonphase --weightcol CALC with an ecliptic par file: the
    weights about the converted position and the H-test agree with the
    JAX script's run (H to 1e-9 relative, the printed line equal)."""
    from pint_tpu.event_toas import load_Fermi_TOAs as jload
    from pint_tpu.eventstats import hmw
    from pint_tpu.io.fits import get_table as jget_table
    from pint_tpu.scripts.photonphase import main as jmain
    from pint_tpu_torch.scripts.photonphase import main as tmain

    evt = tmp_path / "ft1.fits"
    _fermi_events(evt)
    par = tmp_path / "ecl.par"
    par.write_text(ECL_PAR)
    args = [str(evt), str(par), "--weightcol", "CALC"]
    outs = {}
    for name, main, extra in (("jax", jmain, []),
                              ("torch", tmain, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(args + extra + ["--outfile",
                                      str(tmp_path / f"{name}.fits")])
        assert rc == 0
        outs[name] = buf.getvalue()
    jeq = _convert("ecl2eq", "jax")
    jw = np.asarray(jload(str(evt), weightcolumn="CALC", targetcoord=(
        np.degrees(jeq.RAJ.value), np.degrees(jeq.DECJ.value))).weights)
    jph = jget_table(tmp_path / "jax.fits", "EVENTS")[1]["PULSE_PHASE"]
    h_j = float(hmw(jph, jw))
    h_t = float(next(line.split("=", 1)[1]
                     for line in outs["torch"].splitlines()
                     if line.startswith("H = ")))
    assert abs(h_t - h_j) <= 1e-9 * h_j
    jline = next(s for s in outs["jax"].splitlines() if s.startswith("Htest"))
    assert jline in outs["torch"].splitlines()
