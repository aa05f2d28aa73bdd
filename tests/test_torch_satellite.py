"""The port's satellite observatories against the JAX package's, on the
CPU: the orbit-file observatory (observatory/satellite_obs.py), event
tables in the spacecraft frame and photonphase --orbfile; with them the
bound C++ SPK evaluation (native.cheby_posvel through io/spk.py) and
TOAs.print_summary / first_mjd / last_mjd.

Inputs are made with numpy from seeds (tests/test_events.py's analytic
orbit) and written as files both packages read.

Tolerances:
- orbit interpolation, posvel_ssb, the km/unsorted/out-of-span cases:
  bitwise (host numpy in both packages, and the Earth from the same
  numeph kernel);
- native.cheby_posvel against the port's numpy left fold: bitwise;
- photonphase --orbfile on 20,000 spacecraft-frame photons: PULSE_PHASE
  to 1e-9 cycles and H to 1e-9 relative (each package's own phase, the
  photon tier of test_torch_photon.py).
"""

import contextlib
import io

import numpy as np
import pytest

NICER_REF = 56658.000777592593
PAR = """
PSR TESTEV
RAJ 10:00:00.0
DECJ 15:00:00.0
F0 29.946923 1
F1 -3.77e-10 1
PEPOCH 56700
DM 0.0
"""
R_ORB, PERIOD = 6.98e6, 5700.0


@pytest.fixture(autouse=True)
def _restore_registries():
    """Registering a satellite observatory changes the process-wide
    observatory registry of each package; put both back after every
    test, so tests in the same process that expect "nicer" to be
    unknown (or barycentred-only) still find it so."""
    import pint_tpu.observatory as jobs
    import pint_tpu_torch.observatory as tobs

    saved = [(m, dict(m._registry), dict(m._alias_map))
             for m in (jobs, tobs)]
    yield
    for m, registry, aliases in saved:
        m._registry.clear()
        m._registry.update(registry)
        m._alias_map.clear()
        m._alias_map.update(aliases)


def _orbit(met):
    wt = 2 * np.pi / PERIOD
    ang = wt * met
    pos = np.stack([R_ORB * np.cos(ang), R_ORB * np.sin(ang),
                    np.zeros_like(ang)], axis=-1)
    vel = np.stack([-R_ORB * wt * np.sin(ang), R_ORB * wt * np.cos(ang),
                    np.zeros_like(ang)], axis=-1)
    return pos, vel


def _header(timesys="TT"):
    return {"MJDREFI": int(NICER_REF), "MJDREFF": NICER_REF - int(NICER_REF),
            "TIMESYS": timesys, "TELESCOP": "NICER"}


@pytest.fixture
def orbit_file(tmp_path):
    """tests/test_events.py's analytic circular orbit, sampled every
    30 s over one day from MJD 56700.5."""
    from pint_tpu_torch.io.fits import write_fits_table

    met = (np.arange(0.5 * 86400, 1.5 * 86400, 30.0)
           + (56700 - NICER_REF) * 86400)
    pos, vel = _orbit(met)
    path = tmp_path / "orb.fits"
    write_fits_table(path, {"TIME": met, "POSITION": pos, "VELOCITY": vel},
                     _header(), extname="ORBIT")
    return path, met


def _tt_epochs(met_q):
    day = np.full(met_q.shape, 56700, np.int64)
    sec = met_q - (56700 - NICER_REF) * 86400
    return day, sec


def test_orbit_interpolation_and_posvel_match_jax(orbit_file):
    from pint_tpu.mjd import Epochs as JEpochs
    from pint_tpu.observatory.satellite_obs import (
        get_satellite_observatory as jget)
    from pint_tpu.timescales import tt_to_tdb as jtt_to_tdb
    from pint_tpu_torch.mjd import Epochs
    from pint_tpu_torch.observatory import get_observatory
    from pint_tpu_torch.observatory.satellite_obs import (
        get_satellite_observatory)
    from pint_tpu_torch.timescales import tt_to_tdb

    path, met = orbit_file
    jo = jget("nicer", path)
    to = get_satellite_observatory("NICER", path)
    assert to.timescale == "tt" and get_observatory("nicer") is to
    np.testing.assert_array_equal(to.met_s, jo.met_s)
    np.testing.assert_array_equal(to.pos_m, jo.pos_m)
    rng = np.random.default_rng(0)
    met_q = met[0] + rng.uniform(10.0, 80000.0, 500)
    for a, b in zip(to._interp(met_q), jo._interp(met_q)):
        np.testing.assert_array_equal(a, b)
    day, sec = _tt_epochs(met_q)
    tdb = tt_to_tdb(Epochs(day, sec, "tt").normalized())
    jtdb = jtt_to_tdb(JEpochs(day, sec, "tt").normalized())
    np.testing.assert_array_equal(tdb.sec, jtdb.sec)
    pv = to.posvel_ssb(tdb, None, "de440s")
    jpv = jo.posvel_ssb(jtdb, None, "de440s")
    np.testing.assert_array_equal(pv.pos, jpv.pos)
    np.testing.assert_array_equal(pv.vel, jpv.vel)
    # and the interpolant tracks the analytic orbit (tests/test_events.py)
    p_ana, v_ana = _orbit(met_q)
    assert np.abs(to._interp(met_q)[0] - p_ana).max() < 1.0
    assert np.abs(to._interp(met_q)[1] - v_ana).max() < 1e-2


def test_spacecraft_event_toas_match_jax(orbit_file, tmp_path):
    """A TT event file tagged with the registered observatory packs
    through TDB and the orbit exactly as in the JAX package."""
    from pint_tpu.event_toas import load_event_TOAs as jload
    from pint_tpu.observatory.satellite_obs import (
        get_satellite_observatory as jget)
    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.io.fits import write_fits_table
    from pint_tpu_torch.observatory.satellite_obs import (
        get_satellite_observatory)

    path, met = orbit_file
    jget("nicer", path)
    get_satellite_observatory("nicer", path)
    evt = tmp_path / "evt_tt.fits"
    met_q = np.sort(met[0] + np.random.default_rng(1).uniform(
        10.0, 80000.0, 300))
    write_fits_table(evt, {"TIME": met_q}, _header())
    t, j = load_event_TOAs(evt, "nicer"), jload(evt, "nicer")
    for tt in (t, j):
        tt.apply_clock_corrections()
        tt.compute_TDBs()
        tt.compute_posvels()
    np.testing.assert_array_equal(t.tdb.sec, j.tdb.sec)
    np.testing.assert_array_equal(t.ssb_obs.pos, j.ssb_obs.pos)
    np.testing.assert_array_equal(t.obs_sun.pos, j.obs_sun.pos)


def test_km_orbit_normalized_like_jax(tmp_path):
    from pint_tpu.observatory.satellite_obs import SatelliteObs as JSat
    from pint_tpu_torch.io.fits import write_fits_table
    from pint_tpu_torch.observatory.satellite_obs import SatelliteObs

    met = np.arange(0, 86400, 60.0)
    ang = 2 * np.pi * met / PERIOD
    pos_km = np.stack([6980.0 * np.cos(ang), 6980.0 * np.sin(ang),
                       np.zeros_like(ang)], axis=-1)
    p = tmp_path / "orb_km.fits"
    write_fits_table(p, {"TIME": met, "POSITION": pos_km},
                     {"MJDREFI": int(NICER_REF),
                      "MJDREFF": NICER_REF - int(NICER_REF)}, extname="ORBIT")
    ob = SatelliteObs.from_orbit_file("nicer", p)
    jo = JSat.from_orbit_file("nicer", p)
    assert np.linalg.norm(ob.pos_m[0]) == pytest.approx(6980e3, rel=1e-12)
    np.testing.assert_array_equal(ob.pos_m, jo.pos_m)
    # no velocity column: the grid derivative, as in the JAX package
    np.testing.assert_array_equal(ob.vel_m_s, jo.vel_m_s)
    assert ob.mjdref == jo.mjdref


def test_unsorted_orbit_sorted_like_jax():
    from pint_tpu.observatory.satellite_obs import SatelliteObs as JSat
    from pint_tpu_torch.observatory.satellite_obs import SatelliteObs

    met = np.array([300.0, 100.0, 200.0, 0.0])
    pos = np.stack([met * 10, met * 0, met * 0], axis=-1) + 7e6
    ob, jo = SatelliteObs("nicer", met, pos), JSat("nicer", met, pos)
    assert (np.diff(ob.met_s) > 0).all()
    assert ob.pos_m[0, 0] == pytest.approx(7e6)
    np.testing.assert_array_equal(ob.pos_m, jo.pos_m)
    np.testing.assert_array_equal(ob.vel_m_s, jo.vel_m_s)


def test_out_of_span_raises_like_jax():
    from pint_tpu.mjd import Epochs as JEpochs
    from pint_tpu.observatory.satellite_obs import SatelliteObs as JSat
    from pint_tpu.timescales import tt_to_tdb as jtt_to_tdb
    from pint_tpu_torch.mjd import Epochs
    from pint_tpu_torch.observatory.satellite_obs import SatelliteObs
    from pint_tpu_torch.timescales import tt_to_tdb

    met = np.arange(0, 3600, 30.0)
    pos, _ = _orbit(met)
    ob = SatelliteObs("nicer", met, pos, mjdref=NICER_REF)
    jo = JSat("nicer", met, pos, mjdref=NICER_REF)
    day = np.array([int(NICER_REF) + 1], np.int64)
    with pytest.raises(ValueError, match="orbit") as te:
        ob.posvel_ssb(tt_to_tdb(Epochs(day, np.array([40000.0]), "tt")),
                      None, "de440s")
    with pytest.raises(ValueError, match="orbit") as je:
        jo.posvel_ssb(jtt_to_tdb(JEpochs(day, np.array([40000.0]), "tt")),
                      None, "de440s")
    assert str(te.value) == str(je.value)
    # one grid step of slack is tolerated at each end
    inside = np.array([met[-1] + 25.0])
    np.testing.assert_array_equal(ob._interp(inside)[0],
                                  jo._interp(inside)[0])


def _spacecraft_events(path, n=20_000, seed=4):
    """n photons over the orbit file's span with PSRPROB weights: times
    drawn as a pulse at phase 0.3 of the spindown in the spacecraft's
    frame (the barycentring then moves them)."""
    from pint_tpu_torch.io.fits import write_fits_table

    rng = np.random.default_rng(seed)
    f0 = 29.946923
    t0 = 0.5 * 86400 + 100.0
    pulse = rng.integers(0, int(0.9 * 86400 * f0), n)
    ph = (rng.vonmises(2 * np.pi * 0.3, 8.0, n) / (2 * np.pi)) % 1.0
    met = np.sort(t0 + (pulse + ph) / f0 + (56700 - NICER_REF) * 86400)
    write_fits_table(path, {"TIME": met, "PSRPROB": rng.random(n)},
                     _header())


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _h(text):
    return float(next(line.split(":", 1)[1].split()[0]
                      for line in text.splitlines()
                      if line.startswith("Htest")))


def test_photonphase_orbfile_matches_jax(orbit_file, tmp_path):
    """photonphase --orbfile on 20,000 spacecraft-frame photons: the
    same PULSE_PHASE (1e-9 cycles) and H (1e-9 relative) as the JAX
    script; the port prints H unrounded, the JAX script to 2 decimals,
    so H is held against the JAX package's hmw of its own phases."""
    from pint_tpu.eventstats import hmw
    from pint_tpu.io.fits import get_table as jget_table
    from pint_tpu.scripts.photonphase import main as jmain
    from pint_tpu_torch.io.fits import get_table
    from pint_tpu_torch.scripts.photonphase import main as tmain

    orb, _ = orbit_file
    evt = tmp_path / "sc.fits"
    _spacecraft_events(evt)
    par = tmp_path / "p.par"
    par.write_text(PAR)
    args = [str(evt), str(par), "--orbfile", str(orb), "--weightcol",
            "PSRPROB", "--absphase"]
    rc, jout = _run(jmain, args + ["--outfile", str(tmp_path / "j.fits")])
    assert rc == 0
    rc, tout = _run(tmain, args + ["--device", "cpu", "--outfile",
                                   str(tmp_path / "t.fits")])
    assert rc == 0
    j = jget_table(tmp_path / "j.fits", "EVENTS")[1]
    t = get_table(tmp_path / "t.fits", "EVENTS")[1]
    d = np.abs(t["PULSE_PHASE"] - j["PULSE_PHASE"])
    assert np.minimum(d, 1 - d).max() <= 1e-9
    h_j = float(hmw(j["PULSE_PHASE"], j["PSRPROB"]))
    h_t = float(next(line.split("=", 1)[1] for line in tout.splitlines()
                     if line.startswith("H = ")))
    assert abs(h_t - h_j) <= 1e-9 * h_j
    assert abs(_h(jout) - h_t) <= 0.005 + 1e-12 * h_t
    assert np.isfinite(h_t) and np.isfinite(t["PULSE_PHASE"]).all()


def test_cheby_posvel_native_is_the_left_fold():
    """The bound C++ Chebyshev evaluation is bitwise the port's numpy
    left fold on every body of the shipped kernel."""
    from pint_tpu_torch import native
    from pint_tpu_torch.ephemeris import objPosVel_wrt_SSB
    from pint_tpu_torch.mjd import Epochs

    if not native.loaded():
        pytest.skip("the C++ host library did not build here: "
                    f"{native.BUILD_ERROR[:200]}")
    rng = np.random.default_rng(2)
    t = Epochs(rng.integers(50000, 62000, 3000).astype(np.int64),
               rng.uniform(0, 86400, 3000), "tdb")
    for body in ("sun", "earth", "moon", "jupiter"):
        a = objPosVel_wrt_SSB(body, t, "de440s")
        saved = native._LIB
        native._LIB = False
        try:
            b = objPosVel_wrt_SSB(body, t, "de440s")
        finally:
            native._LIB = saved
        np.testing.assert_array_equal(a.pos, b.pos, err_msg=body)
        np.testing.assert_array_equal(a.vel, b.vel, err_msg=body)
    assert native.cheby_posvel(np.zeros(1), np.zeros((1, 70)), 33, 2) is None


@pytest.mark.parametrize("with_flags", [False, True])
def test_toas_summary_and_mjd_span_match_jax(with_flags, capsys):
    """TOAs.print_summary, first_mjd and last_mjd against the JAX
    package's on a two-observatory table."""
    from pint_tpu.toa import TOA as JTOA, TOAs as JTOAs
    from pint_tpu_torch.toa import TOA, TOAs

    rng = np.random.default_rng(3)
    day = rng.integers(55000, 56000, 40)
    sec = rng.uniform(0, 86400, 40)
    err = rng.uniform(0.5, 3.0, 40)
    obs = np.where(np.arange(40) % 3, "gbt", "ao")
    flags = [{"f": str(i)} if with_flags else {} for i in range(40)]
    t = TOAs([TOA(int(d), float(s), e, 1400.0, o, f)
              for d, s, e, o, f in zip(day, sec, err, obs, flags)])
    j = JTOAs([JTOA(int(d), float(s), e, 1400.0, o, f)
               for d, s, e, o, f in zip(day, sec, err, obs, flags)])
    assert t.first_mjd() == j.first_mjd()
    assert t.last_mjd() == j.last_mjd()
    t.print_summary()
    mine = capsys.readouterr().out
    j.print_summary()
    assert mine == capsys.readouterr().out
    assert mine.startswith("Number of TOAs: 40")
