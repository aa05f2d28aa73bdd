"""The port's photon path against the JAX package's, on the CPU: event
files (io/fits.py, event_toas.py), lazy-flag photon TOA tables and
their barycentre posvels (toa.py, observatory/), the timing model's
phase (models/timing_model.py with phase.py / dd.py), the periodicity
statistics (eventstats.py) and the photonphase script.

Inputs are made with numpy from seeds and handed to both packages as
numpy arrays or as files both can read.

Tolerances:
- FITS, MET conversion, loaders, Fermi weights: bitwise (host numpy in
  both packages).
- Statistics (z2m, z2mw, hm, hmw, hm_scan) on the CPU, where both
  packages take their f64 harmonic sums: 1e-12 relative (torch and XLA
  sum in different orders).
- Phase on barycentred event TOAs with the JAX package's posvels (the
  ``port_toas`` adapter of test_torch_models.py): ``int_`` equal,
  ``frac`` 1e-9 cycles, test_torch_models.py's tier.
- With the port's own barycentre posvels, which take the Sun from the
  same ephemeris tier as the JAX package (the shipped numeph kernel,
  read by each package's own SPK reader), the Sun is bitwise the JAX
  package's (held to 1e-6 m) and the phase meets the same 1e-9-cycle
  tier. The photonphase script is held to 1e-9 cycles and H to 1e-12
  with the JAX Sun handed to the port, and to 1e-9 cycles with its own.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from test_torch_models import port_toas

PAR = """
PSR TESTEV
RAJ 10:00:00.0
DECJ 15:00:00.0
F0 29.946923 1
F1 -3.77e-10 1
PEPOCH 56700
DM 0.0
"""
NICER_REF = 56658.000777592593


def _mjds(n, seed, days=0.5):
    """Photon TDB epochs folding to a von Mises pulse at phase 0.3
    (tests/test_events.py's first-order spindown inversion)."""
    rng = np.random.default_rng(seed)
    f0, f1 = 29.946923, -3.77e-10
    pulse_n = rng.integers(0, int(days * 86400 * f0), n)
    phases = (rng.vonmises(2 * np.pi * 0.3, 8.0, n) / (2 * np.pi)) % 1.0
    dt = (pulse_n + phases) / f0
    dt = dt - 0.5 * f1 * dt**2 / f0
    return 56700.0 + np.asarray(dt, np.longdouble) / 86400.0


def _event_columns(n=3000, seed=5, weights=True, fermi=False):
    rng = np.random.default_rng(seed + 1)
    met = (np.asarray(_mjds(n, seed), np.longdouble) - NICER_REF) * 86400.0
    cols = {"TIME": np.asarray(met, np.float64),
            "PHA": rng.integers(0, 1024, n).astype(np.int32)}
    if weights:
        cols["PSRPROB"] = rng.random(n)
    if fermi:
        cols["RA"] = 150.0 + rng.normal(0, 1.0, n)
        cols["DEC"] = 15.0 + rng.normal(0, 1.0, n)
        cols["ENERGY"] = 10 ** rng.uniform(2, 5, n)
    return cols


def _header(timesys="TDB", telescop="NICER"):
    return {"MJDREFI": int(NICER_REF), "MJDREFF": NICER_REF - int(NICER_REF),
            "TIMESYS": timesys, "TELESCOP": telescop}


@pytest.fixture(scope="module")
def event_file(tmp_path_factory):
    from pint_tpu_torch.io.fits import write_fits_table

    path = tmp_path_factory.mktemp("ev") / "evt.fits"
    write_fits_table(path, _event_columns(), _header())
    return path


def _same_table(a, b):
    ha, ca = a
    hb, cb = b
    assert ha == hb
    assert list(ca) == list(cb)
    for k in ca:
        assert ca[k].dtype == cb[k].dtype, k
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)


def test_fits_writers_and_readers_agree_both_ways(tmp_path):
    """The two writers make the same bytes; each reader reads either
    file to the same header and columns, vector columns included."""
    from pint_tpu.io import fits as jf
    from pint_tpu_torch.io import fits as tf

    cols = _event_columns(200, seed=1)
    cols["POSITION"] = np.arange(600, dtype=float).reshape(200, 3)
    cols["FLAG"] = np.arange(200, dtype=np.uint8)
    hdr = {**_header("TT"), "OBJECT": "TESTEV", "EXPOSURE": 1234.5}
    tf.write_fits_table(tmp_path / "t.fits", cols, hdr)
    jf.write_fits_table(tmp_path / "j.fits", cols, hdr)
    assert (tmp_path / "t.fits").read_bytes() == (tmp_path / "j.fits").read_bytes()
    for path in (tmp_path / "t.fits", tmp_path / "j.fits"):
        _same_table(tf.get_table(path, "EVENTS"), jf.get_table(path, "EVENTS"))
        hd_t, hd_j = tf.read_fits(path), jf.read_fits(path)
        assert [h["name"] for h in hd_t] == [h["name"] for h in hd_j]
    with pytest.raises(KeyError):
        tf.get_table(tmp_path / "t.fits", "ORBIT")
    (tmp_path / "bad.fits").write_bytes(b"not a fits file" * 200)
    with pytest.raises(ValueError, match="not a FITS file"):
        tf.read_fits(tmp_path / "bad.fits")


def test_met_to_day_sec_and_mjdref_match():
    from pint_tpu import event_toas as je
    from pint_tpu_torch import event_toas as te

    met = np.random.default_rng(2).uniform(0, 5e8, 1000)
    for mission, ref in te.MISSION_MJDREF.items():
        assert je.MISSION_MJDREF[mission] == ref
        for a, b in zip(te.met_to_day_sec(met, ref),
                        je.met_to_day_sec(met, ref)):
            np.testing.assert_array_equal(a, b)
    for hdr in ({"MJDREFI": 56658, "MJDREFF": 7.7e-4}, {"MJDREF": 50814.0},
                {}):
        assert te._mjdref_days(hdr, "nicer") == je._mjdref_days(hdr, "nicer")
    with pytest.raises(KeyError):
        te._mjdref_days({}, "nosuchmission")


@pytest.mark.parametrize("timesys", ["TDB", "TT"])
def test_load_event_toas_matches(tmp_path, timesys):
    """Epochs, observatory and weights bitwise, with an MJD window and a
    weight column; flags stay lazy. A TT file maps to the mission's
    satellite observatory, whose posvels the port does not have."""
    from pint_tpu.event_toas import load_event_TOAs as jload
    from pint_tpu_torch.event_toas import get_event_weights
    from pint_tpu_torch.event_toas import load_event_TOAs as tload
    from pint_tpu_torch.io.fits import write_fits_table

    path = tmp_path / "e.fits"
    write_fits_table(path, _event_columns(), _header(timesys))
    kw = dict(weightcolumn="PSRPROB", minmjd=56700.1, maxmjd=56700.4)
    jt, tt = jload(path, "nicer", **kw), tload(path, "nicer", **kw)
    assert 0 < len(tt) == len(jt) < 3000
    np.testing.assert_array_equal(tt.day, jt.day)
    np.testing.assert_array_equal(tt.sec, jt.sec)
    np.testing.assert_array_equal(tt.freq_mhz, jt.freq_mhz)
    np.testing.assert_array_equal(tt.error_us, jt.error_us)
    assert list(tt.obs) == list(jt.obs)
    np.testing.assert_array_equal(tt.weights, jt.weights)
    np.testing.assert_array_equal(get_event_weights(tt), jt.weights)
    assert not tt.has_flags()
    np.testing.assert_array_equal(tt.get_pulse_numbers(),
                                  np.full(len(tt), np.nan))
    assert not tt.has_flags()  # reading pulse numbers made no dicts
    assert tt.filename == str(path)
    if timesys == "TT":
        # a mission's satellite observatory (its orbit file) is not
        # ported: the name is unknown, as in the JAX package without one
        assert set(tt.obs) == {"nicer"}
        with pytest.raises(KeyError, match="nicer"):
            tt.to_batch("cpu")


def test_fermi_weights_match(tmp_path):
    """calc_lat_weights, the angular separation and load_Fermi_TOAs with
    CALC weights and with a weight column, bitwise."""
    from pint_tpu import event_toas as je
    from pint_tpu_torch import event_toas as te
    from pint_tpu_torch.io.fits import write_fits_table

    rng = np.random.default_rng(3)
    e, th = 10 ** rng.uniform(2, 5, 500), rng.uniform(0, 5, 500)
    np.testing.assert_array_equal(te.calc_lat_weights(e, th),
                                  je.calc_lat_weights(e, th))
    np.testing.assert_array_equal(
        te.calc_lat_weights(e, th, logeref=3.5, logesig=0.7),
        je.calc_lat_weights(e, th, logeref=3.5, logesig=0.7))
    ra, dec = rng.uniform(0, 360, 500), rng.uniform(-90, 90, 500)
    np.testing.assert_array_equal(te._angsep_deg(10.0, 20.0, ra, dec),
                                  je._angsep_deg(10.0, 20.0, ra, dec))
    path = tmp_path / "ft1.fits"
    write_fits_table(path, _event_columns(fermi=True),
                     _header("TDB", "GLAST"))
    jt = je.load_Fermi_TOAs(path, weightcolumn="CALC",
                            targetcoord=(150.0, 15.0))
    tt = te.load_Fermi_TOAs(path, weightcolumn="CALC",
                            targetcoord=(150.0, 15.0))
    np.testing.assert_array_equal(tt.weights, jt.weights)
    np.testing.assert_array_equal(tt.sec, jt.sec)
    tw = te.load_Fermi_TOAs(path, weightcolumn="PSRPROB")
    np.testing.assert_array_equal(
        tw.weights, je.load_Fermi_TOAs(path, weightcolumn="PSRPROB").weights)
    with pytest.raises(ValueError, match="targetcoord"):
        te.load_Fermi_TOAs(path, weightcolumn="CALC")
    assert te.load_XMM_TOAs.__name__ == "load_XMM_TOAs"


def test_weights_and_lazy_flags_through_mask_and_merge():
    from pint_tpu_torch.toa import TOAs, merge_TOAs

    n = 10
    w = np.linspace(0.1, 1.0, n)
    t = TOAs.from_arrays(np.full(n, 56700), np.linspace(0, 9e4 - 1, n) % 86400,
                         obs="barycenter", weights=w)
    assert not t.has_flags() and t._flags is None
    keep = np.arange(n) % 3 != 0
    sub = t.mask(keep)
    np.testing.assert_array_equal(sub.weights, w[keep])
    assert not sub.has_flags()
    both = merge_TOAs([t, sub])
    np.testing.assert_array_equal(both.weights, np.concatenate([w, w[keep]]))
    assert not both.has_flags()
    flagged = TOAs.from_arrays(np.full(2, 56700), np.zeros(2),
                               obs="barycenter",
                               flags=[{"pn": "3"}, {}])
    assert flagged.has_flags()
    np.testing.assert_array_equal(flagged.get_pulse_numbers(), [3.0, np.nan])
    mixed = merge_TOAs([sub, flagged])
    assert mixed.has_flags() and mixed.weights is None
    assert mixed.flags[-2] == {"pn": "3"} and mixed.flags[0] == {}
    assert len(t.flags) == n and t.has_flags()  # reading flags makes them
    with pytest.raises(ValueError, match="weights"):
        TOAs.from_arrays(np.zeros(3), np.zeros(3), weights=np.ones(2))


def test_barycentre_posvels_and_observatories():
    """``compute_posvels`` at the barycentre: TDB epochs as given,
    ssb_obs exactly zero, obs_sun the Sun of the numeph tier; a ground
    site is a TopoObs, a mission without its orbit file an unknown
    name, and a table may mix observatories."""
    from pint_tpu_torch.ephemeris import objPosVel_wrt_SSB
    from pint_tpu_torch.observatory import (BarycenterObs, GeocenterObs,
                                            TopoObs, get_observatory)
    from pint_tpu_torch.toa import TOAs

    for name in ("barycenter", "@", "bat", "SSB"):
        assert isinstance(get_observatory(name), BarycenterObs)
    for name in ("geocenter", "coe"):
        assert isinstance(get_observatory(name), GeocenterObs)
    assert isinstance(get_observatory("gbt"), TopoObs)
    for name in ("nicer", "fermi"):
        with pytest.raises(KeyError, match=name):
            get_observatory(name)
    day = np.full(5, 56700)
    sec = np.linspace(10.0, 8e4, 5)
    t = TOAs.from_arrays(day, sec, obs="@").compute_posvels()
    np.testing.assert_array_equal(t.tdb.day, day)
    np.testing.assert_array_equal(t.tdb.sec, sec)
    assert t.tdb.scale == "tdb"
    assert not np.any(t.ssb_obs.pos) and not np.any(t.ssb_obs.vel)
    assert t.ephem_provider == "numeph"
    sun = objPosVel_wrt_SSB("sun", t.tdb, provider="numeph").pos
    np.testing.assert_array_equal(t.obs_sun.pos, sun)
    assert 1e8 < np.linalg.norm(sun, axis=1).min()  # ~0.005 AU
    mixed = TOAs.from_arrays(np.full(2, 56700), np.zeros(2),
                             obs=np.array(["@", "geocenter"], dtype=object))
    mixed.compute_posvels()
    assert not np.any(mixed.ssb_obs.pos[0])
    assert 1.4e11 < np.linalg.norm(mixed.ssb_obs.pos[1]) < 1.6e11  # ~1 AU


def test_dd_and_phase_match():
    from pint_tpu import dd as jdd
    from pint_tpu import phase as jphase
    from pint_tpu_torch import dd as tdd
    from pint_tpu_torch import phase as tphase

    rng = np.random.default_rng(9)
    a = rng.normal(size=200) * 10.0 ** rng.integers(-8, 9, 200)
    b = rng.normal(size=200) * 10.0 ** rng.integers(-8, 9, 200)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for name in ("two_sum", "two_prod", "quick_two_sum"):
        x, y = getattr(tdd, name)(ta, tb), getattr(jdd, name)(a, b)
        np.testing.assert_array_equal(x.hi.numpy(), np.asarray(y.hi))
        np.testing.assert_array_equal(x.lo.numpy(), np.asarray(y.lo))
    # two_prod is exact: hi + lo == a * b in longdouble arithmetic
    p = tdd.two_prod(ta, tb)
    exact = np.longdouble(a) * np.longdouble(b)
    assert np.all(np.longdouble(p.hi.numpy()) + np.longdouble(p.lo.numpy())
                  == exact)
    for name in ("add", "sub"):
        x = getattr(tdd, name)(tdd.from_2sum(ta, tb * 1e-17),
                               tdd.from_2sum(tb, ta * 1e-17))
        y = getattr(jdd, name)(jdd.from_2sum(a, b * 1e-17),
                               jdd.from_2sum(b, a * 1e-17))
        np.testing.assert_array_equal(x.hi.numpy(), np.asarray(y.hi))
        np.testing.assert_array_equal(x.lo.numpy(), np.asarray(y.lo))
    x = tdd.round_half(tdd.from_2sum(ta * 1e3, tb * 1e-14))
    y = jdd.round_half(jdd.from_2sum(a * 1e3, b * 1e-14))
    np.testing.assert_array_equal(x.hi.numpy(), np.asarray(y.hi))
    np.testing.assert_array_equal(x.lo.numpy(), np.asarray(y.lo))
    pa = tphase.from_f64(ta * 1e3)
    pb = tphase.from_f64(tb * 1e3)
    qa = jphase.from_f64(a * 1e3)
    qb = jphase.from_f64(b * 1e3)
    for x, y in ((pa, qa), (pa + pb, qa + qb), (pa - pb, qa - qb),
                 (-pa, -qa)):
        np.testing.assert_array_equal(x.int_.numpy(), np.asarray(y.int_))
        np.testing.assert_array_equal(x.frac.numpy(), np.asarray(y.frac))
    assert np.all(np.abs((pa + pb).frac.numpy()) <= 0.5)
    z = tphase.zeros(4, device="cpu")
    assert z.int_.shape == (4,) and not z.value().any()


@pytest.fixture(scope="module")
def jax_event_toas(event_file):
    from pint_tpu.event_toas import load_event_TOAs

    return load_event_TOAs(event_file, "nicer", weightcolumn="PSRPROB")


def test_phase_on_event_toas_matches(jax_event_toas):
    """TimingModel.phase on barycentred event TOAs with the JAX
    package's posvels; the dispersion delay is exactly 0 at infinite
    frequency and the solar Shapiro delay is applied; the H of the
    phases equals the JAX package's."""
    from pint_tpu.eventstats import hm as jhm
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.eventstats import hm as thm
    from pint_tpu_torch.models import get_model as tget
    from pint_tpu_torch.phase import Phase

    jm, tm = jget(PAR), tget(PAR)
    jt = jax_event_toas
    jp = jm.phase(jt)
    tt = port_toas(jt)
    tp = tm.phase(tt, device="cpu")
    assert isinstance(tp, Phase) and tp.frac.dtype == torch.float64
    np.testing.assert_array_equal(tp.int_.numpy(), np.asarray(jp.int_))
    assert np.abs(tp.frac.numpy() - np.asarray(jp.frac)).max() <= 1e-9
    prep = tm.prepare(tt, device="cpu")
    dm = tm.components["DispersionDM"].delay(prep.params0, prep.batch,
                                             prep.prep, None)
    assert torch.all(dm == 0)
    ss = tm.components["SolarSystemShapiro"].delay(prep.params0, prep.batch,
                                                   prep.prep, None)
    jprep = jm.prepare(jt)
    jss = jm.components["SolarSystemShapiro"].delay(
        jprep.params0, jprep.batch, jprep.prep, None)
    assert 1e-6 < float(ss.abs().min())
    assert np.abs(ss.numpy() - np.asarray(jss)).max() <= 1e-12
    h_j = float(jhm(np.asarray(jp.frac) % 1.0))
    h_t = float(thm(torch.remainder(tp.frac, 1.0)))
    assert h_j > 500.0
    assert abs(h_t - h_j) <= 1e-9 * h_j


def test_phase_with_port_posvels_matches_jax(event_file, jax_event_toas):
    """The port's own barycentre posvels: the Sun from the numeph tier,
    as the JAX package's ``compute_posvels`` takes it, to 1e-6 m (it is
    bitwise), and the phase at the 1e-9-cycle tier with ``int_``
    equal."""
    from pint_tpu.models import get_model as jget
    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.models import get_model as tget

    jp = jget(PAR).phase(jax_event_toas)
    tt = load_event_TOAs(event_file, "nicer", weightcolumn="PSRPROB")
    tp = tget(PAR).phase(tt, device="cpu")
    assert tt.ephem_provider == jax_event_toas.ephem_provider == "numeph"
    assert np.abs(tt.obs_sun.pos - jax_event_toas.obs_sun.pos).max() <= 1e-6
    np.testing.assert_array_equal(tp.int_.numpy(), np.asarray(jp.int_))
    assert np.abs(tp.frac.numpy() - np.asarray(jp.frac)).max() <= 1e-9


def _pulsed(n, seed):
    rng = np.random.default_rng(seed)
    ph = np.concatenate([rng.random(n // 2),
                         rng.vonmises(2 * np.pi * 0.3, 5.0, n - n // 2)
                         / (2 * np.pi) % 1.0])
    return ph, rng.random(n)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n", [800, 5000])
def test_statistics_match(n):
    from pint_tpu import eventstats as je
    from pint_tpu_torch import eventstats as te

    ph, w = _pulsed(n, n)
    tph, tw = torch.as_tensor(ph), torch.as_tensor(w)
    for m in (1, 2, 6):
        assert _rel(te.z2m(tph, m).numpy(), je.z2m(ph, m)) <= 1e-12
        assert _rel(te.z2mw(tph, tw, m).numpy(), je.z2mw(ph, w, m)) <= 1e-12
    for m in (1, 20):
        assert _rel(float(te.hm(tph, m)), float(je.hm(ph, m))) <= 1e-12
        assert _rel(float(te.hmw(tph, tw, m)),
                    float(je.hmw(ph, w, m))) <= 1e-12
    # numpy input goes to the device named
    assert _rel(float(te.hm(ph, device="cpu")), float(je.hm(ph))) <= 1e-12
    h = float(je.hm(ph))
    assert te.sf_hm(h) == je.sf_hm(h)
    assert te.sf_hm(h, logprob=True) == je.sf_hm(h, logprob=True)
    assert te.h2sig(h) == je.h2sig(h)
    assert te.h2sig(1e6) == je.h2sig(1e6)  # the deep-tail inversion
    z = float(je.z2m(ph, 2)[-1])
    assert te.sf_z2m(z, 2) == je.sf_z2m(z, 2)
    for p in (0.1, 2.866e-7, 1e-30):
        assert te.sig2sigma(p) == je.sig2sigma(p)
    assert te.sig2sigma(-800.0, logprob=True) == je.sig2sigma(-800.0,
                                                              logprob=True)


def test_hm_scan_matches():
    """A 5-trial frequency scan: vmap of the port's phase function, one
    harmonic-sums call over the (5, n) batch, against the JAX
    package's vmap of hm."""
    import jax.numpy as jnp

    from pint_tpu import eventstats as je
    from pint_tpu_torch import eventstats as te

    rng = np.random.default_rng(12)
    f0 = 7.3
    t = np.sort(rng.uniform(0, 2000.0, 3000))
    t = t[np.abs((t * f0) % 1.0 - 0.4) < 0.2]  # pulsed at f0
    grid = f0 + (np.arange(5) - 2) * 1.0 / (4 * 2000.0)
    jt_, tt_ = jnp.asarray(t), torch.as_tensor(t)
    hj = np.asarray(je.hm_scan(lambda f: (jt_ * f) % 1.0, grid))
    ht = te.hm_scan(lambda f: (tt_ * f) % 1.0, grid, device="cpu")
    assert ht.shape == (5,) and int(torch.argmax(ht)) == 2
    assert _rel(ht.numpy(), hj) <= 1e-12
    # the grid as a tensor keeps its device
    ht2 = te.hm_scan(lambda f: (tt_ * f) % 1.0, torch.as_tensor(grid))
    np.testing.assert_array_equal(ht2.numpy(), ht.numpy())


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _h_full(text):
    return float(next(line.split("=", 1)[1] for line in text.splitlines()
                      if line.startswith("H = ")))


def test_photonphase_script_matches(event_file, jax_event_toas, tmp_path,
                                    monkeypatch):
    """The port's photonphase on the CPU against the JAX script: with
    the JAX package's Sun handed to the port, the same printed H-test,
    H to 1e-12 and PULSE_PHASE to 1e-9 cycles; PULSE_NUMBER +
    PULSE_PHASE equals the phase; with its own Sun (the numeph tier), to
    1e-9 cycles as well."""
    from pint_tpu.io.fits import get_table as jget_table
    from pint_tpu.scripts.photonphase import main as jmain
    from pint_tpu_torch.io.fits import get_table
    from pint_tpu_torch.scripts.fermiphase import main as fmain
    from pint_tpu_torch.scripts.photonphase import main as tmain
    from pint_tpu_torch.toa import TOAs
    from pint_tpu_torch.utils import PosVel

    par = tmp_path / "p.par"
    par.write_text(PAR)
    args = [str(event_file), str(par), "--weightcol", "PSRPROB",
            "--absphase"]
    rc, jout = _run(jmain, args + ["--outfile", str(tmp_path / "j.fits")])
    assert rc == 0
    jcols = jget_table(tmp_path / "j.fits", "EVENTS")[1]

    def tcols(out):
        return get_table(tmp_path / out, "EVENTS")[1]

    rc, own = _run(tmain, args + ["--device", "cpu", "--outfile",
                                  str(tmp_path / "own.fits")])
    assert rc == 0
    assert np.abs(tcols("own.fits")["PULSE_PHASE"]
                  - jcols["PULSE_PHASE"]).max() <= 1e-9
    compute = TOAs.compute_posvels

    def jax_sun(self):
        compute(self)
        self.obs_sun = PosVel(jax_event_toas.obs_sun.pos,
                              np.zeros_like(jax_event_toas.obs_sun.pos))
        return self

    monkeypatch.setattr(TOAs, "compute_posvels", jax_sun)
    rc, tout = _run(tmain, args + ["--device", "cpu", "--outfile",
                                   str(tmp_path / "t.fits")])
    assert rc == 0
    line = next(s for s in jout.splitlines() if s.startswith("Htest"))
    assert line in tout.splitlines()
    t = tcols("t.fits")
    assert list(t) == list(jcols)
    for k in ("TIME", "PHA", "PSRPROB", "PULSE_NUMBER"):
        np.testing.assert_array_equal(t[k], jcols[k], err_msg=k)
    assert np.abs(t["PULSE_PHASE"] - jcols["PULSE_PHASE"]).max() <= 1e-9
    from pint_tpu.eventstats import hmw

    h_j = float(hmw(jcols["PULSE_PHASE"], jcols["PSRPROB"]))
    assert abs(_h_full(tout) - h_j) <= 1e-12 * h_j
    assert abs(_h_full(own) - h_j) <= 1e-6 * h_j
    # fermiphase passes the device and the weight column through
    rc, fout = _run(fmain, [str(event_file), str(par), "--weightcol",
                            "PSRPROB", "--device", "cpu"])
    assert rc == 0 and _h_full(fout) == _h_full(tout)


def test_photonphase_unported_options_raise(event_file, tmp_path):
    """The options that raised NotImplementedError before their modules
    were ported now reach them: --orbfile reads the orbit file (a
    missing one raises the reader's error), --polycos phases the
    photons from generated polycos, and an ecliptic par file takes
    CALC weights as far as the FT1 columns (this NICER file has none).
    CALC on a file that is not Fermi's still returns 1."""
    from pint_tpu_torch.scripts.photonphase import main

    par = tmp_path / "p.par"
    par.write_text(PAR)
    base = [str(event_file), str(par), "--device", "cpu"]
    with pytest.raises(OSError):
        main(base + ["--orbfile", str(tmp_path / "missing_orb.fits")])
    rc, out = _run(main, base + ["--polycos"])
    assert rc == 0 and "polyco segments" in out
    ecl = tmp_path / "e.par"
    ecl.write_text(PAR.replace("RAJ 10:00:00.0\nDECJ 15:00:00.0\n",
                               "ELONG 140.0\nELAT 2.0\n"))
    with pytest.raises(StopIteration):  # no RA column in a NICER file
        main([str(event_file), str(ecl), "--device", "cpu", "--mission",
              "fermi", "--weightcol", "CALC"])
    rc, _ = _run(main, base + ["--weightcol", "CALC"])  # not a Fermi file
    assert rc == 1
