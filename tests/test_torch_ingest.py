"""The port's host ingest against the JAX package's, on the CPU: time
scales, EOP, Earth rotation, clock files, the observatory registry, tim
parsing, get_TOAs with its pickle cache, the tim writer and the fake-TOA
maker at a real observatory.

Both packages run the same host numpy code and carry the same C++ host
library (the port's ``csrc/host_kernels.cpp`` is the JAX package's
``native/src/host_kernels.cpp``). The C++ and numpy paths of one package
differ by up to 1e-6 m in GCRS position, 1e-10 m/s in velocity and
1e-12 s in TDB-TT (the JAX package's ``tests/test_native.py``), so the
comparisons pair the paths: port numpy against JAX numpy (each
package's ``native._LIB`` set to False) and port C++ against JAX C++,
both held bitwise; port C++ against port numpy is held to those
tolerances. Each test names its ERRORBUDGET.md tier.
"""

import os
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
TDATA = ROOT / "pint_tpu_torch" / "data"
NGC_PAR = TDATA / "examples" / "NGC6440E.par"
NGC_TIM = TDATA / "examples" / "NGC6440E.tim"
B1855_TIM = ROOT / "tests" / "golden" / "b1855sim.tim"
SITES = ("effelsberg", "gbt", "parkes")


@pytest.fixture(params=["numpy", "cpp"])
def paths(request, monkeypatch):
    """Both packages on their numpy paths, or both on their C++
    libraries (skipped where neither can be built)."""
    import pint_tpu.native as jnative
    import pint_tpu_torch.native as tnative

    if request.param == "numpy":
        monkeypatch.setattr(jnative, "_LIB", False)
        monkeypatch.setattr(tnative, "_LIB", False)
    elif jnative.get_lib() is None or tnative.get_lib() is None:
        pytest.skip("no C++ compiler for the host libraries")
    return request.param


def _both_epochs(day, sec, scale):
    from pint_tpu.mjd import Epochs as JEpochs
    from pint_tpu_torch.mjd import Epochs

    return Epochs(day, sec, scale), JEpochs(day, sec, scale)


def _assert_epochs_equal(a, b):
    np.testing.assert_array_equal(a.day, b.day)
    np.testing.assert_array_equal(a.sec, b.sec)
    np.testing.assert_array_equal(a.lo, b.lo)
    assert a.scale == b.scale


# ---- timescales --------------------------------------------------------


def test_leap_table_steps_at_every_entry(monkeypatch):
    """UTC->TAI (leap seconds), exact: the port reads its own copy of
    leap-seconds.list into the JAX package's table, TAI-UTC steps by
    one second at every entry (10 s from 1972), and an unreadable file
    gives the same hard-coded fallback."""
    from pint_tpu import timescales as jts
    from pint_tpu_torch import timescales as ts

    assert ts._LEAPS == jts._LEAPS
    assert ts._LEAP_TABLE_FALLBACK == jts._LEAP_TABLE_FALLBACK
    mjds = np.array([m for m, _ in ts._LEAPS])
    vals = np.array([v for _, v in ts._LEAPS], float)
    np.testing.assert_array_equal(ts.tai_minus_utc(mjds), vals)
    np.testing.assert_array_equal(ts.tai_minus_utc(mjds[1:] - 1), vals[:-1])
    np.testing.assert_array_equal(ts.tai_minus_utc(mjds[1:] - 1),
                                  jts.tai_minus_utc(mjds[1:] - 1))
    assert np.all(np.diff(vals) == 1.0) and vals[0] == 10.0
    with pytest.raises(ValueError, match="pre-1972"):
        ts.tai_minus_utc(mjds[0] - 1)
    monkeypatch.setattr(ts.os.path, "dirname", lambda p: "/nonexistent")
    assert ts._load_leap_table() == list(ts._LEAP_TABLE_FALLBACK)


def test_timescale_chain_bitwise(paths):
    """UTC->TAI->TT->TDB, TT->TDB (the integrated table in MJD
    40000-64000, the FB1990 series outside) and the series itself over
    MJD 15000-90000, bitwise on each path pair; TDB->TT inverts
    UTC->TDB to 1e-12 s (two fixed-point steps)."""
    from pint_tpu import timescales as jts
    from pint_tpu_torch import timescales as ts

    rng = np.random.default_rng(3)
    day = rng.integers(15000, 90000, 2000)
    sec = rng.uniform(0.0, 86400.0, 2000)
    tt, jtt = _both_epochs(day, sec, "tt")
    np.testing.assert_array_equal(ts.tdb_minus_tt_series(tt),
                                  jts.tdb_minus_tt_series(jtt))
    for lo, hi in ((15000, 40000), (40000, 64000), (64000, 90000)):
        m = (day >= lo) & (day < hi)
        a, b = _both_epochs(day[m], sec[m], "tt")
        np.testing.assert_array_equal(ts.tdb_minus_tt(a), jts.tdb_minus_tt(b))
        _assert_epochs_equal(ts.tt_to_tdb(a), jts.tt_to_tdb(b))
        c, d = _both_epochs(day[m], sec[m], "tdb")
        _assert_epochs_equal(ts.tdb_to_tt(c), jts.tdb_to_tt(d))
    post72 = day >= 41317
    utc, jutc = _both_epochs(day[post72], sec[post72], "utc")
    tdb = ts.utc_to_tdb(utc)
    _assert_epochs_equal(tdb, jts.utc_to_tdb(jutc))
    _assert_epochs_equal(ts.utc_to_tt(utc), jts.utc_to_tt(jutc))
    back = ts.tdb_to_tt(tdb)
    tt2 = ts.utc_to_tt(utc)
    gap = (back.day - tt2.day) * 86400.0 + (back.sec - tt2.sec) + (back.lo - tt2.lo)
    assert np.abs(gap).max() <= 1e-12
    _assert_epochs_equal(ts.tai_to_utc(ts.utc_to_tai(utc)), utc)


def test_tdb_series_switch_and_native_tolerance(monkeypatch):
    """TT->TDB: PINT_TPU_TDB_SERIES selects the series in both
    packages (bitwise), and the port's C++ series meets its numpy
    series to 1e-12 s (test_native.py's tier)."""
    import pint_tpu_torch.native as tnative
    from pint_tpu import timescales as jts
    from pint_tpu_torch import timescales as ts

    rng = np.random.default_rng(4)
    tt, jtt = _both_epochs(rng.integers(44000, 61000, 300),
                           rng.uniform(0, 86400, 300), "tt")
    monkeypatch.setenv("PINT_TPU_TDB_SERIES", "1")
    np.testing.assert_array_equal(ts.tdb_minus_tt(tt), jts.tdb_minus_tt(jtt))
    np.testing.assert_array_equal(ts.tdb_minus_tt(tt),
                                  ts.tdb_minus_tt_series(tt))
    if tnative.get_lib() is None:
        pytest.skip("no C++ compiler for the host library")
    cpp = ts.tdb_minus_tt_series(tt)
    monkeypatch.setattr(tnative, "_LIB", False)
    np.testing.assert_allclose(cpp, ts.tdb_minus_tt_series(tt), rtol=0,
                               atol=1e-12)


# ---- EOP and Earth rotation --------------------------------------------


def _finals_line(mjd, x, y, dut):
    line = [" "] * 80
    for start, text in ((7, f"{mjd:8.2f}"), (18, f"{x:9.6f}"),
                        (37, f"{y:9.6f}"), (58, f"{dut:10.7f}")):
        line[start:start + len(text)] = text
    return "".join(line).rstrip() + "\n"


@pytest.fixture
def eop_file(tmp_path, monkeypatch):
    """A synthetic finals2000A file, found through PINT_TPU_EOP_FILE by
    both packages' discovery (reset before and after)."""
    from pint_tpu.earth import eop as jeop
    from pint_tpu_torch.earth import eop

    rng = np.random.default_rng(5)
    mjd = np.arange(50000, 61000, 1.0)
    rows = [_finals_line(m, *rng.uniform(-0.3, 0.3, 2), rng.uniform(-0.8, 0.8))
            for m in mjd]
    path = tmp_path / "finals2000A.all"
    path.write_text("".join(rows))
    monkeypatch.setenv("PINT_TPU_EOP_FILE", str(path))
    for mod in (eop, jeop):
        mod.reset_eop_discovery()
    yield path
    for mod in (eop, jeop):
        mod.reset_eop_discovery()


@pytest.mark.parametrize("site", SITES)
def test_gcrs_posvel_from_itrf_bitwise(site, paths, eop_file):
    """Earth rotation (topocentric) and UT1/polar motion: the GCRS
    position and velocity of GBT, Parkes and Effelsberg, with the EOP
    file discovered and with the UT1 = UTC tier (eop=None), bitwise on
    each path pair; the two tiers differ (the file's UT1-UTC is real)."""
    from pint_tpu.earth import eop as jeop
    from pint_tpu.earth.erfa_lite import gcrs_posvel_from_itrf as jgcrs
    from pint_tpu_torch.earth import eop
    from pint_tpu_torch.earth.erfa_lite import gcrs_posvel_from_itrf
    from pint_tpu_torch.observatory import get_observatory

    table, jtable = eop.get_eop_table(), jeop.get_eop_table()
    assert table is not None and jtable is not None
    np.testing.assert_array_equal(table.ut1_utc, jtable.ut1_utc)
    np.testing.assert_array_equal(table.pm_x, jtable.pm_x)
    itrf = get_observatory(site).itrf_xyz
    rng = np.random.default_rng(6)
    utc, jutc = _both_epochs(rng.integers(50000, 61000, 400),
                             rng.uniform(0, 86400, 400), "utc")
    for kw in ({}, {"eop": None}):
        pos, vel = gcrs_posvel_from_itrf(itrf, utc, **kw)
        jpos, jvel = jgcrs(itrf, jutc, **kw)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(vel, jvel)
    assert np.abs(gcrs_posvel_from_itrf(itrf, utc)[0] - pos).max() > 1.0


@pytest.mark.parametrize("site", SITES)
def test_gcrs_native_meets_numpy(site, monkeypatch):
    """Earth rotation: the port's C++ chain against its numpy chain,
    to test_native.py's 1e-6 m and 1e-10 m/s; a rotation only (the
    radius is kept to 1 mm)."""
    import pint_tpu_torch.native as tnative
    from pint_tpu_torch.earth.erfa_lite import gcrs_posvel_from_itrf
    from pint_tpu_torch.mjd import Epochs
    from pint_tpu_torch.observatory import get_observatory

    if tnative.get_lib() is None:
        pytest.skip("no C++ compiler for the host library")
    itrf = get_observatory(site).itrf_xyz
    rng = np.random.default_rng(7)
    utc = Epochs(rng.integers(50000, 61000, 300), rng.uniform(0, 86400, 300))
    pos, vel = gcrs_posvel_from_itrf(itrf, utc)
    monkeypatch.setattr(tnative, "_LIB", False)
    ppos, pvel = gcrs_posvel_from_itrf(itrf, utc)
    np.testing.assert_allclose(pos, ppos, rtol=0, atol=1e-6)
    np.testing.assert_allclose(vel, pvel, rtol=0, atol=1e-10)
    r = np.linalg.norm(pos, axis=1)
    assert np.all(np.abs(r - np.linalg.norm(itrf)) < 1e-3)


def test_geodetic_and_rotation_helpers_match():
    """Earth rotation: geodetic<->ITRF, ERA, nutation, GAST and the
    ITRF->GCRS matrices, bitwise (host numpy in both packages)."""
    from pint_tpu.earth import erfa_lite as jel
    from pint_tpu_torch.earth import erfa_lite as el

    xyz = np.array([882589.65, -4924872.32, 3943729.348])
    np.testing.assert_array_equal(el.itrf_to_geodetic(xyz),
                                  jel.itrf_to_geodetic(xyz))
    np.testing.assert_array_equal(el.geodetic_to_itrf(38.4, -79.8, 800.0),
                                  jel.geodetic_to_itrf(38.4, -79.8, 800.0))
    T = np.linspace(-0.3, 0.3, 50)
    for a, b in zip(el.nutation(T), jel.nutation(T)):
        np.testing.assert_array_equal(a, b)
    utc, jutc = _both_epochs(np.arange(50000, 50050), np.linspace(0, 8e4, 50),
                             "utc")
    np.testing.assert_array_equal(el.era(utc), jel.era(jutc))
    np.testing.assert_array_equal(el.gast(utc, T), jel.gast(jutc, T))
    np.testing.assert_array_equal(el.itrf_to_gcrs_matrix(utc, eop=None),
                                  jel.itrf_to_gcrs_matrix(jutc, eop=None))
    np.testing.assert_array_equal(el._bias_matrix(), jel._bias_matrix())


def test_gcrs_cache_keyed_on_exact_epochs():
    """Earth rotation: compute_TDBs leaves its ITRF->GCRS products for
    the next compute_posvels, keyed by the exact corrected-UTC epochs.
    After an in-place edit of the clock corrections in between (same
    length) the products are recomputed, so the posvels equal those of
    a table that never had a cache (bitwise), not the stale ones (the
    Earth turns ~230 m in 0.5 s)."""
    from pint_tpu_torch.toa import TOAs

    rng = np.random.default_rng(12)
    day = rng.integers(54000, 57000, 50)
    sec = rng.uniform(0, 86400, 50)
    stale = TOAs.from_arrays(day, sec, obs="gbt")
    stale.compute_TDBs()
    assert "gbt" in stale._gcrs_cache
    stale.compute_posvels()
    assert not stale._gcrs_cache
    t = TOAs.from_arrays(day, sec, obs="gbt")
    t.compute_TDBs()
    t.clock_corr_s += 0.5
    t.compute_posvels()
    ref = TOAs.from_arrays(day, sec, obs="gbt", tdb=t.tdb)
    ref.clock_corr_s = t.clock_corr_s.copy()
    ref.compute_posvels()
    np.testing.assert_array_equal(t.ssb_obs.pos, ref.ssb_obs.pos)
    np.testing.assert_array_equal(t.ssb_obs.vel, ref.ssb_obs.vel)
    assert np.abs(t.ssb_obs.pos - stale.ssb_obs.pos).max() > 100.0


# ---- clock files and observatories -------------------------------------


@pytest.fixture
def clock_dir(tmp_path, monkeypatch):
    """tempo and tempo2 clock files in a PINT_TPU_CLOCK_DIR, with both
    packages' clock caches emptied for the test."""
    from pint_tpu.observatory import clock_file as jcf
    from pint_tpu.observatory import get_observatory as jget
    from pint_tpu_torch.observatory import clock_file as cf
    from pint_tpu_torch.observatory import get_observatory

    mjd = np.arange(50000.0, 60000.0, 7.0)
    site = np.sin(mjd / 300.0) * 2.5  # us
    lines = ["# synthetic GBT clock\n"] + [
        f"{m:.2f} 0.0 {v:.4f} 1\n" for m, v in zip(mjd, site)]
    (tmp_path / "time_gbt.dat").write_text("".join(lines))
    gps = "# UTC(GPS) UTC\n" + "".join(
        f"{m:.1f} {1e-8 * np.cos(m / 50.0):.6e}\n" for m in mjd)
    (tmp_path / "gps2utc.clk").write_text(gps)
    bipm = "# TT(TAI) TT(BIPM2019)\n" + "".join(
        f"{m:.1f} {32.184 + 2.7e-5 + 1e-9 * (m - 55000):.12f}\n" for m in mjd)
    (tmp_path / "tai2tt_bipm2019.clk").write_text(bipm)
    monkeypatch.setenv("PINT_TPU_CLOCK_DIR", str(tmp_path))
    for mod in (cf, jcf):
        monkeypatch.setattr(mod, "_cache", {})
    for get in (get_observatory, jget):
        ob = get("gbt")
        monkeypatch.setattr(ob, "_clock", None)
        monkeypatch.setattr(ob, "_warned", False)
    return tmp_path


def test_clock_files_reach_clock_corrections(clock_dir):
    """Site clocks, GPS->UTC, TT(BIPM): a tempo site file and tempo2
    GPS and BIPM files, read by both packages and evaluated through
    ``clock_corrections`` at GBT with and without GPS and BIPM,
    bitwise; out-of-range epochs warn, or raise with limits='error'."""
    from pint_tpu.observatory import clock_file as jcf
    from pint_tpu.observatory import get_observatory as jget
    from pint_tpu_torch.observatory import clock_file as cf
    from pint_tpu_torch.observatory import get_observatory

    a = cf.ClockFile.read_tempo(str(clock_dir / "time_gbt.dat"))
    b = jcf.ClockFile.read_tempo(str(clock_dir / "time_gbt.dat"))
    np.testing.assert_array_equal(a.mjd, b.mjd)
    np.testing.assert_array_equal(a.offset, b.offset)
    a2 = cf.find_clock_file("gps2utc.clk")
    np.testing.assert_array_equal(a2.offset,
                                  jcf.find_clock_file("gps2utc.clk").offset)
    rng = np.random.default_rng(8)
    utc, jutc = _both_epochs(rng.integers(50100, 59900, 500),
                             rng.uniform(0, 86400, 500), "utc")
    ob, job = get_observatory("gbt"), jget("gbt")
    for kw in ({}, {"include_gps": False}, {"include_bipm": False},
               {"bipm_version": "BIPM2019"}):
        corr = ob.clock_corrections(utc, **kw)
        np.testing.assert_array_equal(corr, job.clock_corrections(jutc, **kw))
    bipm = ob.clock_corrections(utc) - ob.clock_corrections(
        utc, include_bipm=False)
    assert 2.1e-5 < bipm.min() and bipm.max() < 3.3e-5  # TT(BIPM) - TT(TAI)
    late, _ = _both_epochs(np.array([60500]), np.array([0.0]), "utc")
    with pytest.warns(UserWarning, match="outside range"):
        ob.clock_corrections(late)
    with pytest.raises(RuntimeError, match="outside range"):
        ob.clock_corrections(late, limits="error")


def test_clock_corrected_get_toas(clock_dir, paths, tmp_path):
    """Site clocks through the pipeline: get_TOAs at GBT with the clock
    files present gives the JAX package's clock corrections, TDB epochs
    and posvels bitwise, and after adjust_times both apply the chain
    again."""
    from pint_tpu.toa import get_TOAs as jget_TOAs
    from pint_tpu_torch.toa import get_TOAs

    tim = tmp_path / "gbt.tim"
    tim.write_text("FORMAT 1\n" + "".join(
        f"x 1400.0 {55000 + 13.37 * i:.13f} 1.0 gbt -f a\n"
        for i in range(40)))
    t, j = get_TOAs(tim), jget_TOAs(tim)
    assert np.abs(t.clock_corr_s).max() > 1e-6
    np.testing.assert_array_equal(t.clock_corr_s, j.clock_corr_s)
    _assert_epochs_equal(t.tdb, j.tdb)
    np.testing.assert_array_equal(t.ssb_obs.pos, j.ssb_obs.pos)
    # adjust_times drops the clock state with the derived columns: the
    # chain runs again at the new epochs
    for tab in (t, j):
        tab.adjust_times(86400.0 * 300)
        tab.apply_clock_corrections()
    assert np.abs(t.clock_corr_s - j.clock_corr_s).max() == 0.0
    assert np.abs(t.clock_corr_s - get_TOAs(tim).clock_corr_s).min() > 0.0


def test_zero_clock_chain_warns_once(monkeypatch):
    """Site clocks: with no files, a site's chain is zero and warns
    once per observatory, as in the JAX package."""
    from pint_tpu_torch.mjd import Epochs
    from pint_tpu_torch.observatory import clock_file as cf
    from pint_tpu_torch.observatory import get_observatory

    monkeypatch.delenv("PINT_TPU_CLOCK_DIR", raising=False)
    monkeypatch.setattr(cf, "_cache", {})
    ob = get_observatory("parkes")
    monkeypatch.setattr(ob, "_clock", None)
    monkeypatch.setattr(ob, "_warned", False)
    utc = Epochs(np.array([55000]), np.array([0.0]))
    with pytest.warns(UserWarning, match="no clock files found for parkes"):
        assert ob.clock_corrections(utc, include_bipm=False)[0] == 0.0
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ob.clock_corrections(utc, include_bipm=False)


def test_every_observatory_alias():
    """Every name and alias of observatories.json (and the special
    locations) resolves to the same site in both packages, with the
    same ITRF position, clock files and timescale; an unknown name
    raises KeyError in both."""
    import json

    from pint_tpu.observatory import get_observatory as jget
    from pint_tpu.observatory import list_observatories as jlist
    from pint_tpu_torch.observatory import get_observatory, list_observatories

    defs = json.loads((TDATA / "observatories.json").read_text())
    assert defs == json.loads(
        (ROOT / "pint_tpu" / "data" / "observatories.json").read_text())
    names = [(n, a) for n, d in defs.items()
             for a in (n, *d.get("aliases", ()))]
    names += [("barycenter", a) for a in ("barycenter", "@", "bat", "SSB")]
    names += [("geocenter", a) for a in ("geocenter", "coe", "geo", "0")]
    for name, alias in names:
        ob, job = get_observatory(alias), jget(alias)
        assert ob.name == job.name == name, alias
        assert type(ob).__name__ == type(job).__name__
        assert ob.timescale == job.timescale
        if hasattr(job, "itrf_xyz"):
            np.testing.assert_array_equal(ob.itrf_xyz, job.itrf_xyz)
            assert ob.clock_files == job.clock_files
    assert list_observatories() == jlist()
    for mod in (get_observatory, jget):
        with pytest.raises(KeyError, match="nowhere"):
            mod("nowhere")


# ---- tim parsing --------------------------------------------------------


def _princeton(obs, freq, mjd, err):
    return f"{obs:<15}{freq:9.3f}{mjd:>20}{err:9.2f}\n"


def _parkes(freq, mjd, phase, err, obs):
    line = " " + " " * 24 + f"{freq:9.3f}" + f"{mjd:>21}" + f"{phase:8.3f}"
    line += f"{err:8.2f}"
    return line.ljust(79) + obs + "\n"


def _write_tims(d):
    """A parent tim with every command and an INCLUDE of a FORMAT-1
    file, princeton and parkes lines before FORMAT 1."""
    (d / "inc.tim").write_text(
        "FORMAT 1\n"
        "c comment line\n"
        "inc1 1400.0 55010.1234567890123456 1.5 gbt -f L -pn 12\n"
        "JUMP\n"
        "inc2 820.5 55011.5 2.5 ao -be guppi -flag\n"
        "JUMP\n")
    lines = ["# a comment\n", "MODE 1\n", "INFO -f\n",
             _princeton("1", 1410.0, "55000.1234567890123", 3.0),
             _parkes(430.0, "55001.000000000012345", 0.25, 4.0, "7"),
             "TIME 0.5\n", "EFAC 2.0\n", "EQUAD 3.0\n",
             "INCLUDE inc.tim\n",
             "t2a 1400.0 55020.999999999999 1.0 GBT -f L\n",
             "EMIN 1.0\n", "EMAX 10.0\n",
             "drop 1400.0 55021.5 100.0 gbt\n",
             "SKIP\n", "skipped 1400.0 55022.5 1.0 gbt\n", "NOSKIP\n",
             "PHASE 1\n", "TRACK -2\n",
             "t2b 1400.0 55023.25 0.5 pks -x 1 -y -2.5\n",
             "END\n", "after 1400.0 55030.0 1.0 gbt\n"]
    (d / "main.tim").write_text("".join(lines))
    return d / "main.tim"


def test_read_tim_file_every_command(tmp_path):
    """Tim parsing (phase arithmetic tier: the MJD digits split exactly):
    tempo2, princeton and parkes lines, INCLUDE sharing the command
    state, TIME/EFAC/EQUAD/EMIN/EMAX/SKIP/NOSKIP/JUMP/PHASE/END, the
    same TOA records and commands as the JAX package's parser."""
    from pint_tpu.toa import read_tim_file as jread
    from pint_tpu_torch.toa import read_tim_file

    path = _write_tims(tmp_path)
    toas, cmds = read_tim_file(str(path))
    jtoas, jcmds = jread(str(path))
    assert cmds == jcmds
    assert len(toas) == len(jtoas) == 6
    for a, b in zip(toas, jtoas):
        assert (a.day, a.sec, a.error_us, a.freq_mhz, a.obs, a.flags) == (
            b.day, b.sec, b.error_us, b.freq_mhz, b.obs, b.flags)
    assert [t.obs for t in toas] == ["1", "7", "gbt", "ao", "gbt", "pks"]
    assert toas[3].flags["tim_jump"] == "1"
    assert toas[5].flags["phase_offset"] == "1"
    assert toas[1].flags["padd"] == "0.250"


def test_native_parser_matches_python(tmp_path, paths):
    """Tim parsing: on a plain FORMAT-1 file the C++ parser gives the
    Python parser's day/sec bitwise, with the same errors, frequencies,
    observatories, flags and commands; a file with stateful commands
    goes to the Python parser; both match the JAX package's tables."""
    from pint_tpu.toa import get_TOAs as jget_TOAs
    from pint_tpu_torch.toa import (TOAs, _read_tim_native, get_TOAs,
                                    read_tim_file)

    rng = np.random.default_rng(9)
    rows = ["FORMAT 1\n", "MODE 1\n"]
    for i in range(300):
        mjd = f"{rng.integers(53000, 58000)}.{rng.integers(0, 10**15):015d}"
        rows.append(f"n{i} {rng.uniform(300, 3000):.4f} {mjd} "
                    f"{rng.uniform(0.1, 9):.3f} {'gbt ao pks'.split()[i % 3]}"
                    f" -f L{i % 4} -be x -pn {i}\n")
    plain = tmp_path / "plain.tim"
    plain.write_text("".join(rows))
    toalist, cmds = read_tim_file(str(plain))
    py = TOAs(toalist)
    py.commands = cmds
    nat = _read_tim_native(str(plain))
    if paths == "numpy":
        assert nat is None
        nat = py
    assert nat.commands == cmds == ["FORMAT 1", "MODE 1"]
    np.testing.assert_array_equal(nat.day, py.day)
    np.testing.assert_array_equal(nat.sec, py.sec)
    np.testing.assert_array_equal(nat.error_us, py.error_us)
    np.testing.assert_array_equal(nat.freq_mhz, py.freq_mhz)
    assert list(nat.obs) == list(py.obs)
    assert nat.flags == py.flags
    assert _read_tim_native(str(_write_tims(tmp_path))) is None
    j = jget_TOAs(plain)
    t = get_TOAs(plain)
    np.testing.assert_array_equal(t.day, j.day)
    np.testing.assert_array_equal(t.sec, j.sec)
    assert t.flags == j.flags and t.commands == j.commands


# ---- get_TOAs, the pickle cache, the writer ----------------------------


def _assert_tables_equal(t, j, planets=False):
    assert t.ephem_provider == j.ephem_provider == "numeph"
    np.testing.assert_array_equal(t.day, j.day)
    np.testing.assert_array_equal(t.sec, j.sec)
    np.testing.assert_array_equal(t.clock_corr_s, j.clock_corr_s)
    _assert_epochs_equal(t.tdb, j.tdb)
    np.testing.assert_array_equal(t.ssb_obs.pos, j.ssb_obs.pos)
    np.testing.assert_array_equal(t.ssb_obs.vel, j.ssb_obs.vel)
    np.testing.assert_array_equal(t.obs_sun.pos, j.obs_sun.pos)
    assert sorted(t.planet_pos) == sorted(j.planet_pos)
    assert bool(t.planet_pos) == planets
    for p in t.planet_pos:
        np.testing.assert_array_equal(t.planet_pos[p], j.planet_pos[p])
    assert t.flags == j.flags and t.commands == j.commands
    assert list(t.obs) == list(j.obs)


@pytest.mark.parametrize("which,planets", [("ngc6440e", False),
                                           ("b1855sim", True)])
def test_get_toas_bitwise(which, planets, paths):
    """The whole host chain (tiers UTC->TAI, TAI->TT, TT->TDB, Earth
    rotation, Earth ephemeris): get_TOAs on NGC6440E.tim (GBT, with its
    par file's settings) and b1855sim.tim (Arecibo, planets on) gives
    the JAX package's clock corrections, TDB epochs, ssb_obs, obs_sun
    and planets bitwise, on each path pair."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.toa import get_TOAs as jget_TOAs
    from pint_tpu_torch.toa import get_TOAs

    if which == "ngc6440e":
        jm = jget_model(str(ROOT / "pint_tpu/data/examples/NGC6440E.par"))
        t = get_TOAs(NGC_TIM, model=_ngc_model())
        j = jget_TOAs(ROOT / "pint_tpu/data/examples/NGC6440E.tim", model=jm)
    else:
        t = get_TOAs(B1855_TIM, planets=True)
        j = jget_TOAs(B1855_TIM, planets=True)
    _assert_tables_equal(t, j, planets)
    assert (NGC_TIM.read_bytes() == (
        ROOT / "pint_tpu/data/examples/NGC6440E.tim").read_bytes())


def _ngc_model():
    """The port's NGC6440E.par as it is (SolarWindDispersion and
    TroposphereDelay included)."""
    from pint_tpu_torch.models import get_model

    return get_model(str(NGC_PAR))


def test_pickle_cache_hit_equals_miss(tmp_path):
    """The pickle cache: a hit is equal to the miss that wrote it
    (every column bitwise), an edited tim file misses, other settings
    miss."""
    from pint_tpu_torch.toa import get_TOAs, load_pickle

    tim = tmp_path / "ngc.tim"
    shutil.copy(NGC_TIM, tim)
    miss = get_TOAs(tim, usepickle=True)
    assert (tmp_path / "ngc.tim.torch.pickle.gz").exists()
    assert not (tmp_path / "ngc.tim.pickle.gz").exists()
    hit = get_TOAs(tim, usepickle=True)
    assert hit is not miss
    _assert_tables_equal(hit, miss)
    np.testing.assert_array_equal(hit.error_us, miss.error_us)
    assert load_pickle(tim, planets=True) is None
    tim.write_text(tim.read_text().replace("FORMAT 1\n", "FORMAT 1\nMODE 1\n"))
    assert load_pickle(tim) is None
    again = get_TOAs(tim, usepickle=True)
    assert again.commands == ["FORMAT 1", "MODE 1"]
    assert load_pickle(tim) is not None


def test_pickle_cache_misses_the_jax_packages_pickle(tmp_path):
    """The JAX package's pickle beside a tim file (same layout, settings
    and content hash) is a miss for the port, at the JAX package's file
    name and at the port's own, and loading it never imports pint_tpu
    or jax (checked in a fresh interpreter)."""
    import subprocess
    import sys

    from pint_tpu.toa import get_TOAs as jget_TOAs

    tim = tmp_path / "ngc.tim"
    shutil.copy(NGC_TIM, tim)
    jget_TOAs(tim, usepickle=True)
    jax_pickle = tmp_path / "ngc.tim.pickle.gz"
    assert jax_pickle.exists()
    shutil.copy(jax_pickle, tmp_path / "ngc.tim.torch.pickle.gz")
    script = (
        "import sys, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from pint_tpu_torch.toa import TOAs, get_TOAs, load_pickle\n"
        f"tim = {str(tim)!r}\n"
        "assert load_pickle(tim) is None\n"
        f"assert load_pickle(tim, picklefile={str(jax_pickle)!r}) is None\n"
        "t = get_TOAs(tim, usepickle=True)\n"
        "assert type(t) is TOAs and load_pickle(tim) is not None\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('pint_tpu', 'jax', 'jaxlib')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_write_toa_file_round_trip(tmp_path):
    """The tim writer: the port writes the JAX package's bytes (16
    fractional MJD digits, full-precision errors), and get_TOAs reads
    them back with day, flags and errors equal, |d sec| <= 1e-11 s and
    |d TDB| <= 1e-11 s (the instant, sec + lo: the 16-digit format's
    grid is 8.6e-12 s, the f64 seconds' 1.5e-11 s above 65536 s)."""
    from pint_tpu.toa import get_TOAs as jget_TOAs
    from pint_tpu_torch.toa import get_TOAs

    t = get_TOAs(NGC_TIM)
    t.error_us[:3] = [1.8125, 2.0, 1e-3]
    t.flags[0]["pn"] = "17"
    j = jget_TOAs(NGC_TIM)
    j.error_us[:3] = [1.8125, 2.0, 1e-3]
    j.flags[0]["pn"] = "17"
    t.write_TOA_file(tmp_path / "t.tim")
    j.write_TOA_file(tmp_path / "j.tim")
    assert (tmp_path / "t.tim").read_bytes() == (tmp_path / "j.tim").read_bytes()
    back = get_TOAs(tmp_path / "t.tim")
    np.testing.assert_array_equal(back.day, t.day)
    np.testing.assert_array_equal(back.error_us, t.error_us)
    assert back.flags == t.flags
    assert np.abs(back.sec - t.sec).max() <= 1e-11
    dtdb = ((back.tdb.day - t.tdb.day) * 86400.0 + (back.tdb.sec - t.tdb.sec)
            + (back.tdb.lo - t.tdb.lo))
    assert np.abs(dtdb).max() <= 1e-11


def test_format_mjds_matches_format_mjd():
    """The port's MJD formatter (the writer formats a whole table at
    once; ``format_mjd`` is its one-element case) equals the JAX
    package's ``mjd.format_mjd`` string for string, carries and
    day-edge roundings included (exact, tier: tim-file MJDs)."""
    from pint_tpu.mjd import format_mjd as jformat_mjd
    from pint_tpu_torch.mjd import format_mjd, format_mjds

    rng = np.random.default_rng(10)
    day = rng.integers(40000, 70000, 2000)
    sec = rng.uniform(0, 86400, 2000)
    sec[:4] = [0.0, 86399.99999999999, np.nextafter(86400.0, 0), 86400.0]
    want = [jformat_mjd(int(d), float(s), 16) for d, s in zip(day, sec)]
    assert format_mjds(day, sec, 16) == want
    assert [format_mjd(int(d), float(s), 16)
            for d, s in zip(day[:50], sec[:50])] == want[:50]
    assert format_mjd(55000, 43200.0, 11) == jformat_mjd(55000, 43200.0, 11)


# ---- simulation at a real observatory ----------------------------------


def test_fake_toas_at_gbt_match_jax(paths):
    """make_fake_toas_fromMJDs at GBT (its default observatory), two
    zero-residual passes through clock -> TDB -> posvels with the phase
    on the CPU: the epochs are the JAX package's to 1e-12 s (phase
    arithmetic tier), the TDB epochs and posvels at those epochs are
    bitwise the JAX pipeline's on each path pair, and the residuals of
    both packages are below 1e-10 s (the f64 grid of the seconds of
    day)."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.residuals import Residuals as JResiduals
    from pint_tpu.simulation import make_fake_toas_fromMJDs as jfake
    from pint_tpu.toa import TOAs as JTOAs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from test_torch_models import EQUATORIAL

    rng = np.random.default_rng(11)
    days = np.sort(rng.uniform(54000, 57000, 30))
    mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
    freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
    kw = dict(error_us=1.0, freq_mhz=freqs, iterations=2,
              flags={"f": "L-wide"})
    t = make_fake_toas_fromMJDs(mjds, get_model(EQUATORIAL), device="cpu",
                                **kw)
    jm = jget_model(EQUATORIAL)
    j = jfake(mjds, jm, **kw)
    assert set(t.obs) == {"gbt"}
    # the shifts come from each package's f64 phase, which differ by a
    # few ulps (the phase arithmetic tier), so the epochs agree to
    # 1e-12 s; the host chain at the port's epochs is then the JAX
    # package's bitwise
    d = (t.day - j.day) * 86400.0 + (t.sec - j.sec)
    assert np.abs(d).max() <= 1e-12
    j2 = JTOAs.from_arrays(t.day, t.sec, error_us=1.0, freq_mhz=freqs,
                           obs="gbt", flags=[dict(f) for f in t.flags])
    for step in ("apply_clock_corrections", "compute_TDBs",
                 "compute_posvels"):
        getattr(j2, step)()
    _assert_tables_equal(t, j2)
    r = Residuals(t, get_model(EQUATORIAL), subtract_mean=False, device="cpu")
    assert np.abs(r.time_resids).max() < 1e-10
    assert np.abs(np.asarray(JResiduals(j, jm, subtract_mean=False)
                             .time_resids)).max() < 1e-10


def test_port_gbt_toas_equal_the_adapter(paths):
    """The port's own GBT TOAs (no zero-residual pass) equal what
    test_torch_models.py's adapter copies from the JAX package's, column
    by column, bitwise on each path pair: the adapter keeps model parity
    apart from ingest parity, and the two now agree."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from test_torch_models import EQUATORIAL, jax_toas, port_toas

    _, jt = jax_toas(EQUATORIAL)
    adapter = port_toas(jt)
    own = make_fake_toas_fromMJDs(jt.get_mjds(), get_model(EQUATORIAL),
                                  freq_mhz=jt.freq_mhz, iterations=0,
                                  flags={"f": "L-wide"}, device="cpu")
    np.testing.assert_array_equal(own.day, jt.day)
    np.testing.assert_array_equal(own.sec, jt.sec)
    _assert_epochs_equal(own.tdb, adapter.tdb)
    for name in ("ssb_obs", "obs_sun"):
        np.testing.assert_array_equal(getattr(own, name).pos,
                                      getattr(adapter, name).pos)
    np.testing.assert_array_equal(own.ssb_obs.vel, adapter.ssb_obs.vel)
    np.testing.assert_array_equal(own.freq_mhz, adapter.freq_mhz)
    assert own.flags == adapter.flags


def test_fake_toas_noise_and_unported_options():
    """Noise draws: white noise at the model-scaled sigma and a
    correlated realization move the zero-residual TOAs by the JAX
    package's amounts for the same seed (the draws and the noise bases
    are the same; the residuals agree to 1e-12 s); the wideband
    arguments draw -pp_dm/-pp_dme flags after the noise, as the JAX
    package's do (bitwise: tests/test_torch_wideband.py)."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.simulation import make_fake_toas_uniform as jfake
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import (make_fake_toas,
                                           make_fake_toas_uniform)
    from test_torch_models import EQUATORIAL

    kw = dict(ntoas=80, error_us=1.0, iterations=1, seed=5,
              flags={"f": "L-wide"}, add_noise=True,
              add_correlated_noise=True)
    t = make_fake_toas_uniform(54000, 56000, model=get_model(EQUATORIAL),
                               device="cpu", **kw)
    j = jfake(54000, 56000, model=jget_model(EQUATORIAL), **kw)
    d = (t.day - j.day) * 86400.0 + (t.sec - j.sec)
    assert np.abs(d).max() <= 1e-12
    wb = make_fake_toas(54000, 56000, 8, get_model(EQUATORIAL), wideband=True,
                        device="cpu")
    assert all({"pp_dm", "pp_dme"} <= set(f) for f in wb.flags)


def test_fake_toas_from_tim(tmp_path):
    """make_fake_toas_fromtim: the tim file's epochs at its
    observatories, made zero-residual, as the JAX package makes them
    (epochs to 1e-12 s)."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.simulation import make_fake_toas_fromtim as jfake
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromtim

    t = make_fake_toas_fromtim(NGC_TIM, _ngc_model(), device="cpu")
    j = jfake(ROOT / "pint_tpu/data/examples/NGC6440E.tim",
              jget_model(str(ROOT / "pint_tpu/data/examples/NGC6440E.par")))
    d = (t.day - j.day) * 86400.0 + (t.sec - j.sec)
    assert np.abs(d).max() <= 1e-12
    assert len(t) == 62 and set(t.obs) == {"gbt"}


# ---- the standalone port ------------------------------------------------


def test_native_loader_builds_inside_the_port():
    """The port's loader builds its own copy of the C++ source into the
    port's gitignored csrc/build/: it never names the JAX package's
    library or source, and the copy is the JAX source but for comments."""
    from pint_tpu_torch import native

    text = (ROOT / "pint_tpu_torch" / "native.py").read_text()
    for bad in ("pint_tpu/native", "native/src", "libpint_host.so"):
        assert bad not in text
    assert native.SOURCE == str(ROOT / "pint_tpu_torch" / "csrc"
                                / "host_kernels.cpp")
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR

    def code(path):
        src = re.sub(r"//[^\n]*", "", path.read_text())
        return [line.rstrip() for line in src.splitlines() if line.strip()]

    assert code(ROOT / "pint_tpu_torch/csrc/host_kernels.cpp") == code(
        ROOT / "native/src/host_kernels.cpp")
    if native.get_lib() is not None:
        assert native.loaded()
        assert os.path.exists(native.library_path())


def test_port_reads_no_file_of_the_jax_package():
    """No module of the port and not chip_smoke.py names a path inside
    the JAX package (``pint_tpu/...``) or its ``native/`` tree: the data
    files, examples and the C++ source are the port's own copies, and
    each copy equals its original."""
    files = sorted((ROOT / "pint_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = re.compile(r"""pint_tpu/(data|native|examples)|native/src|"""
                     r"""join\([^)]*["'](pint_tpu|native)["']""")
    for f in files:
        assert not bad.search(f.read_text()), f
    for name in ("leap-seconds.list", "observatories.json",
                 "examples/NGC6440E.par", "examples/NGC6440E.tim"):
        assert ((TDATA / name).read_bytes()
                == (ROOT / "pint_tpu" / "data" / name).read_bytes()), name
    assert ((TDATA / "examples" / "NGC6440E_prefit_resids_us.npy").read_bytes()
            == (ROOT / "tests/golden/ngc6440e_prefit_resids_us.npy").read_bytes())
