"""The port's ephemeris tiers (pint_tpu_torch/io/spk.py,
pint_tpu_torch/ephemeris/__init__.py, the copied data/numeph_v1.bsp)
against the JAX package's, on the CPU, and the posvels of the two
special observatories that read them.

Tolerances: the SPK reader and the tier dispatch are host numpy in both
packages, evaluated in the same order, so positions, velocities,
provider tags, fingerprints and error messages are held bitwise equal.
The geocentre reads its epochs as UTC and converts them with the
port's ``timescales.py``, as the JAX package does; on the numpy paths
of both packages (their C++ host libraries switched off) its TDB
epochs, Earth and Sun are bitwise the JAX package's.
"""

import hashlib
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = {"earth": [(3, 0), (399, 3)], "moon": [(3, 0), (301, 3)],
         "emb": [(3, 0)], "sun": [(10, 0)], "jupiter": [(5, 0)],
         "saturn": [(6, 0)], "uranus": [(7, 0)], "neptune": [(8, 0)],
         "venus": [(2, 0)], "mercury": [(1, 0)], "mars": [(4, 0)]}
HOPS = sorted({hop for chain in CHAIN.values() for hop in chain})
MJD_LO, MJD_HI = 40000.0, 64000.0  # numeph_v1's coverage


def _epochs(mjd):
    from pint_tpu.mjd import Epochs as JEpochs
    from pint_tpu_torch.mjd import Epochs as TEpochs

    mjd = np.asarray(mjd, np.float64)
    day = np.floor(mjd).astype(np.int64)
    sec = (mjd - day) * 86400.0
    return TEpochs(day, sec, "tdb"), JEpochs(day, sec, "tdb")


@pytest.fixture(scope="module")
def kernels():
    from pint_tpu.io.spk import SPKKernel as JKernel
    from pint_tpu_torch.io.spk import SPKKernel as TKernel

    return (TKernel(os.path.join(ROOT, "pint_tpu_torch", "data",
                                 "numeph_v1.bsp")),
            JKernel(os.path.join(ROOT, "pint_tpu", "data", "numeph_v1.bsp")))


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' kernel caches emptied for one test, and neither
    environment variable set."""
    import pint_tpu.ephemeris as jeph
    import pint_tpu_torch.ephemeris as teph

    for mod in (teph, jeph):
        monkeypatch.setattr(mod, "_KERNELS", {})
    monkeypatch.delenv("PINT_TPU_DISABLE_NUMEPH", raising=False)
    monkeypatch.delenv("PINT_TPU_EPHEM_DIR", raising=False)
    return teph, jeph


def test_kernel_copy_is_the_reference_file():
    """The port reads its own byte-for-byte copy of the shipped kernel
    and its description."""
    for name in ("numeph_v1.bsp", "numeph_v1.json"):
        digests = []
        for pkg in ("pint_tpu_torch", "pint_tpu"):
            with open(os.path.join(ROOT, pkg, "data", name), "rb") as fh:
                digests.append(hashlib.sha256(fh.read()).hexdigest())
        assert digests[0] == digests[1], name


def test_segments_match(kernels):
    tk, jk = kernels
    assert (tk.nd, tk.ni, tk.fward, tk.bward, tk.free) == (
        jk.nd, jk.ni, jk.fward, jk.bward, jk.free)
    assert len(tk.segments) == len(jk.segments) == 11
    for a, b in zip(tk.segments, jk.segments):
        ta, tb = tk.segment_for(a.target, a.center), jk.segment_for(
            b.target, b.center)
        assert vars(ta) == vars(tb)
    with pytest.raises(KeyError, match="no SPK segment 499 wrt 0"):
        tk.segment_for(499, 0)


@pytest.mark.parametrize("target,center", HOPS)
def test_spk_posvel_bitwise(kernels, target, center):
    """Every SPK hop of the body chains at seeded epochs across the
    coverage, its two ends and the record boundaries, bitwise equal."""
    from pint_tpu.io.spk import tdb_epochs_to_et as jet
    from pint_tpu_torch.io.spk import tdb_epochs_to_et as tet

    tk, jk = kernels
    rng = np.random.default_rng(target * 1000 + center)
    seg = jk.segment_for(target, center)
    mjd = np.concatenate([rng.uniform(MJD_LO, MJD_HI, 3000),
                          [MJD_LO, MJD_HI]])
    t, j = _epochs(mjd)
    et = tet(t.day, t.sec)
    np.testing.assert_array_equal(et, jet(j.day, j.sec))
    edges = seg.init + seg.intlen * np.arange(1, 40)
    et = np.concatenate([et, edges, edges - 1e-6])
    (tp, tv), (jp, jv) = tk.posvel(target, center, et), jk.posvel(
        target, center, et)
    assert tp.shape == tv.shape == (len(et), 3)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("body", sorted(CHAIN))
def test_numeph_tier_bitwise(fresh, body):
    """``objPosVel_wrt_SSB`` on the numeph tier, chains summed in km ->
    m as the JAX package sums them, bitwise."""
    teph, jeph = fresh
    assert teph._CHAIN_TO_SSB == jeph._CHAIN_TO_SSB == CHAIN
    rng = np.random.default_rng(len(body))
    t, j = _epochs(rng.uniform(MJD_LO, MJD_HI, 2000))
    a = teph.objPosVel_wrt_SSB(body, t, provider="numeph")
    b = jeph.objPosVel_wrt_SSB(body, j, provider="numeph")
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.vel, b.vel)
    assert (a.origin, a.obj) == (b.origin, b.obj) == ("ssb", body)


# epochs: inside, before, after, straddling each edge, exactly on them
PROVIDER_CASES = {
    "inside": [50000.0, 56700.5, 60000.0],
    "before": [39000.0, 39999.0],
    "after": [64001.0, 70000.0],
    "across_low": [39999.5, 40000.5],
    "across_high": [63999.5, 64000.5],
    "on_edges": [MJD_LO, MJD_HI],
}


@pytest.mark.parametrize("disabled", [False, True])
@pytest.mark.parametrize("case", sorted(PROVIDER_CASES))
def test_ephemeris_provider_matches(fresh, monkeypatch, case, disabled):
    """The tier each package picks, with the numeph kernel enabled and
    with ``PINT_TPU_DISABLE_NUMEPH=1``, and what each then returns for
    the Sun and the Earth (auto-resolved), bitwise."""
    teph, jeph = fresh
    if disabled:
        monkeypatch.setenv("PINT_TPU_DISABLE_NUMEPH", "1")
    t, j = _epochs(PROVIDER_CASES[case])
    got = teph.ephemeris_provider("de440s", t)
    assert got == jeph.ephemeris_provider("de440s", j)
    assert got == ("numeph" if case in ("inside", "on_edges")
                   and not disabled else "analytic")
    assert teph.ephemeris_provider() == jeph.ephemeris_provider()
    for body in ("sun", "earth"):
        a, b = teph.objPosVel_wrt_SSB(body, t), jeph.objPosVel_wrt_SSB(
            body, j)
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.vel, b.vel)


def test_spk_tier_from_the_ephem_dir(fresh, monkeypatch, tmp_path):
    """A ``<ephem>.bsp`` in ``$PINT_TPU_EPHEM_DIR`` takes the 'spk' tier
    in both packages, whatever the epochs, and is evaluated bitwise."""
    teph, jeph = fresh
    os.symlink(os.path.join(ROOT, "pint_tpu", "data", "numeph_v1.bsp"),
               tmp_path / "detorch.bsp")
    monkeypatch.setenv("PINT_TPU_EPHEM_DIR", str(tmp_path))
    t, j = _epochs([45000.0, 56700.25, 63000.0])
    assert teph.ephemeris_provider("detorch", t) == "spk"
    assert jeph.ephemeris_provider("detorch", j) == "spk"
    assert teph.ephemeris_provider("DETorch") == "spk"
    for body in ("earth", "moon", "sun"):
        a = teph.objPosVel_wrt_SSB(body, t, "detorch")
        b = jeph.objPosVel_wrt_SSB(body, j, "detorch")
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.vel, b.vel)


@pytest.mark.parametrize("body", ["sun", "earth", "jupiter_bary", "moon",
                                  "mars"])
def test_analytic_tier_bitwise(fresh, body):
    """The analytic series (outside the numeph coverage, or pinned),
    bitwise: both packages run the same numpy series."""
    teph, jeph = fresh
    t, j = _epochs([30000.0, 51544.5, 70000.25])
    a = teph.objPosVel_wrt_SSB(body, t, provider="analytic")
    b = jeph.objPosVel_wrt_SSB(body, j, provider="analytic")
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.vel, b.vel)


def _raised(fn):
    with pytest.raises((KeyError, ValueError)) as info:
        fn()
    return info.type, str(info.value)


def test_pinned_tier_errors_match(fresh, monkeypatch):
    """A pinned tier never falls back: the same exception, with the same
    message, in both packages: 'spk' without a kernel, 'numeph' for a
    body the kernel lacks, for epochs outside its coverage and with the
    kernel disabled, and an unknown body."""
    teph, jeph = fresh
    t, j = _epochs([56700.0])
    to, jo = _epochs([39000.0, 56700.0])
    cases = [
        (lambda e, x: e.objPosVel_wrt_SSB("sun", x, "nosuchkernel",
                                          provider="spk"), (t, j)),
        (lambda e, x: e.objPosVel_wrt_SSB("jupiter_bary", x,
                                          provider="numeph"), (t, j)),
        (lambda e, x: e.objPosVel_wrt_SSB("sun", x, provider="numeph"),
         (to, jo)),
        (lambda e, x: e._kernel_posvel(e._numeph_kernel()[0], "pluto", x),
         (t, j)),
    ]
    for fn, (x_t, x_j) in cases:
        got = _raised(lambda: fn(teph, x_t))
        assert got == _raised(lambda: fn(jeph, x_j))
    monkeypatch.setenv("PINT_TPU_DISABLE_NUMEPH", "1")
    got = _raised(lambda: teph.objPosVel_wrt_SSB("sun", t,
                                                 provider="numeph"))
    assert got[0] is KeyError and "unavailable" in got[1]
    assert got == _raised(lambda: jeph.objPosVel_wrt_SSB(
        "sun", j, provider="numeph"))


def test_numeph_fingerprint_matches(fresh, monkeypatch):
    """Coverage and content hash of the shipped kernel; the hash is the
    SHA-256 of the copied file; None when the tier is disabled."""
    teph, jeph = fresh
    fp = teph.numeph_fingerprint()
    assert fp == jeph.numeph_fingerprint()
    with open(os.path.join(ROOT, "pint_tpu_torch", "data",
                           "numeph_v1.bsp"), "rb") as fh:
        assert fp[2] == hashlib.sha256(fh.read()).hexdigest()
    assert teph._numeph_kernel()[0].path.startswith(
        os.path.join(ROOT, "pint_tpu_torch", "data"))
    monkeypatch.setenv("PINT_TPU_DISABLE_NUMEPH", "1")
    assert teph.numeph_fingerprint() is None is jeph.numeph_fingerprint()


@pytest.mark.parametrize("span", [(50000.0, 50400.0), (39000.0, 41000.0)])
def test_best_positions_icrs_matches(fresh, span):
    """Every body's position on a dense grid, from numeph in coverage
    and from the analytic series across its edge, bitwise."""
    teph, jeph = fresh
    mjd = np.linspace(*span, 97)
    (a, pa), (b, pb) = (teph.best_positions_icrs(mjd),
                        jeph.best_positions_icrs(mjd))
    assert pa == pb == ("numeph" if span[0] >= MJD_LO else "analytic")
    assert sorted(a) == sorted(b)
    for body in a:
        np.testing.assert_array_equal(a[body], b[body], err_msg=body)


@pytest.mark.parametrize("planets", [False, True])
def test_barycentre_posvels_match_compute_posvels(planets):
    """The port's barycentre posvels against the JAX package's
    ``TOAs.compute_posvels`` on the same TDB epochs: the tier, ``tdb``,
    ``ssb_obs`` (exactly zero), ``obs_sun`` and the planets, bitwise."""
    from pint_tpu.toa import TOAs as JTOAs
    from pint_tpu_torch.toa import TOAs

    rng = np.random.default_rng(21)
    day = rng.integers(55000, 58000, 400)
    sec = rng.uniform(0.0, 86400.0, 400)
    j = JTOAs.from_arrays(day, sec, obs="@", planets=planets)
    j.compute_posvels()
    t = TOAs.from_arrays(day, sec, obs="@")
    t.planets = planets
    t.compute_posvels()
    assert t.ephem == j.ephem == "de440s"
    assert t.ephem_provider == j.ephem_provider == "numeph"
    np.testing.assert_array_equal(t.tdb.day, j.tdb.day)
    np.testing.assert_array_equal(t.tdb.sec, j.tdb.sec)
    np.testing.assert_array_equal(t.ssb_obs.pos, j.ssb_obs.pos)
    np.testing.assert_array_equal(t.obs_sun.pos, j.obs_sun.pos)
    np.testing.assert_array_equal(t.obs_sun.vel, j.obs_sun.vel)
    assert sorted(t.planet_pos) == sorted(j.planet_pos)
    for p in t.planet_pos:
        np.testing.assert_array_equal(t.planet_pos[p], j.planet_pos[p])


def test_geocentre_posvels_take_the_tier():
    """The port's geocentre: the Earth with its velocity from the
    kernel at the table's TDB epochs (JAX ``GeocenterObs.posvel_ssb``),
    the Sun and the planets relative to it, bitwise to the JAX
    package's tier at the same epochs; out of the coverage, the
    analytic tier."""
    from pint_tpu import ephemeris as jeph
    from pint_tpu.mjd import Epochs as JEpochs
    from pint_tpu.observatory import get_observatory as jobs
    from pint_tpu_torch.toa import TOAs

    rng = np.random.default_rng(22)
    mjd = np.sort(rng.uniform(54000.0, 57000.0, 300))
    t, _ = _epochs(mjd)
    toas = TOAs.from_arrays(t.day, t.sec, obs="geocenter")
    toas.planets = True
    toas.compute_posvels()
    assert toas.ephem_provider == "numeph"
    j = JEpochs(toas.tdb.day, toas.tdb.sec, "tdb")
    earth = jobs("geocenter").posvel_ssb(j, j, "de440s", provider="numeph")
    np.testing.assert_array_equal(toas.ssb_obs.pos, earth.pos)
    np.testing.assert_array_equal(toas.ssb_obs.vel, earth.vel)
    assert 2.5e4 < np.linalg.norm(earth.vel, axis=1).min()  # ~30 km/s
    sun = jeph.objPosVel_wrt_SSB("sun", j, provider="numeph").pos
    np.testing.assert_array_equal(toas.obs_sun.pos, sun - earth.pos)
    for p in toas.PLANETS:
        pos = jeph.objPosVel_wrt_SSB(p, j, provider="numeph").pos
        np.testing.assert_array_equal(toas.planet_pos[p], pos - earth.pos)
    late = TOAs.from_arrays(np.array([70000]), np.array([0.0]),
                            obs="geocenter").compute_posvels()
    assert late.ephem_provider == "analytic"


def test_geocentre_epochs_match_jax(monkeypatch):
    """The geocentre on the fake TOAs of test_torch_models.py::jax_toas:
    both packages read the epochs as UTC and convert them through
    ``timescales.py``. On the numpy paths (each package's C++ host
    library switched off) the TDB epochs, the Earth (``ssb_obs``) and
    the Sun are bitwise equal, and both take the numeph tier (tier:
    host numpy, bitwise)."""
    import pint_tpu.native as jnative
    import pint_tpu_torch.native as tnative
    from pint_tpu.toa import TOAs as JTOAs
    from pint_tpu_torch.toa import TOAs
    from test_torch_models import EQUATORIAL, jax_toas

    _, jt = jax_toas(EQUATORIAL)
    monkeypatch.setattr(jnative, "_LIB", False)
    monkeypatch.setattr(tnative, "_LIB", False)
    j = JTOAs.from_arrays(jt.day, jt.sec, obs="geocenter")
    j.compute_posvels()
    t = TOAs.from_arrays(jt.day, jt.sec, obs="geocenter").compute_posvels()
    assert t.ephem_provider == j.ephem_provider == "numeph"
    np.testing.assert_array_equal(t.tdb.day, j.tdb.day)
    np.testing.assert_array_equal(t.tdb.sec, j.tdb.sec)
    np.testing.assert_array_equal(t.ssb_obs.pos, j.ssb_obs.pos)
    np.testing.assert_array_equal(t.ssb_obs.vel, j.ssb_obs.vel)
    np.testing.assert_array_equal(t.obs_sun.pos, j.obs_sun.pos)
    dt = (t.tdb.day - jt.day) * 86400.0 + (t.tdb.sec - jt.sec)
    assert 65.1 < dt.min() and dt.max() < 67.3  # TT - UTC + TDB - TT
    with pytest.raises(ValueError, match="weights"):
        TOAs.from_arrays(np.zeros(3), np.zeros(3), weights=np.ones(2))
