"""The port's polycos against the JAX package's, on the CPU: the seven
tests of tests/test_polycos.py mirrored, generation and evaluation held
to the JAX package's, the TEMPO file read across packages, the segment
finder's indices (MJDs exactly on shared boundaries included) and
photonphase --polycos.

Tolerances:
- generation: each segment's polynomial phase (RPHASE + 60 F0 DT +
  sum COEFF DT^k) within 1e-9 cycles of the JAX package's over the
  segment (the node phases differ by ulps between the packages);
- evaluation from equal coefficients, the finder, the file text:
  bitwise (host numpy in both packages);
- photonphase --polycos: PULSE_PHASE to 1e-9 cycles, H to 1e-9
  relative.
"""

import contextlib
import io

import numpy as np
import pytest

PAR = """
PSR POLYTEST
RAJ 05:00:00.0
DECJ 20:00:00.0
F0 29.946923 1
F1 -3.77535e-10 1
PEPOCH 55555
DM 56.77
"""


@pytest.fixture(scope="module")
def model():
    from pint_tpu_torch.models import get_model

    return get_model(PAR)


@pytest.fixture(scope="module")
def polycos(model):
    from pint_tpu_torch.polycos import Polycos

    return Polycos.generate_polycos(model, 55555.0, 55555.25, obs="gbt",
                                    segLength=60, ncoeff=12, device="cpu")


@pytest.fixture(scope="module")
def jax_polycos():
    from pint_tpu.models import get_model
    from pint_tpu.polycos import Polycos

    return Polycos.generate_polycos(get_model(PAR), 55555.0, 55555.25,
                                    obs="gbt", segLength=60, ncoeff=12)


def test_segment_count(polycos):
    assert len(polycos.entries) == 6  # 0.25 d / 60 min


def test_phase_prediction_matches_model(model, polycos):
    from pint_tpu_torch.polycos import _model_abs_phase

    rng = np.random.default_rng(3)
    mjds = 55555.0 + 0.25 * rng.random(16)
    pi_ref, pf_ref = _model_abs_phase(model, mjds, "gbt", 1400.0,
                                      device="cpu")
    pi_pc, pf_pc = polycos.eval_abs_phase(mjds)
    dphi = (pi_pc - pi_ref).astype(float) + (pf_pc - pf_ref)
    assert np.max(np.abs(dphi)) < 1e-7


def test_spin_freq_close_to_f0(model, polycos):
    f = polycos.eval_spin_freq(np.array([55555.05, 55555.15]))
    assert np.allclose(f, model.F0.value, rtol=1e-4)
    assert not np.allclose(f, model.F0.value, rtol=1e-9)


def test_polyco_file_roundtrip(tmp_path, polycos):
    from pint_tpu_torch.polycos import Polycos

    path = tmp_path / "polyco.dat"
    polycos.write_polyco_file(path)
    back = Polycos.read_polyco_file(path)
    assert len(back.entries) == len(polycos.entries)
    mjds = np.array([55555.03, 55555.21])
    pi1, pf1 = polycos.eval_abs_phase(mjds)
    pi2, pf2 = back.eval_abs_phase(mjds)
    assert np.max(np.abs((pi2 - pi1).astype(float) + (pf2 - pf1))) < 2e-6


def test_out_of_span_raises(polycos):
    with pytest.raises(ValueError, match="outside polyco span"):
        polycos.eval_abs_phase([55560.0])


def test_negative_rphase_roundtrip(tmp_path):
    from pint_tpu.polycos import Polycos as JP
    from pint_tpu_torch.polycos import PolycoEntry, Polycos

    pc = Polycos([PolycoEntry(55000.0, 60, -12345, 0.6789, 30.0, 3,
                              [0.0, 1e-8, 1e-12])])
    path = tmp_path / "neg.dat"
    pc.write_polyco_file(path)
    line2 = open(path).read().splitlines()[1].split()[0]
    assert float(line2) == pytest.approx(-12345 + 0.6789, abs=1e-6)
    for reader in (Polycos, JP):
        b = reader.read_polyco_file(path).entries[0]
        assert b.rphase_int + b.rphase_frac == pytest.approx(
            -12345 + 0.6789, abs=1e-6)


def test_eval_phase_wrapped(polycos):
    ph = polycos.eval_phase(np.linspace(55555.01, 55555.24, 10))
    assert np.all(np.abs(ph) <= 0.5)


def test_generation_matches_jax(polycos, jax_polycos):
    """Each segment's polynomial phase within 1e-9 cycles of the JAX
    package's over the segment; the same integers and the same fixed
    fields."""
    assert len(polycos.entries) == len(jax_polycos.entries)
    for a, b in zip(polycos.entries, jax_polycos.entries):
        assert (a.tmid, a.mjdspan, a.f0, a.ncoeff, a.obs, a.obsfreq,
                a.psrname) == (b.tmid, b.mjdspan, b.f0, b.ncoeff, b.obs,
                               b.obsfreq, b.psrname)
        assert a.rphase_int == b.rphase_int
        mjds = np.linspace(a.start, a.stop, 101)
        ai, af = a.abs_phase(mjds)
        bi, bf = b.abs_phase(mjds)
        assert np.max(np.abs((ai - bi).astype(float) + (af - bf))) <= 1e-9


def test_evaluation_and_finder_bitwise(jax_polycos):
    """From the same segments the port's binary-search finder and its
    grouped Horner give the JAX loop's indices and phases bitwise,
    MJDs exactly on shared boundaries (the lower segment wins) and on
    the outer edges included; unordered segments take the scan."""
    from pint_tpu_torch.polycos import PolycoEntry, Polycos

    es = jax_polycos.entries
    port = Polycos(es)
    rng = np.random.default_rng(4)
    mjds = np.concatenate([55555.0 + 0.25 * rng.random(2000),
                           [e.start for e in es], [e.stop for e in es]])
    np.testing.assert_array_equal(port._find(mjds)[1],
                                  jax_polycos._find(mjds)[1])
    for a, b in zip(port.eval_abs_phase(mjds),
                    jax_polycos.eval_abs_phase(mjds)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.eval_spin_freq(mjds),
                                  jax_polycos.eval_spin_freq(mjds))
    np.testing.assert_array_equal(port.eval_phase(mjds),
                                  jax_polycos.eval_phase(mjds))
    # overlapping, unordered segments with mixed coefficient counts
    from pint_tpu.polycos import Polycos as JP

    mixed = [es[3], es[0], PolycoEntry(es[1].tmid, 120, 7, 0.25, 29.9, 4,
                                       [0.0, 1e-3, 2e-7, 1e-11]), es[2]]
    jm = JP(mixed)
    inside = np.concatenate([
        min(e.start for e in mixed) + rng.random(500) * (
            max(e.stop for e in mixed) - min(e.start for e in mixed)),
        [e.start for e in mixed], [e.stop for e in mixed]])
    for a, b in zip(Polycos(mixed)._find(inside), jm._find(inside)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(Polycos(mixed).eval_abs_phase(inside),
                    jm.eval_abs_phase(inside)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="outside polyco span"):
        Polycos(mixed).eval_abs_phase([es[-1].stop])


def test_polyco_files_read_across_packages(tmp_path, polycos, jax_polycos):
    from pint_tpu.polycos import Polycos as JP
    from pint_tpu_torch.polycos import Polycos

    polycos.write_polyco_file(tmp_path / "t.dat")
    jax_polycos.write_polyco_file(tmp_path / "j.dat")
    Polycos(jax_polycos.entries).write_polyco_file(tmp_path / "tj.dat")
    assert (tmp_path / "tj.dat").read_text() == (tmp_path / "j.dat").read_text()
    mjds = np.linspace(55555.001, 55555.249, 300)
    for name in ("t.dat", "j.dat"):
        a = Polycos.read_polyco_file(tmp_path / name)
        b = JP.read_polyco_file(tmp_path / name)
        for x, y in zip(a.eval_abs_phase(mjds), b.eval_abs_phase(mjds)):
            np.testing.assert_array_equal(x, y)


def test_photonphase_polycos_matches_jax(tmp_path):
    """photonphase --polycos on 20,000 barycentred photons over 0.5 d:
    the port's run against the JAX script's (PULSE_PHASE to 1e-9
    cycles, H to 1e-9 relative) and against the port's direct run
    (the f64 MJDs the polycos take hold it to F0 x half an ulp of the
    MJD, 1e-5 cycles)."""
    from pint_tpu.eventstats import hmw
    from pint_tpu.io.fits import get_table as jget_table
    from pint_tpu.scripts.photonphase import main as jmain
    from pint_tpu_torch.io.fits import get_table, write_fits_table
    from pint_tpu_torch.scripts.photonphase import main as tmain

    ref = 56658.000777592593
    rng = np.random.default_rng(8)
    n, f0 = 20_000, 29.946923
    pulse = rng.integers(0, int(0.5 * 86400 * f0), n)
    ph = (rng.vonmises(2 * np.pi * 0.3, 8.0, n) / (2 * np.pi)) % 1.0
    met = np.sort((pulse + ph) / f0 + (56700 - ref) * 86400)
    evt = tmp_path / "bary.fits"
    write_fits_table(evt, {"TIME": met, "PSRPROB": rng.random(n)},
                     {"MJDREFI": int(ref), "MJDREFF": ref - int(ref),
                      "TIMESYS": "TDB", "TELESCOP": "NICER"})
    par = tmp_path / "p.par"
    par.write_text(PAR.replace("55555", "56700"))
    base = [str(evt), str(par), "--weightcol", "PSRPROB"]
    outs = {}
    for name, main, extra in (
            ("jax", jmain, ["--polycos"]),
            ("torch", tmain, ["--polycos", "--device", "cpu"]),
            ("direct", tmain, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(base + extra + ["--outfile",
                                      str(tmp_path / f"{name}.fits")])
        assert rc == 0
        outs[name] = buf.getvalue()
    assert "Generated 13 polyco segments" in outs["torch"]
    j = jget_table(tmp_path / "jax.fits", "EVENTS")[1]
    t = get_table(tmp_path / "torch.fits", "EVENTS")[1]
    d = get_table(tmp_path / "direct.fits", "EVENTS")[1]["PULSE_PHASE"]

    def gap(a, b):
        x = np.abs(a - b)
        return np.minimum(x, 1 - x).max()

    assert gap(t["PULSE_PHASE"], j["PULSE_PHASE"]) <= 1e-9
    assert gap(t["PULSE_PHASE"], d) <= 1e-5

    def h_of(text):
        return float(next(line.split("=", 1)[1] for line in text.splitlines()
                          if line.startswith("H = ")))

    h_j = float(hmw(j["PULSE_PHASE"], j["PSRPROB"]))
    assert abs(h_of(outs["torch"]) - h_j) <= 1e-9 * h_j
    assert abs(h_of(outs["torch"]) - h_of(outs["direct"])) <= 1e-5 * h_j
