"""The port's timing model (pint_tpu_torch/models) against the JAX
package's, module by module, on the same TOAs.

TOAs come from the JAX package's own fake-TOA maker (barycentred there)
and reach the port through the adapter below, which copies the
barycentred columns; par files are the bench template (EFAC/EQUAD/ECORR,
power-law red noise) and an ecliptic (ELONG/ELAT) variant of it.

Tolerances: both packages evaluate the same f64 expressions, so delays
agree to 1e-12 s; the total phase to 1e-9 cycles (its largest term,
delay x spin frequency ~1e5 cycles, carries ~1e-11 cycles of rounding);
sigma, noise bases and weights to 1e-12 relative; design-matrix columns
to 1e-9 of their max (forward-mode derivatives of the same phase).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

EQUATORIAL = ("PSR BEN1\nRAJ 1:07:00.0\nDECJ -27:30:00.0\n"
              "F0 155.318 1\nF1 -3e-16 1\nPEPOCH 55500\nDM 9.21 1\n"
              "EFAC -f L-wide 1.1\nEQUAD -f L-wide 0.4\n"
              "ECORR -f L-wide 0.8\nRNAMP 1e-14\nRNIDX -3.1\nTNREDC 10\n")
ECLIPTIC = EQUATORIAL.replace("RAJ 1:07:00.0\nDECJ -27:30:00.0\n",
                              "ELONG 31.5 1\nELAT -12.25\nPMELONG 3.1\n"
                              "PMELAT -1.7\nPX 0.9\n")


def port_toas(jt):
    """The JAX package's TOAs as the port's barycentred TOAs."""
    from pint_tpu_torch.mjd import Epochs
    from pint_tpu_torch.toa import TOAs
    from pint_tpu_torch.utils import PosVel

    return TOAs.from_arrays(
        jt.day, jt.sec, error_us=jt.error_us, freq_mhz=jt.freq_mhz,
        obs=jt.obs, flags=[dict(f) for f in jt.flags],
        tdb=Epochs(jt.tdb.day, jt.tdb.sec, "tdb", jt.tdb.lo),
        ssb_obs=PosVel(jt.ssb_obs.pos, jt.ssb_obs.vel),
        obs_sun=PosVel(jt.obs_sun.pos, jt.obs_sun.vel),
        planet_pos=dict(jt.planet_pos))


def jax_toas(par, n_epochs=60, seed=0):
    """JAX model + fake TOAs: 4 TOAs per epoch at 800/1400 MHz."""
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    rng = np.random.default_rng(seed)
    days = np.sort(rng.uniform(54000, 57000, n_epochs))
    mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
    freqs = np.where(np.arange(len(mjds)) % 2, 1400.0, 800.0)
    jm = get_model(par)
    jt = make_fake_toas_fromMJDs(mjds, jm, error_us=1.0, freq_mhz=freqs,
                                 obs="gbt", iterations=0)
    for f in jt.flags:
        f["f"] = "L-wide"
    return jm, jt


@pytest.fixture(scope="module", params=["equatorial", "ecliptic"])
def pair(request):
    from pint_tpu_torch.models import get_model

    par = EQUATORIAL if request.param == "equatorial" else ECLIPTIC
    jm, jt = jax_toas(par)
    tm = get_model(par)
    return jm, jm.prepare(jt), tm, tm.prepare(port_toas(jt), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_components_and_pack_match(pair):
    jm, jp, tm, tp = pair
    assert list(tm.components) == list(jm.components)
    assert tm.free_params == jm.free_params
    for k, v in jp.prep.items():
        a = np.asarray(v)
        if a.dtype.kind not in "biuf" or a.dtype.itemsize > 8:
            continue  # longdouble host copy / static config
        b = tp.prep[k]
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=k)


def test_delays_per_component(pair):
    jm, jp, tm, tp = pair
    dj = np.zeros(jp.batch.n_toas)
    dt = torch.zeros(tp.batch.n_toas, dtype=torch.float64)
    for cj, ct in zip(jm.delay_components(), tm.delay_components()):
        a = np.asarray(cj.delay(jp.params0, jp.batch, jp.prep, dj))
        b = ct.delay(tp.params0, tp.batch, tp.prep, dt).numpy()
        assert np.abs(a - b).max() <= 1e-12, type(ct).__name__
        dj, dt = dj + a, dt + torch.as_tensor(b)
    assert np.abs(np.asarray(jp.delay()) - tp.delay().numpy()).max() <= 1e-12


def test_phase_sigma_and_design(pair):
    _, jp, _, tp = pair
    fj, ij = jp.phase_frac_and_int()
    ft, it = tp.phase_frac_and_int()
    assert np.abs(np.asarray(fj) - ft.numpy()).max() <= 1e-9
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    assert _rel(tp.scaled_sigma_us(), jp.scaled_sigma_us()) <= 1e-12
    Mj, lj = jp.designmatrix()
    Mt, lt = tp.designmatrix()
    assert lt == lj
    Mj = np.asarray(Mj)
    assert np.all(np.abs(Mt.numpy() - Mj).max(0)
                  <= 1e-9 * np.abs(Mj).max(0))
    x = tp.vector_from_params()
    rj = np.asarray(jp.residual_vector_fn()(np.asarray(x)))
    assert np.abs(tp.residual_vector_fn()(x).numpy() - rj).max() <= 1e-12


def test_noise_bases_and_weights(pair):
    jm, jp, tm, tp = pair
    for name in ("EcorrNoise", "PLRedNoise"):
        Bj, wj = jm.components[name].basis_weight(jp.params0, jp.prep)
        Bt, wt = tm.components[name].basis_weight(tp.params0, tp.prep)
        np.testing.assert_array_equal(Bt.numpy(), np.asarray(Bj))
        assert _rel(wt, wj) <= 1e-12, name


def test_from_numpy_matches_prepare(pair):
    """PreparedTiming.from_numpy on the JAX package's packed arrays
    gives the port's phase and design matrix bit-for-bit inputs."""
    from pint_tpu_torch.models.timing_model import PreparedTiming
    from pint_tpu.toa import TOABatch

    jm, jp, tm, tp = pair
    prep = {k: np.asarray(v) for k, v in jp.prep.items() if k != "T_ld"}
    fields = {f: np.asarray(getattr(jp.batch, f)) for f in TOABatch._fields}
    params = {k: np.asarray(v) for k, v in jp.params0.items()}
    tq = PreparedTiming.from_numpy(tm, params, prep, fields, device="cpu")
    np.testing.assert_array_equal(tq.phase_frac_and_int()[0].numpy(),
                                  tp.phase_frac_and_int()[0].numpy())
    np.testing.assert_array_equal(tq.designmatrix()[0].numpy(),
                                  tp.designmatrix()[0].numpy())


def test_phase_keywords_match_the_jax_package(pair):
    """prepare(subtract_mean=...), phase(abs_phase=...) and
    PreparedTiming(subtract_mean=...) are accepted as in the JAX package,
    which stores the first and ignores the second: the same phase."""
    from pint_tpu_torch.models.timing_model import PreparedTiming

    jm, jp, tm, tp = pair
    tq = tm.prepare(tp.toas, subtract_mean=False, device="cpu")
    assert (tq.subtract_mean, tp.subtract_mean) == (False, True) \
        == (jm.prepare(jp.toas, subtract_mean=False).subtract_mean,
            jp.subtract_mean)
    assert PreparedTiming(tm, tp.toas, subtract_mean=False,
                          device="cpu").subtract_mean is False
    np.testing.assert_array_equal(tq.phase_frac_and_int()[0].numpy(),
                                  tp.phase_frac_and_int()[0].numpy())
    pj = jm.phase(jp.toas, abs_phase=True)
    pt = tm.phase(tp.toas, abs_phase=True, device="cpu")
    np.testing.assert_array_equal(pt.int_.numpy(), np.asarray(pj.int_))
    assert np.abs(pt.frac.numpy() - np.asarray(pj.frac)).max() <= 1e-9
    np.testing.assert_array_equal(
        pt.frac.numpy(), tm.phase(tp.toas, device="cpu").frac.numpy())


NGC_JAX_PAR = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.par"
NGC_JAX_TIM = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.tim"
NGC_PORT_PAR = ROOT / "pint_tpu_torch" / "data" / "examples" / "NGC6440E.par"
SPIN_F3 = EQUATORIAL.replace("F1 -3e-16 1\n",
                             "F1 -3e-16 1\nF2 1e-24 1\nF3 -1e-32\n")


@pytest.fixture(scope="module", params=["ngc6440e", "f0-f3"])
def spin(request):
    """(JAX model, its PreparedTiming, port model, its PreparedTiming):
    the NGC6440E example (F0, F1) through the JAX package's get_TOAs, and
    a seeded fake pulsar with F0-F3."""
    from pint_tpu_torch.models import get_model

    if request.param == "ngc6440e":
        from pint_tpu.models import get_model as jget_model
        from pint_tpu.toa import get_TOAs as jget_TOAs

        jm = jget_model(str(NGC_JAX_PAR))
        jt = jget_TOAs(str(NGC_JAX_TIM), model=jm)
        tm = get_model(str(NGC_PORT_PAR))
    else:
        jm, jt = jax_toas(SPIN_F3, seed=21)
        tm = get_model(SPIN_F3)
    return jm, jm.prepare(jt), tm, tm.prepare(port_toas(jt), device="cpu")


def _freq_ld(F, T_ld, delay):
    """sum_i F_i (T - d)^i / i! in np.longdouble."""
    from pint_tpu_torch.mjd import LD

    T = T_ld - LD(1.0) * np.asarray(delay, np.float64)
    out, fact, Tp = np.zeros_like(T), LD(1.0), np.ones_like(T)
    for i, f in enumerate(np.asarray(F, np.float64)):
        fact = fact * LD(max(i, 1))
        out = out + LD(f) * Tp / fact
        Tp = Tp * T
    return out


def test_spin_frequency_at_emission_matches_jax(spin):
    """Spindown.d_phase_d_toa_freq: the port vs the JAX package at 1e-12
    relative (the same f64 expressions), both vs a longdouble evaluation
    of sum F_i (T - d)^i / i! at 1e-12, and at the barycentre with zero
    delay F0 + F1 T + F2 T^2/2 + F3 T^3/6."""
    from pint_tpu_torch.models.spindown import Spindown

    jm, jp, tm, tp = spin
    sj, st = jm.components["Spindown"], tm.components["Spindown"]
    assert Spindown().setup() is None and st.setup() is None
    n_f = len(tp.prep["F_ref"])
    assert n_f == (2 if "TZRMJD" in tm.params else 4)
    dj, dt = jp.delay(), tp.delay()
    fj = np.asarray(sj.d_phase_d_toa_freq(jp.params0, jp.batch, jp.prep, dj))
    ft = st.d_phase_d_toa_freq(tp.params0, tp.batch, tp.prep, dt)
    assert isinstance(ft, torch.Tensor) and ft.dtype == torch.float64
    assert ft.shape == (tp.batch.n_toas,)
    assert _rel(ft, fj) <= 1e-12
    ref = _freq_ld(tp.params0["F"].numpy(), tp.prep["T_ld"], dt.numpy())
    for got in (ft.numpy(), fj):
        assert np.max(np.abs(got - ref) / np.abs(ref)) <= 1e-12
    # the host prep before host_to_device: numpy in, numpy out, bitwise
    host = {k: tp.prep[k].numpy() for k in ("T_hi", "T_lo", "F_ref")}
    fh = st.d_phase_d_toa_freq({"F": tp.params0["F"].numpy()}, None, host,
                               dt.numpy())
    np.testing.assert_array_equal(fh, ft.numpy())
    zero = torch.zeros_like(dt)
    f0 = st.d_phase_d_toa_freq(tp.params0, tp.batch, tp.prep, zero).numpy()
    F = tp.params0["F"].numpy()
    T = (tp.prep["T_hi"] + tp.prep["T_lo"]).numpy()
    want = F[0] + F[1] * T
    if n_f == 4:
        want = want + F[2] * T ** 2 / 2 + F[3] * T ** 3 / 6
    np.testing.assert_allclose(f0, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("overlap", [False, True])
def test_vectorised_ecorr_pack_is_identical(overlap):
    """The port's one-sort EcorrNoise.pack against the JAX package's
    per-epoch loop: the same epoch index, owners and (for overlapping
    masks) the same dense basis."""
    from pint_tpu_torch.models import get_model

    par = EQUATORIAL + "ECORR -f S-wide 0.5\n"
    if overlap:
        par += "ECORR mjd 54000 55500 0.3\n"
    jm, jt = jax_toas(par, n_epochs=80, seed=3)
    rng = np.random.default_rng(4)
    for f in jt.flags:  # two receivers, plus singleton epochs
        f["f"] = "S-wide" if rng.random() < 0.3 else "L-wide"
    jprep, tprep = {}, {}
    jm.components["EcorrNoise"].pack(jm, jt, jprep, {})
    get_model(par).components["EcorrNoise"].pack(None, port_toas(jt),
                                                 tprep, {})
    assert sorted(tprep) == sorted(jprep)
    assert ("ecorr_U" in tprep) == overlap
    for k in jprep:
        np.testing.assert_array_equal(np.asarray(tprep[k]),
                                      np.asarray(jprep[k]), err_msg=k)


def test_fake_toas_have_zero_residuals():
    """The port's geocentric fake-TOA maker gives residuals far below
    the 1 us errors: the iteration converges geometrically (~1e-4 per
    step, the Earth's orbital speed over c) down to the f64 grid of the
    TOA's seconds of day, ulp(86400 s) = 1.5e-11 s."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    m = get_model(EQUATORIAL)
    mjds = np.linspace(54000, 57000, 120)
    t = make_fake_toas_fromMJDs(mjds, m, freq_mhz=1400.0, iterations=3,
                                device="cpu")
    p = m.prepare(t, device="cpu")
    r = p.residual_vector_fn(subtract_mean=False)(p.vector_from_params())
    assert float(r.abs().max()) < 1e-10


def test_builder_names_unported_components():
    """Nothing of the JAX package's builder is left unported: the
    tempo1 P0/P1 spin spelling converts to F0/F1 with a warning, as the
    JAX package's does (bitwise: tests/test_torch_utils.py), and DMX
    and the binary models build."""
    from pint_tpu_torch.models import get_model

    with pytest.warns(UserWarning, match="converted P0/P1/P2"):
        m = get_model(EQUATORIAL.replace("F0 155.318 1\nF1 -3e-16 1\n",
                                         "P0 0.006438 1\nP1 1.2e-20 1\n"))
    assert m.F0.value == 1.0 / 0.006438 and not m.F1.frozen
    m = get_model(EQUATORIAL + "DMX 14.0\nDMX_0001 0.001 1\n"
                  "DMXR1_0001 54000\nDMXR2_0001 55000\n"
                  "BINARY ELL1\nPB 1.5\nA1 2.0\nTASC 55000\n")
    assert {"DispersionDMX", "BinaryELL1"} <= set(m.components)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """With no card, every entry point that defaults to device="cuda"
    raises instead of quietly running on the CPU."""
    from pint_tpu_torch import eventstats
    from pint_tpu_torch.event_toas import load_event_TOAs
    from pint_tpu_torch.io.fits import write_fits_table
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.parallel.pta import PTABatch, PTAFleet
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = get_model(EQUATORIAL)
    mjds = np.linspace(54000, 57000, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fake_toas_fromMJDs(mjds, m)
    t = make_fake_toas_fromMJDs(mjds, m, device="cpu")
    write_fits_table(tmp_path / "e.fits", {"TIME": np.linspace(0, 1e5, 64)},
                     {"MJDREFI": 56658, "MJDREFF": 7.7e-4, "TIMESYS": "TDB"})
    ev = load_event_TOAs(tmp_path / "e.fits", "nicer")
    ph = np.linspace(0, 1, 64)
    for call in (lambda: m.prepare(t), lambda: t.to_batch(),
                 lambda: PTABatch([m], [t]), lambda: PTAFleet([m], [t]),
                 lambda: m.phase(t), lambda: m.prepare(ev),
                 lambda: eventstats.hm(ph), lambda: eventstats.z2m(ph),
                 lambda: eventstats.hm_scan(lambda f: f * ph, [1.0, 2.0])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


_IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|pint_tpu)\b", re.M)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "pint_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"pint_tpu_torch/config.py", "pint_tpu_torch/logging_setup.py",
            "pint_tpu_torch/graphs.py", "pint_tpu_torch/parallel/pta.py",
            *(f"pint_tpu_torch/scripts/{s}.py" for s in (
                "pintempo", "zima", "convert_parfile", "compare_parfiles",
                "tcb2tdb", "t2binary2pint", "pintbary", "pintpublish"))
            } <= names
    for f in files:
        assert not _IMPORT_RE.search(f.read_text()), f
