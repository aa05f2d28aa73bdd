"""The port's narrowband Residuals and AbsPhase against the JAX
package's, on the CPU, on TOAs read through each package's own
get_TOAs (the NGC6440E example) or made by each package's fake-TOA
maker at GBT.

Tolerances: both packages evaluate the same f64 phase expressions, so
phase residuals agree to 1e-9 cycles (phase arithmetic tier; the
largest term, delay x F0 ~ 3e4 cycles, carries ~1e-11 cycles of
rounding) and time residuals to 1e-9 cycles / F0; the golden NGC6440E
prefit residuals are held to their own 1e-3 us, and sums over the
residuals (chi2, the weighted rms, the epoch averages) to 1e-9
relative. The par file is the unmodified example (SolarWindDispersion
and TroposphereDelay with zero delays); the first test shows that
dropping those two lines changes nothing in the JAX package.
"""

import numpy as np
import pytest

from test_torch_ingest import NGC_PAR, NGC_TIM, ROOT

JAX_PAR = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.par"
JAX_TIM = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.tim"
GOLDEN = ROOT / "pint_tpu_torch" / "data" / "examples" / "NGC6440E_prefit_resids_us.npy"


def stripped_ngc_par():
    """NGC6440E.par without SOLARN0 and CORRECT_TROPOSPHERE."""
    return "".join(line + "\n" for line in NGC_PAR.read_text().splitlines()
                   if not line.startswith(("SOLARN0", "CORRECT_TROPOSPHERE")))


@pytest.fixture(scope="module")
def ngc():
    """(port model, port TOAs, JAX model, JAX TOAs) for NGC6440E, each
    package through its own get_TOAs."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.toa import get_TOAs as jget_TOAs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    m = get_model(str(NGC_PAR))
    jm = jget_model(str(JAX_PAR))
    return m, get_TOAs(NGC_TIM, model=m), jm, jget_TOAs(JAX_TIM, model=jm)


def test_stripped_par_lines_change_nothing_in_jax():
    """SOLARN0 0.00 and CORRECT_TROPOSPHERE N give exactly zero delays:
    the JAX package's prefit residuals and delays with the full par
    file and with the two lines dropped are bitwise equal."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.residuals import Residuals as JResiduals
    from pint_tpu.toa import get_TOAs as jget_TOAs

    full = jget_model(str(JAX_PAR))
    cut = jget_model(stripped_ngc_par())
    assert {"SolarWindDispersion", "TroposphereDelay"} <= set(full.components)
    assert not {"SolarWindDispersion", "TroposphereDelay"} & set(cut.components)
    t = jget_TOAs(JAX_TIM, model=full)
    np.testing.assert_array_equal(np.asarray(JResiduals(t, full).time_resids),
                                  np.asarray(JResiduals(t, cut).time_resids))
    np.testing.assert_array_equal(np.asarray(full.delay(t)),
                                  np.asarray(cut.delay(t)))


def test_ngc6440e_residuals_match_jax_and_golden(ngc):
    """Prefit residuals of NGC6440E with AbsPhase (TZR at GBT): phase
    residuals to 1e-9 cycles of the JAX package's, time residuals to the
    golden .npy's 1e-3 us, the weighted rms to the JAX golden test's
    24.266879 us within 1e-3 us, and chi2 to 1e-9 relative with the
    same dof."""
    from pint_tpu.residuals import Residuals as JResiduals
    from pint_tpu_torch.residuals import Residuals

    m, t, jm, jt = ngc
    assert list(m.components) == list(jm.components) == [
        "Spindown", "AstrometryEquatorial", "DispersionDM",
        "SolarSystemShapiro", "SolarWindDispersion", "TroposphereDelay",
        "AbsPhase"]
    r, jr = Residuals(t, m, device="cpu"), JResiduals(jt, jm)
    assert np.abs(r.phase_resids - np.asarray(jr.phase_resids)).max() <= 1e-9
    f0 = m.F0.value
    assert np.abs(r.time_resids
                  - np.asarray(jr.time_resids)).max() <= 1e-9 / f0
    golden = np.load(GOLDEN)
    assert r.time_resids.shape == golden.shape
    np.testing.assert_allclose(r.time_resids * 1e6, golden, rtol=0, atol=1e-3)
    assert abs(r.rms_weighted() * 1e6 - 24.266879) < 1e-3
    assert r.dof == jr.dof == 62 - 5 - 1  # RAJ, DECJ, F0, F1, DM free
    assert abs(r.chi2 - jr.chi2) <= 1e-9 * jr.chi2
    assert abs(r.reduced_chi2 - jr.reduced_chi2) <= 1e-9 * jr.reduced_chi2
    assert abs(r.lnlikelihood() - jr.lnlikelihood()) <= 1e-9 * abs(
        jr.lnlikelihood())
    sigma_min_s = t.error_us.min() * 1e-6
    np.testing.assert_allclose(r.calc_whitened_resids().numpy(),
                               np.asarray(jr.calc_whitened_resids()),
                               rtol=0, atol=1e-9 / f0 / sigma_min_s)


def test_tzr_phase_matches_jax_and_caches(ngc, monkeypatch):
    """AbsPhase: the TZR TOA (TZRSITE 1 = GBT, TZRFRQ 1949.609 MHz)
    goes through the port's chain to the JAX package's TDB epoch and
    posvels bitwise; its phase matches to 1e-9 cycles with the same
    integer; a second prepare reuses the cached phase (keyed on the par
    file's text) and a changed parameter recomputes it."""
    from pint_tpu_torch.models.absolute_phase import AbsPhase

    m, t, jm, jt = ngc
    comp, jcomp = m.components["AbsPhase"], jm.components["AbsPhase"]
    tz, jtz = comp.get_TZR_toa(m), jcomp.get_TZR_toa(jm)
    assert list(tz.obs) == list(jtz.obs) == ["1"]
    np.testing.assert_array_equal(tz.tdb.sec, jtz.tdb.sec)
    np.testing.assert_array_equal(tz.ssb_obs.pos, jtz.ssb_obs.pos)
    assert tz.freq_mhz[0] == jtz.freq_mhz[0] == 1949.609
    p = m.prepare(t, device="cpu")
    jp = jm.prepare(jt)
    assert abs(float(p.prep["tzr_frac"]) - float(jp.prep["tzr_frac"])) <= 1e-9
    assert comp._tzr_cache[1] == jcomp._tzr_cache[1]
    np.testing.assert_array_equal(p.prep["phi_ref_int"].numpy(),
                                  np.asarray(jp.prep["phi_ref_int"]))

    def boom(self, model):
        raise AssertionError("the cached TZR phase was not reused")

    monkeypatch.setattr(AbsPhase, "get_TZR_toa", boom)
    m.prepare(t, device="cpu")
    monkeypatch.undo()
    old = comp._tzr_cache
    m.F0.value = m.F0.value + 1e-9
    try:
        m.prepare(t, device="cpu")
        assert comp._tzr_cache[0] != old[0]
    finally:
        m.F0.value = m.F0.value - 1e-9


def test_pulse_number_tracking_matches_jax(ngc):
    """Residuals with use_pulse_numbers: compute_pulse_numbers writes
    the JAX package's -pn flags (the phase on the CPU), and the tracked
    residuals, without mean subtraction and with an unweighted mean,
    match to 1e-9 cycles."""
    from pint_tpu.residuals import Residuals as JResiduals
    from pint_tpu_torch.residuals import Residuals

    m, t, jm, jt = ngc
    t2, jt2 = t.mask(np.ones(len(t), bool)), jt.mask(np.ones(len(jt), bool))
    pn = t2.compute_pulse_numbers(m, device="cpu")
    np.testing.assert_array_equal(pn, jt2.compute_pulse_numbers(jm))
    assert [f["pn"] for f in t2.flags] == [f["pn"] for f in jt2.flags]
    for kw in ({"subtract_mean": False}, {"use_weighted_mean": False}, {}):
        r = Residuals(t2, m, track_mode="use_pulse_numbers", device="cpu",
                      **kw)
        jr = JResiduals(jt2, jm, track_mode="use_pulse_numbers", **kw)
        assert np.abs(r.phase_resids
                      - np.asarray(jr.phase_resids)).max() <= 1e-9


def test_ecorr_average_matches_jax():
    """Epoch averages on the bench par template (EFAC/EQUAD/ECORR, red
    noise) over GBT fake TOAs from the port's maker, fed to both
    packages: the same groups, and the averaged residuals, errors and
    epochs to 1e-9 relative, with and without the noise model."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.residuals import Residuals as JResiduals
    from pint_tpu.toa import TOAs as JTOAs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.residuals import Residuals
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs
    from test_torch_models import EQUATORIAL

    m = get_model(EQUATORIAL)
    rng = np.random.default_rng(13)
    days = np.sort(rng.uniform(54000, 57000, 25))
    mjds = (days[:, None] + np.arange(4) * 0.5 / 86400.0).reshape(-1)
    t = make_fake_toas_fromMJDs(mjds, m, iterations=1, add_noise=True,
                                seed=2, flags={"f": "L-wide"}, device="cpu")
    jt = JTOAs.from_arrays(t.day, t.sec, error_us=t.error_us,
                           freq_mhz=t.freq_mhz, obs="gbt",
                           flags=[dict(f) for f in t.flags])
    jm = jget_model(EQUATORIAL)
    r, jr = Residuals(t, m, device="cpu"), JResiduals(jt, jm)
    for use in (True, False):
        a, b = r.ecorr_average(use), jr.ecorr_average(use)
        assert len(a["indices"]) == len(b["indices"]) == 25
        for g, h in zip(a["indices"], b["indices"]):
            np.testing.assert_array_equal(g, h)
        for key in ("mjds", "freqs", "errors"):
            np.testing.assert_allclose(a[key], b[key], rtol=1e-9, atol=0)
        np.testing.assert_allclose(a["time_resids"], b["time_resids"],
                                   rtol=0, atol=1e-9 / m.F0.value)


def test_residuals_need_a_card_by_default(monkeypatch, ngc):
    """Residuals runs on the card unless the caller asks for the CPU."""
    import torch

    from pint_tpu_torch.residuals import Residuals

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Residuals(ngc[1], ngc[0])
