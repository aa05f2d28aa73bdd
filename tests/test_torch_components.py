"""The port's SolarWindDispersion and TroposphereDelay against the JAX
package's, on the CPU: the delays and their design-matrix columns on
the NGC6440E TOAs (each package's own get_TOAs), with the solar wind
switched on (NE_SW, SWM 0 and SWM 1) and the troposphere correction on.

Tolerances: delays to 1e-12 relative of each delay's peak (the f64
delay tier: both packages pack the same host numpy geometry and
evaluate the same f64 expressions; the measured gaps are ~1e-16
relative); design-matrix columns to 1e-10 relative of each column's
peak (forward-mode derivatives of those expressions); the cos-power
quadrature of SWM 1 to 1e-13 relative, or of the integral's scale where
F(phi) crosses zero (pure f64 arithmetic on the same nodes). The unmodified example (SOLARN0 0.00, CORRECT_TROPOSPHERE N)
gives exactly zero delays in both.
"""

import numpy as np
import pytest
import torch

from test_torch_ingest import NGC_PAR, NGC_TIM, ROOT

JAX_PAR = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.par"
JAX_TIM = ROOT / "pint_tpu" / "data" / "examples" / "NGC6440E.tim"
COMPONENTS = ("SolarWindDispersion", "TroposphereDelay")


def _edited(text, ne_sw=None, tropo=None, extra=""):
    lines = []
    for line in text.splitlines():
        if ne_sw is not None and line.startswith("SOLARN0"):
            line = f"SOLARN0 {ne_sw}"
        if tropo is not None and line.startswith("CORRECT_TROPOSPHERE"):
            line = f"CORRECT_TROPOSPHERE {tropo}"
        lines.append(line)
    return "\n".join(lines) + "\n" + extra


def _pair(**edit):
    """(port model, port TOAs, JAX model, JAX TOAs) of the edited par."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.toa import get_TOAs as jget_TOAs
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    par = _edited(NGC_PAR.read_text(), **edit)
    m, jm = get_model(par), jget_model(par)
    return (m, get_TOAs(NGC_TIM, model=m), jm,
            jget_TOAs(JAX_TIM, model=jm))


def _delays(m, t, jm, jt):
    p = m.prepare(t, device="cpu")
    jp = jm.prepare(jt)
    out = {}
    for name in COMPONENTS:
        c, jc = m.components[name], jm.components[name]
        out[name] = (c.delay(p.params0, p.batch, p.prep, None).numpy(),
                     np.asarray(jc.delay(jp.params0, jp.batch, jp.prep,
                                         None)))
    return out


def test_unmodified_example_gives_zero_delays():
    """SOLARN0 0.00 and CORRECT_TROPOSPHERE N: both components are in
    the model, in the JAX package's order, with exactly zero delay."""
    m, t, jm, jt = _pair()
    assert list(m.components) == list(jm.components) == [
        "Spindown", "AstrometryEquatorial", "DispersionDM",
        "SolarSystemShapiro", "SolarWindDispersion", "TroposphereDelay",
        "AbsPhase"]
    assert m.NE_SW.value == 0.0 and m.CORRECT_TROPOSPHERE.value is False
    for name, (a, b) in _delays(m, t, jm, jt).items():
        assert np.all(a == 0.0) and np.all(b == 0.0), name


@pytest.mark.parametrize("swm", [0, 1])
def test_delays_match_jax(swm):
    """NE_SW 7.9 cm^-3 (SWM 0, or SWM 1 with SWP 2.7) and the
    troposphere on: both delays against the JAX package's."""
    extra = "SWM 1\nSWP 2.7\n" if swm else ""
    m, t, jm, jt = _pair(ne_sw="7.9", tropo="Y", extra=extra)
    for name, (a, b) in _delays(m, t, jm, jt).items():
        assert np.abs(b).max() > 0, name
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), name


def test_design_columns_match_jax():
    """NE_SW free (SWM 1, SWP free too) with the troposphere on: every
    design-matrix column, the solar-wind ones included, against the JAX
    package's."""
    m, t, jm, jt = _pair(ne_sw="7.9 1", tropo="Y",
                         extra="SWM 1\nSWP 2.7 1\n")
    M, labels = m.prepare(t, device="cpu").designmatrix()
    jM, jlabels = jm.prepare(jt).designmatrix()
    assert labels == jlabels and {"NE_SW", "SWP"} <= set(labels)
    a, b = M.numpy(), np.asarray(jM)
    peak = np.abs(b).max(axis=0)
    assert np.all(peak > 0)
    assert np.all(np.abs(a - b) <= 1e-10 * peak)


def test_cospow_quadrature_matches_jax():
    """_cospow_half / _cospow_integral / solar_wind_geometry_p on a grid
    of power indices and elongations, against the JAX package's."""
    import jax.numpy as jnp
    from pint_tpu.models import solar_wind as jsw
    from pint_tpu_torch.models import solar_wind as tsw

    p = np.linspace(1.3, 5.5, 9)
    phi = np.linspace(-1.5, 1.5, 9)
    a = tsw._cospow_integral(torch.as_tensor(phi), torch.as_tensor(p))
    b = jsw._cospow_integral(jnp.asarray(phi), jnp.asarray(p))
    # phi = 0 is a cancellation F_half - G: absolute, at the scale of F
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                               atol=1e-13 * np.abs(np.asarray(b)).max())
    np.testing.assert_allclose(tsw._cospow_half(torch.as_tensor(p)).numpy(),
                               np.asarray(jsw._cospow_half(jnp.asarray(p))),
                               rtol=1e-13)
    rng = np.random.default_rng(2)
    sun = rng.normal(size=(7, 3)) * 499.0
    n = rng.normal(size=(7, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    for pp in (2.0, 2.7):
        g = tsw.solar_wind_geometry_p(torch.as_tensor(sun), torch.as_tensor(n), pp)
        jg = jsw.solar_wind_geometry_p(jnp.asarray(sun), jnp.asarray(n), pp)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-13)


def test_solar_wind_validation_matches_jax():
    """SWM outside {0, 1}, SWM 1 with SWP <= 1, and a free SWP under
    SWM 0 are refused by both packages; TNSW keys (PLSWNoise) and SWX
    windows (SolarWindDispersionX) build the same components in both."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu_torch.models import get_model

    base = NGC_PAR.read_text()
    for extra in ("SWM 2\n", "SWM 1\nSWP 0.9\n", "SWP 2.5 1\n"):
        for get in (get_model, jget_model):
            with pytest.raises(ValueError):
                get(base + extra)
    for extra, name in (("TNSWAMP -3\n", "PLSWNoise"),
                        ("SWXDM_0001 0.1\nSWXR1_0001 53000\n"
                         "SWXR2_0001 54000\n", "SolarWindDispersionX")):
        m, jm = get_model(base + extra), jget_model(base + extra)
        assert name in m.components
        assert list(m.components) == list(jm.components)


def test_troposphere_zero_off_site():
    """Barycentred TOAs (no site) get zero tropospheric delay."""
    from pint_tpu_torch.models import get_model
    from test_torch_pta import port_toas
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    par = _edited(NGC_PAR.read_text(), tropo="Y")
    jm = jget_model(par)
    jt = make_fake_toas_fromMJDs(np.linspace(53500, 54000, 12), jm,
                                 obs="@", freq_mhz=1400.0)
    m = get_model(par)
    p = m.prepare(port_toas(jt), device="cpu")
    d = m.components["TroposphereDelay"].delay(p.params0, p.batch, p.prep,
                                               None)
    assert torch.all(d == 0.0)
