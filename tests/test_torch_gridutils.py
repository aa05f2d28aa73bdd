"""The port's grid_chisq / grid_chisq_derived against the JAX
package's, on the CPU, on tests/test_applications.py's fixture (a
30-TOA WLS-fitted pulsar at two frequencies), and the chunked walk of
the grid.

Both packages get the same TOAs (the JAX package's fake TOAs through a
tim file) and the same start (its WLS fit through a par file).

Tolerances: chi2 to 1e-7 relative of the JAX package's, not the 1e-9
tier (ROADMAP §3): the packages' residuals differ by ulps of phase, so
their chi2 at the same parameters already differ by 7.0e-9 relative on
this fixture (Residuals.chi2), and three WLS steps from a converged
start move chi2 by up to 2.9e-8 relative in either package; the grid
walked in chunks of 1, 3, 8 and the whole grid: bitwise (each point's
arithmetic does not depend on the chunk).
"""

import copy
import warnings

import numpy as np
import pytest

warnings.simplefilter("ignore")

TOL_CHI2 = 1e-7  # relative, see the module docstring
PAR = """
PSR GRIDTEST
RAJ 12:00:00.0
DECJ 10:00:00.0
F0 100.0 1
F1 -1e-14 1
PEPOCH 55000
DM 15.0 1
"""


@pytest.fixture(scope="module")
def fitters(tmp_path_factory):
    """(port WLSFitter, JAX WLSFitter) on the same TOAs and the same
    fitted model: the JAX package makes and fits the fixture, and the
    port reads its tim file and its post-fit par file."""
    from pint_tpu.fitter import WLSFitter as JWLS
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    mjds = np.linspace(54500, 55500, 30)
    freqs = np.where(np.arange(30) % 2, 1400.0, 800.0)
    model = jget_model(PAR)
    toas = make_fake_toas_fromMJDs(mjds, model, error_us=1.0,
                                   freq_mhz=freqs, obs="gbt",
                                   add_noise=True, seed=7)
    jf = JWLS(toas, model)
    jf.fit_toas()
    d = tmp_path_factory.mktemp("grid")
    toas.write_TOA_file(str(d / "g.tim"))
    jt = __import__("pint_tpu.toa", fromlist=["get_TOAs"]).get_TOAs(
        str(d / "g.tim"))
    jf = JWLS(jt, jf.model)
    f = WLSFitter(get_TOAs(str(d / "g.tim")),
                  get_model(jf.model.as_parfile()), device="cpu")
    for p in f.model.free_params:
        assert getattr(f.model, p).value == getattr(jf.model, p).value
    return f, jf


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_grid_chisq_matches_jax_and_finds_the_fit(fitters):
    from pint_tpu.gridutils import grid_chisq as jgrid
    from pint_tpu_torch.gridutils import grid_chisq

    f, jf = fitters
    f0 = f.model.F0.value
    vals = f0 + 5e-11 * np.array([-40.0, -1.0, 0.0, 1.0, 40.0])
    chi2 = grid_chisq(f, ["F0"], [vals])
    assert chi2.shape == (5,)
    assert _rel(chi2, jgrid(jf, ["F0"], [vals])) <= TOL_CHI2
    assert np.argmin(chi2) in (1, 2, 3)
    assert chi2[0] > chi2[2] + 1.0 and chi2[4] > chi2[2] + 1.0


def test_grid_chisq_2d_matches_jax_and_chunks_bitwise(fitters, monkeypatch):
    from pint_tpu.gridutils import grid_chisq as jgrid
    from pint_tpu_torch import gridutils
    from pint_tpu_torch.gridutils import grid_chisq

    f, jf = fitters
    axes = [f.model.F0.value + np.array([-1e-10, 0.0, 1e-10]),
            f.model.F1.value + np.array([-1e-16, 0.0, 1e-16])]
    monkeypatch.setattr(gridutils, "GRID_CHUNK", 9)
    full = grid_chisq(f, ["F0", "F1"], axes)
    assert full.shape == (3, 3) and np.isfinite(full).all()
    assert _rel(full, jgrid(jf, ["F0", "F1"], axes)) <= TOL_CHI2
    for chunk in (1, 3, 8):
        monkeypatch.setattr(gridutils, "GRID_CHUNK", chunk)
        np.testing.assert_array_equal(grid_chisq(f, ["F0", "F1"], axes),
                                      full)


def test_grid_chisq_frozen_param_matches_jax(fitters):
    from pint_tpu.gridutils import grid_chisq as jgrid
    from pint_tpu_torch.gridutils import grid_chisq

    f, jf = (copy.deepcopy(x) for x in fitters)
    for x in (f, jf):
        x.model.DM.frozen = True
    vals = f.model.DM.value + np.array([-0.001, 0.0, 0.001])
    chi2 = grid_chisq(f, ["DM"], [vals])
    assert chi2.shape == (3,) and np.isfinite(chi2).all()
    assert _rel(chi2, jgrid(jf, ["DM"], [vals])) <= TOL_CHI2
    assert f.model.DM.frozen  # restored


def test_grid_chisq_derived_matches_jax(fitters, monkeypatch):
    from pint_tpu.gridutils import grid_chisq_derived as jgrid
    from pint_tpu_torch import gridutils
    from pint_tpu_torch.gridutils import grid_chisq_derived

    f, jf = fitters
    ps = 1.0 / f.model.F0.value + np.array([-1e-14, 0.0, 1e-14])
    chi2 = grid_chisq_derived(f, ["F0"], [lambda p: 1.0 / p], ["P"], [ps])
    assert chi2.shape == (3,) and np.isfinite(chi2).all()
    ref = jgrid(jf, ["F0"], [lambda p: 1.0 / p], ["P"], [ps])
    assert _rel(chi2, ref) <= TOL_CHI2
    monkeypatch.setattr(gridutils, "GRID_CHUNK", 1)
    np.testing.assert_array_equal(
        grid_chisq_derived(f, ["F0"], [lambda p: 1.0 / p], ["P"], [ps]),
        chi2)


def test_grid_point_matches_a_frozen_fit(fitters):
    """A grid point's chi2 is that of a WLS fit with the grid parameter
    frozen at the point, from the same start (3 iterations)."""
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.gridutils import grid_chisq

    f, _ = fitters
    v = f.model.F0.value + 3e-11
    chi2 = grid_chisq(f, ["F0"], [[v]])[0]
    m = copy.deepcopy(f.model)
    m.F0.value = v
    m.F0.frozen = True
    ref = WLSFitter(f.toas, m, device="cpu").fit_toas(maxiter=3)
    assert chi2 == pytest.approx(float(ref), rel=1e-6)
