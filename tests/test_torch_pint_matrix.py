"""The port's labeled matrices (pint_tpu_torch/pint_matrix.py) against
the JAX package's (mirroring tests/test_pint_matrix.py), on the CPU.

Tolerances: labels, units and segment layouts equal; the design matrix
of the same TOAs to 1e-12 relative of each column's peak (the f64
design-matrix tier: both packages differentiate the same f64 phase by
forward-mode autodiff); covariance/correlation algebra, host numpy in
both, to 1e-15.
"""

import numpy as np
import pytest
import torch

PAR = """
PSR TESTM
RAJ 11:00:00.0
DECJ 11:00:00.0
F0 250.0 1
F1 -3e-16 1
PEPOCH 55300
DM 21.0 1
"""


@pytest.fixture(scope="module")
def model_toas():
    """(port model, port TOAs, JAX model, JAX TOAs) on the same GBT TOAs."""
    from pint_tpu.models import get_model as jget_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs
    from pint_tpu_torch.models import get_model
    from test_torch_pta import port_toas

    jm = jget_model(PAR)
    jt = make_fake_toas_fromMJDs(np.linspace(55000, 55600, 40), jm,
                                 error_us=1.0, freq_mhz=1400.0, obs="gbt",
                                 add_noise=True, seed=9)
    return get_model(PAR), port_toas(jt), jm, jt


def test_pint_matrix_segment_validation():
    from pint_tpu_torch.pint_matrix import PintMatrix

    m = np.zeros((3, 2))
    ok = PintMatrix(m, [[("rows", "s", (0, 3))],
                        [("a", "", (0, 1)), ("b", "", (1, 2))]])
    assert ok.labels(1) == ["a", "b"]
    assert ok.get_label(1, "b") == ("b", "", (1, 2))
    assert ok.get_slice(1, "b") == slice(1, 2)
    with pytest.raises(ValueError):
        PintMatrix(m, [[("rows", "s", (0, 2))], []])  # rows not covered
    with pytest.raises(ValueError):
        PintMatrix(m, [[("rows", "s", (1, 3))], []])  # gap at start
    with pytest.raises(KeyError):
        ok.get_label(1, "zz")


def test_design_matrix_from_prepared_matches_jax(model_toas):
    """Labels, units and the [s/param-unit] columns of
    DesignMatrix.from_prepared against the JAX package's."""
    from pint_tpu.pint_matrix import DesignMatrix as JDesignMatrix
    from pint_tpu_torch.pint_matrix import DesignMatrix

    m, t, jm, jt = model_toas
    dm = DesignMatrix.from_prepared(m.prepare(t, device="cpu"), m)
    jdm = JDesignMatrix.from_prepared(jm.prepare(jt), jm)
    assert dm.param_names == jdm.param_names
    assert dm.param_names[0] == "Offset"
    assert dm.param_units == jdm.param_units
    assert dm.param_units[dm.param_names.index("F0")] == "s/(Hz)"
    assert dm.axis_labels == jdm.axis_labels
    assert dm.shape == (40, 1 + len(m.free_params))
    a, b = dm.matrix.numpy(), np.asarray(jdm.matrix)
    peak = np.abs(b).max(axis=0)
    assert np.all(np.abs(a - b) <= 1e-12 * peak)
    assert repr(dm) == repr(jdm)


def test_covariance_correlation_roundtrip():
    from pint_tpu.pint_matrix import CovarianceMatrix as JCov
    from pint_tpu_torch.pint_matrix import CovarianceMatrix

    cov = np.array([[4.0, 1.0], [1.0, 9.0]])
    c = CovarianceMatrix(cov, ["A", "B"], ["s", "Hz"])
    np.testing.assert_allclose(c.sigmas(), [2.0, 3.0])
    corr = c.to_correlation()
    np.testing.assert_allclose(np.diag(corr.matrix), 1.0)
    np.testing.assert_allclose(corr.matrix[0, 1], 1.0 / 6.0)
    assert corr.labels(0) == ["A", "B"]
    jcorr = JCov(cov, ["A", "B"], ["s", "Hz"]).to_correlation()
    np.testing.assert_allclose(corr.matrix, np.asarray(jcorr.matrix),
                               rtol=0, atol=1e-15)
    # a tensor covariance (as on the card) gives the same host numbers
    ct = CovarianceMatrix(torch.as_tensor(cov), ["A", "B"])
    np.testing.assert_array_equal(ct.sigmas(), c.sigmas())
    np.testing.assert_array_equal(ct.to_correlation().matrix, corr.matrix)


def test_combine_by_quantity_union_and_zeros():
    import jax.numpy as jnp
    from pint_tpu.pint_matrix import DesignMatrix as JDM
    from pint_tpu.pint_matrix import \
        combine_design_matrices_by_quantity as jcombine
    from pint_tpu_torch.pint_matrix import (
        DesignMatrix, combine_design_matrices_by_quantity)

    args1 = ("toa", "s", ["Offset", "F0"], ["s", "s/(Hz)"])
    args2 = ("dm", "pc cm^-3", ["F0", "DM"],
             ["pc cm^-3/(Hz)", "pc cm^-3/(pc cm^-3)"])
    c = combine_design_matrices_by_quantity([
        DesignMatrix(torch.ones((3, 2), dtype=torch.float64), *args1),
        DesignMatrix(2 * torch.ones((2, 2), dtype=torch.float64), *args2)])
    jc = jcombine([JDM(jnp.ones((3, 2)), *args1),
                   JDM(2 * jnp.ones((2, 2)), *args2)])
    assert c.param_names == jc.param_names == ["Offset", "F0", "DM"]
    assert c.shape == (5, 3)
    assert c.axis_labels == jc.axis_labels
    M = c.matrix.numpy()
    np.testing.assert_array_equal(M, np.asarray(jc.matrix))
    np.testing.assert_allclose(M[:3, 2], 0.0)  # toa rows: no DM column
    np.testing.assert_allclose(M[3:, 0], 0.0)  # dm rows: no Offset column
    assert c.get_label(0, "dm")[2] == (3, 5)


def test_combine_by_quantity_unit_conflict():
    from pint_tpu_torch.pint_matrix import (
        DesignMatrix, combine_design_matrices_by_quantity)

    m1 = DesignMatrix(torch.ones((2, 1)), "toa", "s", ["DM"],
                      ["s/(pc cm^-3)"])
    m2 = DesignMatrix(torch.ones((2, 1)), "dm", "pc cm^-3", ["DM"],
                      ["pc cm^-3/(Hz)"])
    with pytest.raises(ValueError):
        combine_design_matrices_by_quantity([m1, m2])


def test_combine_by_param():
    from pint_tpu_torch.pint_matrix import (DesignMatrix,
                                            combine_design_matrices_by_param)

    m1 = DesignMatrix(torch.ones((4, 1)), "toa", "s", ["F0"], ["s/(Hz)"])
    m2 = DesignMatrix(torch.ones((4, 2)), "toa", "s", ["DM", "PX"],
                      ["s/(pc cm^-3)", "s/(mas)"])
    c = combine_design_matrices_by_param([m1, m2])
    assert c.param_names == ["F0", "DM", "PX"]
    assert c.param_units == ["s/(Hz)", "s/(pc cm^-3)", "s/(mas)"]
    assert c.shape == (4, 3)
    with pytest.raises(ValueError):
        combine_design_matrices_by_param([m1, m1])  # duplicate F0
    m3 = DesignMatrix(torch.ones((4, 1)), "dm", "pc cm^-3", ["PX"],
                      ["pc cm^-3/(mas)"])
    with pytest.raises(ValueError, match="row quantity"):
        combine_design_matrices_by_param([m1, m3])


def test_fitter_exposes_labeled_covariance(model_toas):
    """WLSFitter's covariance and correlation matrices: labeled with the
    free parameters, sigmas equal to the written uncertainties, and the
    JAX package's to its own covariance tier (1e-10 relative; maxiter=1,
    so both keep the covariance of the same iterate)."""
    from pint_tpu.fitter import WLSFitter as JWLSFitter
    from pint_tpu_torch.fitter import WLSFitter
    from pint_tpu_torch.pint_matrix import CovarianceMatrix

    m, t, jm, jt = model_toas
    f = WLSFitter(t, m, device="cpu")
    f.fit_toas(maxiter=1)
    jf = JWLSFitter(jt, jm)
    jf.fit_toas(maxiter=1)
    cov = f.covariance_matrix
    assert isinstance(cov, CovarianceMatrix)
    assert cov.param_names == list(f.model.free_params)
    i = cov.param_names.index("F0")
    assert cov.sigmas()[i] == pytest.approx(f.model.F0.uncertainty)
    corr = f.correlation_matrix
    np.testing.assert_allclose(np.diag(corr.matrix), 1.0, atol=1e-12)
    assert np.abs(np.asarray(corr.matrix)).max() <= 1.0 + 1e-9
    a = np.asarray(cov.matrix)
    b = np.asarray(jf.covariance_matrix.matrix)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-10 * np.sqrt(np.outer(np.diag(b),
                                                             np.diag(b))).max())
    np.testing.assert_allclose(corr.matrix, np.asarray(jf.correlation_matrix.matrix),
                               rtol=0, atol=1e-9)
