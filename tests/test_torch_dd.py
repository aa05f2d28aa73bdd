"""The port's double-double arithmetic (dd.py) against the JAX
package's, on the CPU: the eight tests of tests/test_dd.py mirrored,
each also holding the port's result bitwise to the JAX package's
(both are IEEE f64 on one CPU, with no FMA contraction).
"""

import numpy as np
import pytest
import torch

from pint_tpu import dd as jdd
from pint_tpu_torch import dd

LD = np.longdouble


def dd_to_ld(x):
    return LD(np.asarray(x.hi)) + LD(np.asarray(x.lo))


def _t(*xs):
    return [torch.as_tensor(np.asarray(x, np.float64)) for x in xs]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.hi), np.asarray(b.hi))
    np.testing.assert_array_equal(np.asarray(a.lo), np.asarray(b.lo))


def test_two_sum_exact():
    a, b = 1e16, 1.0
    s = dd.two_sum(*_t(a, b))
    assert float(s.hi) == 1e16 + 1.0 or float(s.lo) != 0.0
    assert dd_to_ld(s) == LD(1e16) + LD(1.0)
    _same(s, jdd.two_sum(np.float64(a), np.float64(b)))


def test_two_prod_exact():
    a, b = 1.1, 1e9 + 1 / 3
    p = dd.two_prod(*_t(a, b))
    expected = LD(a) * LD(b)
    assert abs(float(dd_to_ld(p) - expected)) < 1e-25 * abs(float(expected))
    _same(p, jdd.two_prod(np.float64(a), np.float64(b)))


def test_add_mul_precision():
    rng = np.random.default_rng(0)
    a = rng.uniform(1e8, 1e9, 100)
    b = rng.uniform(-1e-9, 1e-9, 100)
    x = dd.from_2sum(*_t(a, b))
    y = dd.mul(x, x)
    expected = (LD(a) + LD(b)) ** 2
    rel = np.abs((dd_to_ld(y) - expected) / expected).astype(float)
    assert rel.max() < 5e-19
    jx = jdd.from_2sum(a, b)
    _same(y, jdd.mul(jx, jx))
    _same(x * x, jx * jx)
    _same(x + x - 0.25, jx + jx - 0.25)
    _same(dd.mul_f(x, torch.tensor(3.0, dtype=torch.float64)),
          jdd.mul_f(jx, 3.0))
    _same(-x, -jx)
    _same(dd.abs_(-x), jdd.abs_(-jx))
    _same(1.0 - x, 1.0 - jx)


def test_div():
    x = dd.from_f64(torch.tensor(1.0, dtype=torch.float64))
    y = dd.from_f64(torch.tensor(3.0, dtype=torch.float64))
    q = dd.div(x, y)
    assert abs(float(dd_to_ld(q) - LD(1) / LD(3))) < 1e-31
    _same(q, jdd.div(jdd.from_f64(1.0), jdd.from_f64(3.0)))
    _same(x / y, jdd.from_f64(1.0) / jdd.from_f64(3.0))
    _same(2.0 / y, 2.0 / jdd.from_f64(3.0))


def test_horner_spindown_scale():
    """Phase over 20 years at F0=339 Hz keeps frac-phase to <1e-9 cycles."""
    F0, F1 = 339.31568729824, -1.6e-15
    hi, lo = 20 * 365.25 * 86400.0, 0.123456789
    ph = dd.horner(dd.from_2sum(*_t(hi, lo)), [0.0, F0, F1])
    dt_ld = LD(hi) + LD(lo)
    expected = LD(F0) * dt_ld + LD(F1) * dt_ld**2 / 2
    assert abs(float(dd_to_ld(ph) - expected)) < 1e-9
    _same(ph, jdd.horner(jdd.from_2sum(hi, lo), [0.0, F0, F1]))


def test_floor_round():
    x = dd.from_2sum(*_t(2.5, -1e-20))
    assert float(dd.to_f64(dd.floor(x))) == 2.0
    r = dd.round_half(dd.from_2sum(*_t(2.5, 1e-20)))
    assert float(dd.to_f64(r)) == 3.0
    rng = np.random.default_rng(1)
    a, b = rng.uniform(-1e6, 1e6, 50), rng.uniform(-1e-11, 1e-11, 50)
    _same(dd.fmod1(dd.from_2sum(*_t(a, b))),
          jdd.fmod1(jdd.from_2sum(a, b)))
    f = dd.to_f64(dd.fmod1(dd.from_2sum(*_t(a, b))))
    assert torch.all((f >= -0.5) & (f < 0.5))


def test_vmap_and_sum():
    """The JAX test's jit + vmap: here torch.func.vmap of a DD product,
    and sum_dd's sequential fold against the JAX package's lax.scan."""
    def f(hi, lo):
        x = dd.DD(hi, lo)
        return dd.to_f64(dd.mul(x, x))

    hi = torch.arange(1.0, 5.0, dtype=torch.float64)
    out = torch.func.vmap(f)(hi, torch.zeros(4, dtype=torch.float64))
    np.testing.assert_allclose(out.numpy(), np.arange(1.0, 5.0) ** 2)
    rng = np.random.default_rng(2)
    a, b = rng.uniform(-1e3, 1e3, (30, 4)), rng.uniform(-1e-14, 1e-14, (30, 4))
    for axis in (None, 0, 1):
        _same(dd.sum_dd(dd.from_2sum(*_t(a, b)), axis=axis),
              jdd.sum_dd(jdd.from_2sum(a, b), axis=axis))


def test_horner_deriv():
    dt = dd.from_f64(torch.tensor(100.0, dtype=torch.float64))
    coeffs = [0.0, 2.0, 3.0, 4.0]
    d1 = dd.horner_deriv(dt, coeffs, 1)
    # d/dt [2t + 3t^2/2 + 4t^3/6] = 2 + 3t + 2t^2
    assert float(dd.to_f64(d1)) == pytest.approx(2 + 3 * 100 + 2 * 100**2,
                                                 rel=1e-12)
    _same(d1, jdd.horner_deriv(jdd.from_f64(100.0), coeffs, 1))
    assert float(dd.to_f64(dd.horner_deriv(dt, coeffs, 4))) == 0.0
