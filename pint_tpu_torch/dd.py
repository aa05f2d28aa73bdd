"""Double-double (Dekker) arithmetic on float64 tensors (torch
counterpart of the JAX package's ``dd.py``).

A DD value is an unevaluated sum ``hi + lo`` of two equal-shape float64
tensors with |lo| <= ulp(hi)/2, ~32 significant digits. two_sum is
Knuth's; two_prod is Dekker's split product, which is exact only if
``a_hi * b_hi - p`` and the other partial products are rounded one by
one. torch's eager elementwise ops never contract ``a * b + c`` into a
fused multiply-add (each op is its own kernel, on the CPU and on the
card), so the split product holds as written.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import DTYPE

_SPLITTER = 134217729.0  # 2^27 + 1, Dekker splitter for binary64


class DD(NamedTuple):
    """Double-double number: value = hi + lo (unevaluated)."""

    hi: torch.Tensor
    lo: torch.Tensor

    def __add__(self, other):
        return add(self, _coerce(other, self.hi))

    def __radd__(self, other):
        return add(_coerce(other, self.hi), self)

    def __sub__(self, other):
        return sub(self, _coerce(other, self.hi))

    def __rsub__(self, other):
        return sub(_coerce(other, self.hi), self)

    def __mul__(self, other):
        return mul(self, _coerce(other, self.hi))

    def __rmul__(self, other):
        return mul(_coerce(other, self.hi), self)

    def __truediv__(self, other):
        return div(self, _coerce(other, self.hi))

    def __rtruediv__(self, other):
        return div(_coerce(other, self.hi), self)

    def __neg__(self):
        return DD(-self.hi, -self.lo)

    def to_f64(self):
        return self.hi + self.lo


def _coerce(x, like=None) -> DD:
    """``x`` as a DD: a DD as it is, a number or tensor as (x, 0) in
    float64 (on ``like``'s device when given)."""
    if isinstance(x, DD):
        return x
    dev = None if like is None else like.device
    x = torch.as_tensor(x, dtype=DTYPE, device=dev)
    return DD(x, torch.zeros_like(x))


def from_f64(x) -> DD:
    """Promote a float64 tensor to DD exactly."""
    return _coerce(x)


def from_2sum(a, b) -> DD:
    """DD from the exact sum of two float64 tensors."""
    return two_sum(torch.as_tensor(a, dtype=DTYPE),
                   torch.as_tensor(b, dtype=DTYPE))


def two_sum(a, b) -> DD:
    """Knuth two-sum: s + e == a + b exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return DD(s, e)


def quick_two_sum(a, b) -> DD:
    """Fast two-sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return DD(s, e)


def _split(a):
    t = _SPLITTER * a
    a_hi = t - (t - a)
    a_lo = a - a_hi
    return a_hi, a_lo


def two_prod(a, b) -> DD:
    """Dekker product: p + e == a*b exactly (no FMA involved)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return DD(p, e)


def add(x: DD, y: DD) -> DD:
    s = two_sum(x.hi, y.hi)
    t = two_sum(x.lo, y.lo)
    c = s.lo + t.hi
    v = quick_two_sum(s.hi, c)
    w = t.lo + v.lo
    return quick_two_sum(v.hi, w)


def sub(x: DD, y: DD) -> DD:
    return add(x, DD(-y.hi, -y.lo))


def mul(x: DD, y: DD) -> DD:
    p = two_prod(x.hi, y.hi)
    e = p.lo + (x.hi * y.lo + x.lo * y.hi)
    return quick_two_sum(p.hi, e)


def mul_f(x: DD, f) -> DD:
    """DD * float64."""
    p = two_prod(x.hi, f)
    e = p.lo + x.lo * f
    return quick_two_sum(p.hi, e)


def div(x: DD, y: DD) -> DD:
    q1 = x.hi / y.hi
    r = sub(x, mul_f(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f(y, q2))
    q3 = r.hi / y.hi
    q = quick_two_sum(q1, q2)
    return add(q, DD(q3, torch.zeros_like(q3)))


def neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def abs_(x: DD) -> DD:
    s = torch.where(x.hi < 0, -1.0, 1.0)
    return DD(x.hi * s, x.lo * s)


def floor(x: DD) -> DD:
    """Elementwise floor of a DD value, exact."""
    fhi = torch.floor(x.hi)
    is_int = fhi == x.hi
    flo = torch.where(is_int, torch.floor(x.lo), torch.zeros_like(x.lo))
    return two_sum(fhi, flo)


def round_half(x: DD) -> DD:
    """Round to nearest integer (ties toward +inf), exact."""
    return floor(add(x, _coerce(0.5, x.hi)))


def fmod1(x: DD) -> DD:
    """Fractional part in [-0.5, 0.5): x - round(x)."""
    return sub(x, round_half(x))


def to_f64(x: DD):
    return x.hi + x.lo


def horner(dt: DD, coeffs) -> DD:
    """sum_i coeffs[i] * dt^i / i! in DD by Horner's rule from the
    highest term (reference: utils.py::taylor_horner, in double-double
    so decades of kHz spin phase keep sub-nanosecond precision).
    ``coeffs``: numbers, tensors or DDs, the constant term first."""
    facts, fact = [], 1.0
    for i in range(len(coeffs)):
        facts.append(fact)
        fact *= i + 1
    result = _coerce(0.0, dt.hi)
    for i in reversed(range(len(coeffs))):
        term = mul_f(_coerce(coeffs[i], dt.hi), 1.0 / facts[i])
        result = add(term, mul(dt, result))
    return result


def horner_deriv(dt: DD, coeffs, deriv_order: int = 1) -> DD:
    """d^k/dt^k of horner(dt, coeffs): sum_{i>=k} c_i t^(i-k)/(i-k)!
    (reference: utils.py::taylor_horner_deriv)."""
    if deriv_order >= len(coeffs):
        return _coerce(torch.zeros_like(dt.hi))
    return horner(dt, list(coeffs[deriv_order:]))


def sum_dd(x: DD, axis=None) -> DD:
    """Sum a DD tensor along ``axis`` (all elements when None) by a
    sequential compensated fold over the reduction axis, in index
    order (the JAX package's ``lax.scan``): exact on IEEE f64, O(n)
    steps, meant for modest reductions such as chi2 over TOAs."""
    if axis is None:
        hi, lo = x.hi.reshape(-1), x.lo.reshape(-1)
    else:
        hi = torch.movedim(x.hi, axis, 0)
        lo = torch.movedim(x.lo, axis, 0)
    acc = DD(torch.zeros(hi.shape[1:], dtype=hi.dtype, device=hi.device),
             torch.zeros(hi.shape[1:], dtype=hi.dtype, device=hi.device))
    for i in range(hi.shape[0]):
        acc = add(acc, DD(hi[i], lo[i]))
    return acc
