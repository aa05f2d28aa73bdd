"""Double-double (Dekker) arithmetic on float64 tensors (torch
counterpart of the JAX package's ``dd.py``: the operations that
``phase.py`` uses, and Dekker's exact product).

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


def _const(x, like) -> DD:
    """A float constant as a DD on ``like``'s device."""
    x = torch.as_tensor(x, dtype=DTYPE, device=like.device)
    return DD(x, torch.zeros_like(x))


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


def floor(x: DD) -> DD:
    """Elementwise floor of a DD value, exact."""
    fhi = torch.floor(x.hi)
    is_int = fhi == x.hi
    flo = torch.where(is_int, torch.floor(x.lo), torch.zeros_like(x.lo))
    return two_sum(fhi, flo)


def round_half(x: DD) -> DD:
    """Round to nearest integer (ties toward +inf), exact."""
    return floor(add(x, _const(0.5, x.hi)))


def to_f64(x: DD):
    return x.hi + x.lo
