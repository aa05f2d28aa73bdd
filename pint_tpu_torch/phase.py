"""Exact pulse-phase arithmetic on float64 tensors (torch counterpart
of the JAX package's ``phase.py``).

(reference: src/pint/phase.py::Phase — a (longdouble integer part,
longdouble fractional part) pair with exact add/sub.) Here both parts
are float64 tensors: ``int_`` holds an integer-valued f64 (exact up to
2^53 turns) and ``frac`` is in [-0.5, 0.5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import DTYPE, dd, resolve_device


class Phase(NamedTuple):
    int_: torch.Tensor  # integer-valued float64
    frac: torch.Tensor  # [-0.5, 0.5)

    def __add__(self, other: "Phase") -> "Phase":
        return phase_add(self, other)

    def __sub__(self, other: "Phase") -> "Phase":
        return phase_add(self, Phase(-other.int_, -other.frac))

    def __neg__(self) -> "Phase":
        return Phase(-self.int_, -self.frac)

    def value(self) -> torch.Tensor:
        """Collapsed f64 value (lossy for huge phases)."""
        return self.int_ + self.frac


def from_dd(x: dd.DD) -> Phase:
    """Split a DD cycle count into (integer, fractional in [-0.5,0.5))."""
    n = dd.round_half(x)
    f = dd.sub(x, n)
    return Phase(dd.to_f64(n), dd.to_f64(f))


def from_f64(x) -> Phase:
    x = torch.as_tensor(x, dtype=DTYPE)
    # ties toward +inf, matching dd.round_half, so frac stays in [-0.5, 0.5)
    n = torch.floor(x + 0.5)
    return Phase(n, x - n)


def phase_add(a: Phase, b: Phase) -> Phase:
    s = dd.add(dd.from_2sum(a.int_, a.frac), dd.from_2sum(b.int_, b.frac))
    return from_dd(s)


def to_dd(p: Phase) -> dd.DD:
    return dd.from_2sum(p.int_, p.frac)


def zeros(shape, device="cuda") -> Phase:
    z = torch.zeros(shape, dtype=DTYPE, device=resolve_device(device))
    return Phase(z, z)
