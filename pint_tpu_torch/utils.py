"""Helpers the slice uses from the JAX package's ``utils.py``.

``PosVel``, ``interesting_lines``, ``split_prefixed_name``,
``compute_hash`` and ``ftest`` are host numpy/str code copied as they
are; ``weighted_mean`` is the torch form.
(The JAX module imports JAX at top level, so it cannot be copied whole.)
"""

from __future__ import annotations

import re

import numpy as np
import torch

_PREFIX_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*?)(\d+)$")


def split_prefixed_name(name: str):
    """'F12' -> ('F', 12); 'DMX_0003' -> ('DMX_', 3). Raises ValueError otherwise.

    (reference: src/pint/utils.py::split_prefixed_name)
    """
    m = _PREFIX_RE.match(name)
    if not m:
        raise ValueError(f"{name!r} has no numeric suffix")
    return m.group(1), int(m.group(2))


def weighted_mean(x, sigma, axis=None):
    """Inverse-variance weighted mean (reference: utils.py::weighted_mean)."""
    w = 1.0 / torch.square(sigma)
    if axis is None:
        return torch.sum(x * w) / torch.sum(w)
    return torch.sum(x * w, dim=axis) / torch.sum(w, dim=axis)


def ftest(chi2_1, dof_1, chi2_2, dof_2):
    """F-test probability that the parameter addition is NOT needed.

    (reference: src/pint/utils.py::FTest). Returns the p-value of the
    F statistic for nested models; small p => added params significant.
    """
    from scipy.stats import f as fdist

    delta_chi2 = chi2_1 - chi2_2
    delta_dof = dof_1 - dof_2
    if delta_chi2 <= 0 or delta_dof <= 0 or dof_2 <= 0:
        return 1.0
    fstat = (delta_chi2 / delta_dof) / (chi2_2 / dof_2)
    return float(fdist.sf(fstat, delta_dof, dof_2))


class PosVel:
    """Position+velocity 3-vectors with frame bookkeeping.

    (reference: src/pint/utils.py::PosVel). Host-side numpy; device code
    consumes the raw arrays. pos/vel have shape (..., 3).
    """

    def __init__(self, pos, vel, origin=None, obj=None):
        self.pos = np.asarray(pos, dtype=np.float64)
        self.vel = np.asarray(vel, dtype=np.float64)
        self.origin = origin
        self.obj = obj

    def __add__(self, other: "PosVel") -> "PosVel":
        if self.obj is not None and other.origin is not None and self.obj != other.origin:
            if self.origin == other.obj:
                return other.__add__(self)
            raise ValueError(f"cannot chain {self.origin}->{self.obj} with {other.origin}->{other.obj}")
        return PosVel(self.pos + other.pos, self.vel + other.vel,
                      origin=self.origin, obj=other.obj)

    def __sub__(self, other: "PosVel") -> "PosVel":
        if (self.origin is not None and other.origin is not None
                and self.origin != other.origin):
            raise ValueError(
                f"cannot subtract vectors with origins {self.origin!r} and {other.origin!r}")
        return PosVel(self.pos - other.pos, self.vel - other.vel,
                      origin=other.obj, obj=self.obj)

    def __neg__(self):
        return PosVel(-self.pos, -self.vel, origin=self.obj, obj=self.origin)

    def __repr__(self):
        return f"PosVel({self.origin}->{self.obj}, pos~{self.pos.ravel()[:3]})"


# upstream spelling (reference: src/pint/utils.py::FTest)
FTest = ftest


def interesting_lines(lines, comments=("#", "C ")):
    """Strip blank/comment lines (reference: utils.py::interesting_lines)."""
    for line in lines:
        ls = line.strip()
        if not ls:
            continue
        if any(ls.startswith(c) for c in comments):
            continue
        yield ls


def compute_hash(*chunks) -> str:
    """Stable content hash for cache invalidation (reference: utils.py::compute_hash)."""
    import hashlib

    h = hashlib.sha256()
    for c in chunks:
        if isinstance(c, str):
            c = c.encode()
        h.update(c)
    return h.hexdigest()
