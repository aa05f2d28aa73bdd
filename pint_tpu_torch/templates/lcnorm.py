"""NormAngles: unconstrained angle parameterization of template norms
(torch counterpart of the JAX package's ``templates/lcnorm.py``).

(reference: src/pint/templates/lcnorm.py::NormAngles — the mixture
norms n_i (n_i >= 0, sum <= 1) are reparameterized through angles so
optimizers can move freely without simplex projection.)

Mapping (stick-breaking, differentiable everywhere):
    total  = sin^2(a_0)                     (overall pulsed fraction)
    g_i    = stick-breaking fractions from sin^2(a_1..a_{k-1})
    n_i    = total * g_i
The inverse recovers angles from any valid norm vector, so fits can be
seeded from explicit norms.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import DTYPE


def norms_from_angles(angles):
    """angles (k,) -> norms (k,) with sum(norms) = sin^2(a0) <= 1."""
    a = torch.as_tensor(angles, dtype=DTYPE)
    total = torch.sin(a[0]) ** 2
    k = a.shape[0]
    if k == 1:
        return total[None]
    s2 = torch.sin(a[1:]) ** 2
    # stick breaking: g_i = s2_i * prod_{j<i}(1-s2_j); last takes rest
    one = torch.ones(1, dtype=DTYPE, device=a.device)
    rest = torch.cat([one, torch.cumprod(1.0 - s2, dim=0)])
    g = torch.cat([s2, one]) * rest
    return total * g


def angles_from_norms(norms):
    """Inverse of norms_from_angles (numpy, host-side seeding)."""
    n = np.asarray(norms, float)
    total = n.sum()
    if total > 1.0 + 1e-9 or (n < -1e-12).any():
        raise ValueError("norms must be >= 0 with sum <= 1")
    k = len(n)
    a = np.zeros(k)
    a[0] = np.arcsin(np.sqrt(min(total, 1.0)))
    if k == 1:
        return a
    g = n / total if total > 0 else np.full(k, 1.0 / k)
    rest = 1.0
    for i in range(k - 1):
        frac = g[i] / rest if rest > 1e-300 else 0.0
        a[i + 1] = np.arcsin(np.sqrt(np.clip(frac, 0.0, 1.0)))
        rest -= g[i]
    return a


class NormAngles:
    """Object wrapper matching the reference's NormAngles surface."""

    def __init__(self, norms):
        self.p = angles_from_norms(norms)

    def __call__(self):
        return norms_from_angles(self.p).numpy()

    def set_total(self, total):
        self.p[0] = np.arcsin(np.sqrt(np.clip(total, 0.0, 1.0)))
