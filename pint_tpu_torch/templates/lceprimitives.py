"""Energy-dependent light-curve primitives (torch counterpart of the
JAX package's ``templates/lceprimitives.py``).

(reference: src/pint/templates/lceprimitives.py — LCEGaussian /
LCEVonMises etc.: each base parameter gains a linear slope in
log10(E/1 GeV), so pulse peaks may drift and sharpen with photon
energy, as Fermi pulsars do.)

Parameter layout of an energy-dependent primitive with base
``n_base = base.n_params``:

    p = [base params (at the 1 GeV pivot)..., slopes...]

so ``n_params = 2 * n_base``; at the pivot energy the slopes drop out
and the primitive equals its base. Energies enter as ``log10_ens`` in
log10(MeV) (upstream convention; the pivot is 3.0 = 1 GeV).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import DTYPE
from .lcprimitives import (LCGaussian, LCLorentzian, LCPrimitive,
                           LCVonMises, _args)

PIVOT_LOG10_MEV = 3.0  # 1 GeV


class LCEPrimitive(LCPrimitive):
    """Generic energy-dependence wrapper around a base primitive class.

    Evaluation broadcasts per-photon effective parameters through the
    base density (the base primitives accept tensor-valued params).
    """

    energy_dependent = True
    base_cls: type[LCPrimitive] = LCGaussian

    def __init__(self, p, slopes=None):
        base_n = self.base_cls.n_params
        p = np.asarray(p, float)
        if len(p) == base_n:
            p = np.concatenate([p, np.zeros(base_n) if slopes is None
                                else np.asarray(slopes, float)])
        if len(p) != 2 * base_n:
            raise ValueError(
                f"{type(self).__name__} expects {base_n} base params "
                f"(+{base_n} optional slopes); got {len(p)}")
        super().__init__(p)
        self.n_params = 2 * base_n
        self._base = self.base_cls(p[:base_n])

    @property
    def loc(self):
        return self.p[self.base_cls.n_params - 1]

    def effective_params(self, log10_ens, p=None, device=None):
        """Per-photon base parameters at the given energies."""
        p = torch.as_tensor(self.p if p is None else p, dtype=DTYPE,
                            device=device)
        nb = self.base_cls.n_params
        base = p[:nb]
        slope = p[nb:2 * nb]
        if log10_ens is None:
            return base
        de = torch.as_tensor(log10_ens, dtype=DTYPE,
                             device=p.device) - PIVOT_LOG10_MEV
        return base[:, None] + slope[:, None] * de

    def project_params(self, q):
        nb = self.base_cls.n_params
        q = q.clone()
        if nb > 1:
            q[:nb - 1] = torch.clamp(q[:nb - 1], min=1e-4)
        q[nb - 1] = q[nb - 1] % 1.0  # slopes stay free
        return q

    def __call__(self, phases, p=None, log10_ens=None):
        ph, _ = _args(phases, self.p if p is None else p)
        peff = self.effective_params(log10_ens, p=p, device=ph.device)
        # widths must stay positive whatever the slope extrapolates to
        nb = self.base_cls.n_params
        if nb > 1:
            peff = torch.cat([torch.clamp(peff[:nb - 1], min=1e-4),
                              peff[nb - 1:]], dim=0)
        return self._base(ph, p=peff)


class LCEGaussian(LCEPrimitive):
    """(reference: lceprimitives.py::LCEGaussian) wrapped Gaussian with
    sigma(E), loc(E) linear in log10 E."""

    base_cls = LCGaussian
    n_params = 4


class LCEVonMises(LCEPrimitive):
    """(reference: lceprimitives.py::LCEVonMises)."""

    base_cls = LCVonMises
    n_params = 4


class LCELorentzian(LCEPrimitive):
    """(reference: lceprimitives.py::LCELorentzian)."""

    base_cls = LCLorentzian
    n_params = 4
