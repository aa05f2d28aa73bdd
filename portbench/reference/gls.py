"""The plain GLS step and fit.

One Gauss-Newton step at x: the residuals r and design matrix M of
``timing.Model``, the red-noise basis F appended to M with its prior,
the ECORR epochs marginalised analytically (per epoch, the inverse of
diag(sigma^2) + J 1 1^T by Sherman-Morrison). With T = [M F],
N_e the white-plus-ECORR covariance and Phi the red-noise prior:

  S = T^T N_e^-1 T + diag(0, Phi^-1),   b = T^T N_e^-1 r,
  dx = S^-1 b,   x <- x - dx (the parameter part, the offset dropped),
  chi2 = r^T N_e^-1 r - b^T dx,   cov = (S^-1) over the parameters.

``precision`` sets the precision of the solve (everything from the
whitened columns on): "float64" or "float32"; the residuals and design
matrix are always formed in f64 and longdouble. The whitened columns
are scaled to unit norm (with their prior) in f64 before the cast, so
the solve sees a unit diagonal. The products run in PyTorch on the
timing model's device, the eigendecomposition and what follows in
numpy (LAPACK).
"""

from __future__ import annotations

import numpy as np
import torch

from . import noise, timing

PRECISIONS = {"float64": (np.float64, torch.float64),
              "float32": (np.float32, torch.float32)}


class Fitter:
    """The fixed pieces of one pulsar (its model, noise bases and
    epochs), reused by every fit of it; the timing model's residuals
    and design matrix are worked out on ``device``."""

    def __init__(self, psr, device="cpu"):
        self.model = timing.Model(psr, device)
        self.device = device
        self.sigma = torch.as_tensor(noise.sigma_s(psr), device=device)
        epochs = noise.epochs(psr)
        # the epochs' members end to end, and each member's epoch, for
        # segment sums
        self.members = torch.as_tensor(
            np.concatenate([m for m, _ in epochs]) if epochs
            else np.zeros(0, np.int64), device=device)
        self.epoch_of = torch.as_tensor(np.repeat(
            np.arange(len(epochs)), [len(m) for m, _ in epochs]),
            device=device)
        self.var = torch.as_tensor(np.array([v for _, v in epochs]),
                                   device=device)
        F, self.phi = noise.red_basis(psr)
        self.F = None if F is None else torch.as_tensor(F, device=device)

    def _segsum(self, x):
        out = torch.zeros((len(self.var),) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return out.index_add_(0, self.epoch_of, x)

    def step(self, values, names, precision="float64"):
        np_dtype, dtype = PRECISIONS[precision]
        r = torch.as_tensor(self.model.residual_s(values), device=self.device)
        M = self.model.design(values, names)
        npar = M.shape[1]
        T = M if self.F is None else torch.cat([M, self.F], dim=1)
        prior = np.zeros(T.shape[1])
        if self.F is not None:
            prior[npar:] = 1.0 / self.phi
        prior = torch.as_tensor(prior, device=self.device)
        # whitened columns scaled to unit norm with their prior, in f64
        # (a scaling, exact to rounding); the solve from here in dtype
        Tw = T / self.sigma[:, None]
        norm = torch.sqrt(torch.sum(Tw * Tw, dim=0) + prior)
        # a column with no data and no prior (a DMX window without TOAs)
        # constrains nothing: its parameter keeps its value, with zero
        # variance
        live = (norm > 0).cpu().numpy()
        norm = torch.where(norm > 0, norm, torch.ones_like(norm))
        w = (1.0 / self.sigma).to(dtype)
        Tn = (Tw / norm).to(dtype)
        rw = (r / self.sigma).to(dtype)
        S = Tn.T @ Tn + torch.diag((prior / norm ** 2).to(dtype))
        b = Tn.T @ rw
        rNr = rw @ rw
        if len(self.var):
            # per epoch e: g_e = sum_i T_i / sigma_i^2, t_e = sum_i
            # r_i / sigma_i^2, c_e = J_e / (1 + J_e sum_i 1 / sigma_i^2)
            a = w[self.members]
            G = self._segsum(a[:, None] * Tn[self.members])
            t = self._segsum(a * rw[self.members])
            var = self.var.to(dtype)
            c = var / (1 + var * self._segsum(a * a))
            S = S - (G * c[:, None]).T @ G
            b = b - G.T @ (c * t)
            rNr = rNr - torch.sum(c * t * t)
        S, b = S.cpu().numpy(), b.cpu().numpy()
        rNr, norm = float(rNr), norm.cpu().numpy()
        idx = np.flatnonzero(live)
        evals, evecs = np.linalg.eigh(S[np.ix_(idx, idx)])
        Sinv = np.zeros_like(S)
        Sinv[np.ix_(idx, idx)] = (evecs / evals) @ evecs.T
        dxn = Sinv @ b
        chi2 = np_dtype(rNr) - b @ dxn
        dx = dxn.astype(np.float64) / norm
        Sinv = Sinv.astype(np.float64) / np.outer(norm, norm)
        new = dict(values)
        for j, name in enumerate(names):
            new[name] = float(values[name]) - float(dx[1 + j])
        cov = Sinv[1:npar, 1:npar].astype(np.float64)
        return new, float(chi2), cov

    def fit(self, start, names, maxiter=2, precision="float64"):
        """``maxiter`` steps from ``start`` (name -> value): the values,
        the chi2 and the covariance of the last step, as the port's GLS
        fit returns them."""
        values = dict(start)
        for _ in range(maxiter):
            values, chi2, cov = self.step(values, names, precision)
        return values, chi2, cov
