"""LCFitter: maximum-likelihood fit of a template to photon phases
(torch counterpart of the JAX package's ``templates/lcfitters.py``).

(reference: src/pint/templates/lcfitters.py — LCFitter.fit with
unbinned loglikelihood sum(log f(phi_i)) [optionally weighted].)

The log-likelihood and its gradient (``torch.autograd`` in place of
``jax.grad``) are reductions over the photon axis on the fitter's
device; the optimizer is the JAX package's fixed-iteration Adam loop
with the same projection after every step, driven from the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import DTYPE, resolve_device
from . import photon_loglike


class LCFitter:
    def __init__(self, template, phases, weights=None, log10_ens=None,
                 device="cuda"):
        dev = resolve_device(device)
        self.device = dev
        self.template = template

        def t(a):
            return (None if a is None else
                    torch.as_tensor(a, dtype=DTYPE).to(dev))

        self.phases = t(phases) % 1.0
        self.weights = t(weights)
        # per-photon log10(E/MeV) for energy-dependent templates
        # (reference: lcfitters.py LCFitter(..., log10_ens))
        self.log10_ens = t(log10_ens)

    def _vec(self, vec):
        return torch.as_tensor(np.asarray(vec, np.float64), dtype=DTYPE,
                               device=self.device)

    def _negll_unbinned(self, fn):
        def negll(v):
            return -photon_loglike(fn(v, self.phases,
                                      log10_ens=self.log10_ens),
                                   self.weights)
        return negll

    def loglikelihood(self, vec=None):
        fn, vec0 = self.template.gradient_ready()
        v = self._vec(vec0 if vec is None else vec)
        return photon_loglike(fn(v, self.phases, log10_ens=self.log10_ens),
                              self.weights)

    def fit(self, steps=400, lr=3e-3, unbinned=True, nbins=256):
        """Maximize the likelihood; returns final logL.

        ``unbinned=True`` (default): exact photon likelihood
        sum(log f(phi_i)). ``unbinned=False``: Poisson likelihood of
        the ``nbins``-bin histogram — the reference's binned mode,
        unweighted photons only; the reported ``self.ll`` stays the
        unbinned value so the two modes are comparable.

        Positivity/simplex constraints are enforced by projection after
        each step (norms in [0, 1], widths > 1e-4), matching the
        reference's bounded fit behavior.
        """
        fn, vec0 = self.template.gradient_ready()
        n_norm = len(self.template.primitives)

        if unbinned:
            negll = self._negll_unbinned(fn)
        else:
            if self.log10_ens is not None:
                raise ValueError("binned fitting does not support "
                                 "energy-dependent templates (each "
                                 "photon has its own density); use "
                                 "unbinned=True")
            if self.weights is not None:
                raise ValueError(
                    "binned fitting does not support photon weights: "
                    "the weighted likelihood is per-photon "
                    "(w_i f + 1 - w_i) and cannot be expressed as a "
                    "histogram objective without changing the "
                    "convention; use unbinned=True")
            # the unbinned path accepts any real phase (primitives wrap
            # internally); the histogram sees the same wrapped photons
            counts, _ = np.histogram(self.phases.cpu().numpy() % 1.0,
                                     bins=nbins, range=(0.0, 1.0))
            c = torch.as_tensor(counts, dtype=DTYPE, device=self.device)
            n_tot = float(counts.sum())
            centers = self._vec((np.arange(nbins) + 0.5) / nbins)

            def negll(v):
                # expected counts mu_i = N * f(center_i)/nbins; Poisson
                # log-like up to the v-independent log(c!) term
                mu = torch.clamp(n_tot * fn(v, centers, log10_ens=None)
                                 / nbins, min=1e-300)
                return -torch.sum(c * torch.log(mu) - mu)

        def grad(v):
            v = v.detach().requires_grad_(True)
            return torch.autograd.grad(negll(v), v)[0]

        v = self._vec(vec0)
        # Adam
        m = torch.zeros_like(v)
        s = torch.zeros_like(v)
        b1, b2, eps = 0.9, 0.999, 1e-8
        for t in range(1, steps + 1):
            g = grad(v)
            m = b1 * m + (1 - b1) * g
            s = b2 * s + (1 - b2) * g**2
            mhat = m / (1 - b1**t)
            shat = s / (1 - b2**t)
            v = v - lr * mhat / (torch.sqrt(shat) + eps)
            # project: norms within [1e-5, 1-1e-5] (and simplex), widths positive
            norms = torch.clamp(v[:n_norm], 1e-5, 1.0 - 1e-5)
            total = torch.sum(norms)
            norms = torch.where(total > 1.0 - 1e-5,
                                norms * (1.0 - 1e-5) / total, norms)
            v = v.clone()
            v[:n_norm] = norms
            i = n_norm
            for pr in self.template.primitives:
                # each primitive owns its constraint set (widths > 0,
                # wrapped locs, frozen structural params, free slopes)
                v[i:i + pr.n_params] = pr.project_params(v[i:i + pr.n_params])
                i += pr.n_params
        self.template.set_parameters(v.cpu().numpy())
        with torch.no_grad():
            if unbinned:
                self.ll = -float(negll(v))
            else:
                # report the comparable unbinned logL at the binned optimum
                self.ll = float(self.loglikelihood(v.cpu().numpy()))
        return self.ll

    def param_uncertainties(self):
        """1-sigma uncertainties of the fitted template parameters from
        the inverse Hessian of the log-likelihood (reference:
        lcfitters.py hess_errors), by ``torch.autograd.functional.
        hessian``."""
        fn, vec0 = self.template.gradient_ready()
        H = torch.autograd.functional.hessian(self._negll_unbinned(fn),
                                              self._vec(vec0))
        # pseudo-inverse: parameters at projection bounds can be flat
        cov = np.linalg.pinv(H.cpu().numpy())
        var = np.clip(np.diag(cov), 0.0, None)
        return np.sqrt(var)

    def phase_shift_uncertainty(self):
        """Cramer-Rao sigma of an overall phase shift, from the Fisher
        information of the fitted template (used for TOA errors)."""
        fn, vec0 = self.template.gradient_ready()
        v0 = self._vec(vec0)

        def ll_of_shift(dphi):
            f = fn(v0, (self.phases + dphi) % 1.0, log10_ens=self.log10_ens)
            return photon_loglike(f, self.weights)

        info = -torch.autograd.functional.hessian(
            ll_of_shift, torch.zeros((), dtype=DTYPE, device=self.device))
        return float(1.0 / torch.sqrt(torch.clamp(info, min=1e-300)))
