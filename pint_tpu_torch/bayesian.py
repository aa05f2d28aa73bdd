"""Bayesian timing interface: lnprior / lnlikelihood / lnposterior of
the free-parameter vector, and the unit-cube prior transform
(counterpart of the JAX package's ``bayesian.py``).

(reference: src/pint/bayesian.py::BayesianTiming — likelihoods for
external samplers (emcee/dynesty/ultranest), uniform default priors
from the uncertainties.)

Every density is a function of the free-parameter vector on the
prepared model's device, built on PreparedTiming and written with
``torch.where`` rather than Python branches on values, so the ensemble
sampler runs one ``torch.func.vmap`` over its walkers (``sampler.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import DTYPE
from .priors import Prior, UniformBoundedPrior


class BayesianTiming:
    """(reference: bayesian.py::BayesianTiming — same method surface:
    lnprior, lnlikelihood, lnposterior, prior_transform, nparams).

    The JAX package caches a jitted likelihood in ``_lnlike_jit``; the
    port runs eagerly and has no such attribute: ``lnlikelihood`` calls
    ``_lnlike_raw``, which the template fitters of ``mcmc_fitter.py``
    replace by their own likelihood."""

    def __init__(self, model, toas, use_pulse_numbers=False,
                 prior_info=None, sigma_range=10.0, device="cuda"):
        self.model = model
        self.toas = toas
        self.prepared = model.prepare(toas, device=device)
        self.param_labels = list(model.free_params)
        self.nparams = len(self.param_labels)
        track = "use_pulse_numbers" if use_pulse_numbers else "nearest"
        self._resid_fn = self.prepared.residual_vector_fn(track_mode=track)
        self._x0 = self.prepared.vector_from_params().cpu().numpy()
        # priors: an explicit prior_info entry, else the parameter's
        # .prior, else uniform in value +/- sigma_range * uncertainty
        self.priors: list[Prior] = []
        for i, pname in enumerate(self.param_labels):
            par = getattr(model, pname)
            if prior_info and pname in prior_info:
                info = prior_info[pname]
                if isinstance(info, Prior):
                    self.priors.append(info)
                else:
                    self.priors.append(
                        UniformBoundedPrior(info["min"], info["max"]))
            elif getattr(par, "prior", None) is not None:
                self.priors.append(par.prior)
            elif par.uncertainty:
                half = sigma_range * par.uncertainty
                self.priors.append(UniformBoundedPrior(
                    self._x0[i] - half, self._x0[i] + half))
            else:
                raise ValueError(
                    f"no prior for {pname}: set par.prior, pass prior_info, "
                    "or fit first so uncertainties exist")

    # ---- log densities ----

    def lnprior(self, x):
        lp = torch.zeros((), dtype=DTYPE, device=x.device)
        for i, pr in enumerate(self.priors):
            lp = lp + pr.logpdf(x[i])
        return lp

    def _lnlike_raw(self, x):
        r = self._resid_fn(x)
        sigma = self.prepared.scaled_sigma_us(
            self.prepared.params_with_vector(x)) * 1e-6
        return (-0.5 * torch.sum(torch.square(r / sigma))
                - torch.sum(torch.log(sigma))
                - 0.5 * r.shape[0] * math.log(2 * math.pi))

    def lnlikelihood(self, x):
        return self._lnlike_raw(x)

    def lnposterior(self, x):
        """vmap-safe: a -inf prior short-circuits through
        ``torch.where``, not an ``if``."""
        lp = self.lnprior(x)
        ll = self._lnlike_raw(x)
        return torch.where(torch.isfinite(lp), lp + ll,
                           torch.full_like(lp, -math.inf))

    def prior_transform(self, u):
        """Unit cube -> parameter space for nested samplers
        (reference: bayesian.py::BayesianTiming.prior_transform)."""
        return np.array([pr.ppf(ui) for pr, ui in zip(self.priors, u)])

    # ---- conveniences ----

    def initial_position(self):
        return self._x0.copy()

    def scales(self):
        """Per-parameter walker-ball scales from uncertainties/priors."""
        out = []
        for i, pname in enumerate(self.param_labels):
            par = getattr(self.model, pname)
            if par.uncertainty:
                out.append(par.uncertainty)
            elif isinstance(self.priors[i], UniformBoundedPrior):
                out.append(0.01 * (self.priors[i].upper - self.priors[i].lower))
            else:
                out.append(max(abs(self._x0[i]) * 1e-6, 1e-12))
        return np.asarray(out)
