"""MCMC fitting of timing models, with the photon-event template
likelihood (counterpart of the JAX package's ``mcmc_fitter.py``).

(reference: src/pint/mcmc_fitter.py — MCMCFitter,
MCMCFitterBinnedTemplate/MCMCFitterAnalyticTemplate: emcee over
lnprior+lnlike; here the ensemble sampler of sampler.py drives the
posterior of bayesian.py on the fitter's device.)
"""

from __future__ import annotations

import numpy as np
import torch

from . import DTYPE
from .bayesian import BayesianTiming
from .fitter import Fitter
from .residuals import Residuals
from .sampler import EnsembleSampler


class MCMCFitter(Fitter):
    """(reference: mcmc_fitter.py::MCMCFitter — fit_toas runs the
    sampler; maxpost_fitvals / parameter credible intervals out.)"""

    def __init__(self, toas, model, n_walkers=None, prior_info=None,
                 use_pulse_numbers=False, seed=0, device="cuda"):
        super().__init__(toas, model, device=device)
        self.bt = BayesianTiming(self.model, toas,
                                 use_pulse_numbers=use_pulse_numbers,
                                 prior_info=prior_info, device=device)
        self.ndim = self.bt.nparams
        self.n_walkers = n_walkers or max(2 * self.ndim + 2, 16)
        if self.n_walkers % 2:
            self.n_walkers += 1
        self.seed = seed
        self.sampler = EnsembleSampler(self.bt.lnposterior, self.n_walkers,
                                       self.ndim, seed=seed, device=device)

    def fit_toas(self, n_steps=500, burn=None, thin=1):
        """Run the chain; set the model to the maximum posterior and the
        uncertainties to the post-burn chain's std (reference:
        MCMCFitter.fit_toas). ``burn`` counts KEPT (post-thin) samples."""
        burn = (n_steps // thin) // 4 if burn is None else burn
        pos0 = self.sampler.get_initial_pos(self.bt.initial_position(),
                                            self.bt.scales() * 0.1)
        self.sampler.run_mcmc(pos0, n_steps, thin=thin)
        chain = self.sampler.chain  # (n_kept, n_walkers, d)
        lp = self.sampler.lnprob
        i, j = np.unravel_index(np.argmax(lp), lp.shape)
        self.maxpost = float(lp[i, j])
        self.maxpost_fitvals = chain[i, j].copy()
        flat = chain[burn:].reshape(-1, self.ndim)
        self._sync_model_from_vector(self.bt.prepared, self.maxpost_fitvals)
        for pname, s in zip(self.bt.param_labels, flat.std(axis=0)):
            getattr(self.model, pname).uncertainty = float(s)
        self.parameter_covariance_matrix = np.cov(flat.T).reshape(
            self.ndim, self.ndim)
        self.resids = Residuals(self.toas, self.model, device=self.device)
        self.converged = self.sampler.accept_frac > 0.05
        return self.maxpost

    def get_posterior_samples(self, burn=0):
        """Posterior samples by parameter name, for corner plots and
        summaries (the JAX package's name for it)."""
        flat = self.sampler.chain[burn:].reshape(-1, self.ndim)
        return {p: flat[:, i] for i, p in enumerate(self.bt.param_labels)}


def _normalized_template(template):
    t = np.asarray(template, float)
    return t / t.mean() if abs(t.mean() - 1.0) > 1e-6 else t


def _binned_template_lnlike(prepared, template, weights, x):
    """lnL = sum_i ln(w_i T(phi_i(x)) + 1 - w_i) (unweighted: sum ln T)
    for one photon set: the binned-template likelihood of
    MCMCFitterBinnedTemplate and CompositeMCMCFitter. ``template`` and
    ``weights`` are moved to the prepared device (pass them there once
    to keep copies out of a sampler's loop); vmap-safe in x."""
    from .templates import photon_loglike

    dev = prepared.device
    p = prepared.params_with_vector(x)
    frac = prepared._phase_continuous(p)
    phase = frac - torch.floor(frac)  # [0, 1)
    tpl = torch.as_tensor(template, dtype=DTYPE).to(dev)
    nb = tpl.shape[0]
    idx = torch.clamp((phase * nb).to(torch.int64), 0, nb - 1)
    w = None if weights is None else torch.as_tensor(
        weights, dtype=DTYPE).to(dev)
    return photon_loglike(tpl[idx], w)


def _on_device(a, prepared):
    return None if a is None else torch.as_tensor(
        np.asarray(a, float), dtype=DTYPE, device=prepared.device)


class MCMCFitterBinnedTemplate(MCMCFitter):
    """Photon-event likelihood: lnL = sum_i ln T(phi_i) with a binned
    pulse template T (reference: mcmc_fitter.py::MCMCFitterBinnedTemplate).

    The timing model maps photon TOAs to phases on the device and the
    template lookup is a gather, so the whole likelihood runs under the
    sampler's vmap; the template and the weights go to the device once.
    """

    def __init__(self, toas, model, template, weights=None, **kw):
        self.template = _normalized_template(template)
        self.weights = None if weights is None else np.asarray(weights, float)
        super().__init__(toas, model, **kw)
        self._dev_args = (_on_device(self.template, self.bt.prepared),
                          _on_device(self.weights, self.bt.prepared))
        # replace the Gaussian TOA likelihood with the template one
        self.bt._lnlike_raw = self._lnlike_template

    def _lnlike_template(self, x):
        return _binned_template_lnlike(self.bt.prepared, *self._dev_args, x)


class CompositeMCMCFitter(MCMCFitter):
    """Joint sampling over several photon datasets sharing one timing
    model (reference: mcmc_fitter.py::CompositeMCMCFitter — e.g. Fermi
    + NICER event lists, each with its own pulse template and weights).

    lnL(x) = sum_k lnL_template_k(phases of toas_k under params x).
    Each dataset gets its own PreparedTiming; the shared free-parameter
    vector is defined by the model, so every dataset sees the same
    parameter order.
    """

    def __init__(self, toas_list, model, templates, weights_list=None,
                 **kw):
        if not toas_list:
            raise ValueError("need at least one TOA set")
        if len(toas_list) != len(templates):
            raise ValueError("need one template per TOA set")
        if weights_list is not None and len(weights_list) != len(toas_list):
            raise ValueError(
                f"weights_list has {len(weights_list)} entries for "
                f"{len(toas_list)} TOA sets; pass None for unweighted sets")
        self.templates = [_normalized_template(t) for t in templates]
        self.weights_list = (list(weights_list) if weights_list is not None
                             else [None] * len(toas_list))
        self.toas_list = list(toas_list)
        # the base class prepares dataset 0 (parameter order and scales)
        super().__init__(toas_list[0], model, **kw)
        self.prepareds = [self.bt.prepared] + [
            self.model.prepare(t, device=self.device) for t in toas_list[1:]]
        self._dev_args = [
            (prepared, _on_device(t, prepared), _on_device(w, prepared))
            for prepared, t, w in zip(self.prepareds, self.templates,
                                      self.weights_list)]
        self.bt._lnlike_raw = self._lnlike_composite

    def _lnlike_composite(self, x):
        total = 0.0
        for prepared, template, weights in self._dev_args:
            total = total + _binned_template_lnlike(prepared, template,
                                                    weights, x)
        return total
