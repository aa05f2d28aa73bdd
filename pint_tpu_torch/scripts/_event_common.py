"""Shared helpers of the photon-event MCMC scripts (event_optimize /
event_optimize_multiple; the JAX package's ``scripts/_event_common.py``)."""

from __future__ import annotations


def empirical_template(model, toas, weights, nbins, device="cuda"):
    """The binned folded profile at the input model (the phase on
    ``device``, the histogram on the host), mean-normalized with a floor
    so empty bins do not zero the template likelihood."""
    import numpy as np
    import torch

    ph = torch.remainder(model.phase(toas, device=device).frac,
                         1.0).cpu().numpy()
    hist, _ = np.histogram(ph, bins=nbins, range=(0, 1), weights=weights)
    return np.maximum(hist / hist.mean(), 1e-3)


def default_priors(model, toas_list):
    """A uniform box per free parameter: +/- 5 par-file uncertainties
    when present, else a span-scaled phase-safe box
    (reference: event_optimize errs=... defaults per param)."""
    # the joint span of ALL datasets: the phase-safe F0 box must cover
    # the whole baseline, not the longest single campaign
    span_s = (max(t.day.max() for t in toas_list)
              - min(t.day.min() for t in toas_list)) * 86400.0 or 86400.0
    prior_info = {}
    for pname in model.free_params:
        par = getattr(model, pname)
        half = (5.0 * par.uncertainty if par.uncertainty
                else max(abs(par.value) * 1e-6, 1.0 / span_s))
        prior_info[pname] = {"min": par.value - half, "max": par.value + half}
    return prior_info


def report_fit(fit, outfile=None):
    """Print the max-posterior summary and the parameter table;
    optionally write the post-fit par file."""
    print(f"max posterior = {fit.maxpost:.2f}  "
          f"accept = {fit.sampler.accept_frac:.2f}")
    for pname in fit.bt.param_labels:
        par = getattr(fit.model, pname)
        print(f"  {pname:10s} {par.value:.12g} +- {par.uncertainty:.3g}")
    if outfile:
        fit.model.write_parfile(outfile)
        print(f"Wrote {outfile}")
