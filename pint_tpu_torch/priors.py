"""Parameter priors for MCMC and Bayesian fitting (counterpart of the
JAX package's ``priors.py``).

(reference: src/pint/priors.py — Prior wrapping scipy rv_frozen /
UniformUnboundedRV / UniformBoundedRV / GaussianBoundedRV.)

A prior is a pair of functions: ``logpdf`` on float64 tensors, written
with ``torch.where`` and no Python branch on values, so a posterior
built from it runs under ``torch.func.vmap``; and ``sample``/``ppf`` on
the host with numpy/scipy, as in the JAX package, so both packages draw
bitwise-equal samples. scipy frozen distributions are wrapped for API
parity (their ``logpdf`` runs on the host).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import DTYPE


def _f64(x):
    return (x.to(DTYPE) if isinstance(x, torch.Tensor)
            else torch.as_tensor(x, dtype=DTYPE))


class Prior:
    """Base prior: improper uniform over the reals
    (reference: priors.py::Prior with UniformUnboundedRV)."""

    def logpdf(self, x):
        return torch.zeros_like(_f64(x))

    def sample(self, rng, size=()):
        raise ValueError("cannot sample an improper prior")

    # nested-sampling unit-cube transform; improper priors have none
    def ppf(self, u):
        raise ValueError("improper prior has no ppf")


UniformUnboundedPrior = Prior


class UniformBoundedPrior(Prior):
    """(reference: priors.py::UniformBoundedRV)"""

    def __init__(self, lower, upper):
        if not upper > lower:
            raise ValueError("need upper > lower")
        self.lower = float(lower)
        self.upper = float(upper)
        self._lognorm = -math.log(self.upper - self.lower)

    def logpdf(self, x):
        x = _f64(x)
        inside = (x >= self.lower) & (x <= self.upper)
        return torch.where(inside, torch.full_like(x, self._lognorm),
                           torch.full_like(x, -math.inf))

    def sample(self, rng, size=()):
        return rng.uniform(self.lower, self.upper, size=size)

    def ppf(self, u):
        return self.lower + u * (self.upper - self.lower)


class GaussianPrior(Prior):
    """(reference: priors.py Gaussian prior via scipy norm)"""

    def __init__(self, mean, sigma):
        self.mean = float(mean)
        self.sigma = float(sigma)

    def logpdf(self, x):
        z = (_f64(x) - self.mean) / self.sigma
        return -0.5 * z**2 - math.log(self.sigma * math.sqrt(2 * math.pi))

    def sample(self, rng, size=()):
        return rng.normal(self.mean, self.sigma, size=size)

    def ppf(self, u):
        from scipy.stats import norm

        return norm.ppf(u, loc=self.mean, scale=self.sigma)


class GaussianBoundedPrior(GaussianPrior):
    """Truncated Gaussian (reference: priors.py::GaussianBoundedRV)."""

    def __init__(self, mean, sigma, lower, upper):
        super().__init__(mean, sigma)
        self.lower = float(lower)
        self.upper = float(upper)

    def _log_z(self):
        """log(Phi(upper) - Phi(lower)), safe in the tails: the CDF
        difference underflows to 0 when both bounds sit in a far tail,
        which would make logpdf +inf inside the bounds."""
        from scipy.stats import norm

        a = (self.lower - self.mean) / self.sigma
        b = (self.upper - self.mean) / self.sigma
        if a > 0:  # both in the upper tail: survival functions
            la, lb = norm.logsf(a), norm.logsf(b)
            return la + np.log1p(-np.exp(lb - la))
        if b < 0:  # both in the lower tail
            la, lb = norm.logcdf(a), norm.logcdf(b)
            return lb + np.log1p(-np.exp(la - lb))
        return np.log(norm.cdf(b) - norm.cdf(a))

    def logpdf(self, x):
        base = super().logpdf(x)
        x = _f64(x)
        inside = (x >= self.lower) & (x <= self.upper)
        # normalized over [lower, upper], as ppf/prior_transform assume
        return torch.where(inside, base - float(self._log_z()),
                           torch.full_like(base, -math.inf))

    def sample(self, rng, size=()):
        # inverse-CDF sampling (clipping would pile mass on the bounds)
        return self.ppf(rng.uniform(size=size))

    def ppf(self, u):
        # the truncated-normal quantile stays inside [lower, upper];
        # truncnorm handles far-tail bounds
        from scipy.stats import truncnorm

        a = (self.lower - self.mean) / self.sigma
        b = (self.upper - self.mean) / self.sigma
        return truncnorm.ppf(u, a, b, loc=self.mean, scale=self.sigma)


class ScipyPrior(Prior):
    """Wrap a scipy frozen distribution (reference: priors.py::Prior(rv)).
    Its ``logpdf`` runs scipy on the host, so a posterior that uses it
    cannot run under ``vmap``; a tensor argument gets a tensor back on
    its own device."""

    def __init__(self, rv_frozen):
        self.rv = rv_frozen

    def logpdf(self, x):
        if isinstance(x, torch.Tensor):
            out = self.rv.logpdf(x.detach().cpu().numpy())
            return torch.as_tensor(out, dtype=DTYPE, device=x.device)
        return self.rv.logpdf(np.asarray(x))

    def sample(self, rng, size=()):
        return self.rv.rvs(size=size, random_state=rng)

    def ppf(self, u):
        return self.rv.ppf(u)
