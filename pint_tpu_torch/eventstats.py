"""Photon-phase periodicity statistics: H-test, Z^2_m, significances
(torch counterpart of the JAX package's ``eventstats.py``).

(reference: src/pint/eventstats.py — hm, hmw, z2m, z2mw, sf_hm,
sf_z2m, sig2sigma, h2sig.)

The statistics reduce over the photon axis (the last one) through
``kernels.harmonics.harmonic_sums``: on the card, at 65,536 photons per
row or more, that is the hand-written kernel K4; smaller or CPU inputs
take its f64 reference, as in the JAX package. Tensors stay on their
device; numpy input goes to ``device`` (default ``"cuda"``). A (G, n)
batch of phases gives G statistics from one kernel launch, which is
how :func:`hm_scan` scans a frequency grid.
"""

from __future__ import annotations

import math

import torch

from . import DTYPE, resolve_device
from .kernels import harmonics


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=DTYPE, device=resolve_device(device))


def _z_of(phases, m, weights, device):
    ph = _as_tensor(phases, device)
    w = None if weights is None else _as_tensor(weights, ph.device).to(DTYPE)
    c, s = harmonics.harmonic_sums(ph, m, weights=w)
    if w is None:
        norm = ph.shape[-1] / 2.0
    else:
        norm = torch.sum(w ** 2, dim=-1, keepdim=True) / 2.0
    return torch.cumsum((c ** 2 + s ** 2) / norm, dim=-1)


def _h_of(z):
    k = torch.arange(1, z.shape[-1] + 1, dtype=z.dtype, device=z.device)
    return torch.amax(z - 4.0 * k + 4.0, dim=-1)


def z2m(phases, m=2, device="cuda"):
    """Z^2_m test statistic for each harmonic count 1..m: the tensor
    [Z^2_1, ..., Z^2_m] (reference: eventstats.py::z2m)."""
    return _z_of(phases, int(m), None, device)


def z2mw(phases, weights, m=2, device="cuda"):
    """Weighted Z^2_m (reference: eventstats.py::z2mw)."""
    return _z_of(phases, int(m), weights, device)


def hm(phases, m=20, device="cuda"):
    """H-test statistic (de Jager, Raubenheimer & Swanepoel 1989):
    H = max_{1<=k<=m} (Z^2_k - 4k + 4)  (reference: eventstats.py::hm)."""
    return _h_of(_z_of(phases, int(m), None, device))


def hmw(phases, weights, m=20, device="cuda"):
    """Weighted H-test (reference: eventstats.py::hmw)."""
    return _h_of(_z_of(phases, int(m), weights, device))


def sf_hm(h, logprob=False):
    """Survival function (false-alarm probability) of the H-test.

    de Jager & Busching 2010 calibration: sf = exp(-0.4 H)
    (reference: eventstats.py::sf_hm).
    """
    h = float(h)
    logsf = -0.4 * h
    return logsf if logprob else math.exp(max(logsf, -745.0))


def sf_z2m(z, m=2):
    """Survival function of Z^2_m: chi^2 with 2m dof
    (reference: eventstats.py::sf_z2m)."""
    from scipy.stats import chi2

    return float(chi2.sf(float(z), 2 * m))


def sig2sigma(sig, logprob=False):
    """One-sided survival probability -> Gaussian sigma
    (reference: eventstats.py::sig2sigma; e.g. 2.866e-7 -> 5.0).
    With logprob=True, sig is ln(prob) and the deep tail uses the
    asymptotic inversion sigma ~ sqrt(-2 ln p - ln(2 pi) - 2 ln sigma).
    """
    from scipy.stats import norm

    if logprob:
        logp = float(sig)
        if logp < -700.0:
            # fixed-point on the Gaussian tail expansion
            s = math.sqrt(-2.0 * logp)
            for _ in range(30):
                s = math.sqrt(-2.0 * (logp + math.log(s)
                                      + 0.5 * math.log(2 * math.pi)))
            return s
        sig = math.exp(logp)
    return float(norm.isf(sig))


def h2sig(h):
    """H-test statistic -> Gaussian sigma (reference: eventstats.py::
    h2sig), through the log-probability so a huge H does not saturate
    at the f64 underflow floor."""
    return sig2sigma(sf_hm(h, logprob=True), logprob=True)


def hm_scan(phases_fn, f0_grid, m=20, device="cuda"):
    """H-test over a frequency grid: ``phases_fn(f0) -> phases (n,)``,
    a function of one f64 tensor that ``torch.func.vmap`` can map.

    The (G, n) phases of all G trials are built by ``vmap`` and go
    through one harmonic-sums call, one kernel launch on the card (the
    kernel stays outside ``vmap``: a ctypes call cannot be traced).
    Returns the (G,) H values (reference: the JAX package's
    ``jax.vmap`` of ``hm`` over the grid)."""
    f0 = (f0_grid.to(DTYPE) if isinstance(f0_grid, torch.Tensor) else
          torch.as_tensor(f0_grid, dtype=DTYPE,
                          device=resolve_device(device)))
    return hm(torch.func.vmap(phases_fn)(f0), m=m)
