"""Light-curve primitive components: wrapped peaks on the phase circle
(torch counterpart of the JAX package's ``templates/lcprimitives.py``).

(reference: src/pint/templates/lcprimitives.py — LCGaussian,
LCVonMises, LCPrimitive base with loc/width params, get_location.)

Each primitive is a normalized density on [0,1); parameters are a small
vector [width-like params..., location], a numpy array between fits and
a tensor slice of the parameter vector inside one, so templates
differentiate with ``torch.autograd``. A parameter may also be a
per-photon tensor (the energy-dependent primitives pass those).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import DTYPE, resolve_device


def _args(phases, p):
    """(phases, params) as float64 tensors on one device: the phases'
    if they are a tensor, else the params', else the card."""
    if isinstance(phases, torch.Tensor):
        dev = phases.device
    elif isinstance(p, torch.Tensor):
        dev = p.device
    else:
        dev = resolve_device("cuda")
    ph = torch.as_tensor(phases, dtype=DTYPE, device=dev)
    return ph, torch.as_tensor(p, dtype=DTYPE, device=dev)


class LCPrimitive:
    """Base: density f(phi) normalized over the unit circle."""

    n_params = 2
    energy_dependent = False

    def __init__(self, p):
        self.p = np.asarray(p, float)

    @property
    def loc(self):
        return self.p[-1]

    def __call__(self, phases, p=None):
        raise NotImplementedError

    def integrate(self, lo=0.0, hi=1.0, device="cuda"):
        """Fraction of the density in [lo, hi); default 1 (a 1025-point
        trapezoid on ``device``)."""
        x = torch.linspace(lo, hi, 1025, dtype=DTYPE,
                           device=resolve_device(device))
        return torch.trapezoid(self(x), x)

    def project_params(self, q):
        """Constrain one optimizer step's slice of this primitive's
        params (LCFitter calls this after each update): widths stay
        positive, the trailing location wraps to [0, 1)."""
        q = q.clone()
        q[:-1] = torch.clamp(q[:-1], min=1e-4)
        q[-1] = q[-1] % 1.0
        return q


class LCGaussian(LCPrimitive):
    """Wrapped Gaussian (reference: lcprimitives.py::LCGaussian):
    p = [sigma, loc]."""

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        sigma, loc = p[0], p[1]
        # sum over wraps k = -2..2 (sigma << 1 in practice); the
        # (ph - loc) form broadcasts per-photon params (lceprimitives)
        k = torch.arange(-2, 3, dtype=DTYPE, device=ph.device)
        z = ((ph - loc)[..., None] + k) / sigma[..., None]
        return torch.sum(torch.exp(-0.5 * z**2), dim=-1) / (
            sigma * math.sqrt(2 * math.pi))


class LCLorentzian(LCPrimitive):
    """Wrapped Lorentzian (reference: lcprimitives.py::LCLorentzian):
    p = [gamma (HWHM), loc]. The infinite wrap sum has the closed form
    sum_k gamma/pi/((x+k)^2+gamma^2) = sinh(2 pi gamma) /
    (cosh(2 pi gamma) - cos(2 pi x))  (normalized on [0,1))."""

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        gamma, loc = p[0], p[1]
        x = 2 * math.pi * (ph - loc)
        g = 2 * math.pi * gamma
        return torch.sinh(g) / (torch.cosh(g) - torch.cos(x))


class LCSkewGaussian(LCPrimitive):
    """Two-sided (skew) wrapped Gaussian
    (reference: lcprimitives.py::LCGaussian2): p = [sigma1, sigma2,
    loc] — width sigma1 leading (phi < loc), sigma2 trailing;
    normalized density with continuous peak."""

    n_params = 3

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        s1, s2, loc = p[0], p[1], p[2]
        k = torch.arange(-2, 3, dtype=DTYPE, device=ph.device)
        d = (ph - loc)[..., None] + k
        sig = torch.where(d < 0, s1[..., None], s2[..., None])
        dens = torch.exp(-0.5 * (d / sig) ** 2)
        # normalization: integral = sqrt(pi/2)(s1+s2)
        return torch.sum(dens, dim=-1) / (
            math.sqrt(math.pi / 2.0) * (s1 + s2))


class LCLorentzian2(LCPrimitive):
    """Two-sided wrapped Lorentzian (reference: lcprimitives.py::
    LCLorentzian2): p = [gamma1, gamma2, loc], HWHM gamma1 leading
    (phi < loc), gamma2 trailing, continuous at the peak.

    The wrap sum is truncated at ±K turns, but the normalization is
    exact for the truncated kernel: integrating the k-sum over one
    cycle telescopes to F(K+1-loc) - F(-K-loc) with F the two-sided
    Lorentzian CDF (closed form in arctan), so the density integrates
    to exactly 1 on [0,1) and stays differentiable in all params.
    """

    n_params = 3
    _K = 5  # wrap truncation (normalization exact regardless; see above)

    @staticmethod
    def _cdf(d, g1, g2):
        w1 = g1 / (g1 + g2)
        w2 = 1.0 - w1
        lead = w1 * (1.0 + (2.0 / math.pi) * torch.arctan(d / g1))
        trail = w1 + w2 * (2.0 / math.pi) * torch.arctan(d / g2)
        return torch.where(d < 0, lead, trail)

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        g1, g2, loc = p[0], p[1], p[2]
        K = self._K
        k = torch.arange(-K, K + 1, dtype=DTYPE, device=ph.device)
        d = (ph - loc)[..., None] + k
        g = torch.where(d < 0, g1[..., None], g2[..., None])
        # unnormalized two-sided kernel: 1/(1+(d/g)^2), continuous at 0
        dens = torch.sum(1.0 / (1.0 + (d / g) ** 2), dim=-1)
        # peak height of the unit kernel is 1; line-integral of the
        # kernel is (pi/2)(g1+g2) * (covered mass fraction)
        mass = self._cdf(K + 1.0 - loc, g1, g2) - self._cdf(-K - loc, g1, g2)
        return dens / ((math.pi / 2.0) * (g1 + g2) * mass)


# Upstream-parity alias: LCSkewGaussian's p = [sigma1, sigma2, loc]
# IS the reference LCGaussian2 parameterization.
LCGaussian2 = LCSkewGaussian


class LCVonMises(LCPrimitive):
    """von Mises peak (reference: lcprimitives.py::LCVonMises):
    p = [kappa_inv, loc]; density ~ exp(kappa cos(2pi(phi-loc)))."""

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        kappa = 1.0 / p[0]
        loc = p[1]
        # density on [0,1): exp(k cos)/I0(k); i0e(k) = exp(-k) I0(k)
        # keeps the ratio finite for large kappa
        return (torch.exp(kappa * (torch.cos(2 * math.pi * (ph - loc)) - 1.0))
                / torch.special.i0e(kappa))


class LCTopHat(LCPrimitive):
    """Top-hat (boxcar) component (reference: lcprimitives.py::LCTopHat):
    p = [width, loc]; uniform density 1/width on the wrapped interval
    centered at loc. A steep-but-smooth logistic edge (scale width/50)
    keeps it differentiable for the gradient fitters."""

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        width, loc = p[0], p[1]
        # wrapped distance from center in [-0.5, 0.5)
        d = (ph - loc + 0.5) % 1.0 - 0.5
        edge = width / 50.0
        inside = (torch.sigmoid((width / 2.0 - d) / edge)
                  * torch.sigmoid((width / 2.0 + d) / edge))
        return inside / width


class LCHarmonic(LCPrimitive):
    """Single-harmonic density (reference: lcprimitives.py::LCHarmonic):
    p = [order, loc]; density 1 + cos(2 pi m (phi - loc)). ``order``
    is a structural (integer, non-fitted) parameter."""

    def __init__(self, p):
        super().__init__(p)
        self.order = int(round(float(self.p[0])))

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        loc = p[1]
        return 1.0 + torch.cos(2 * math.pi * self.order * (ph - loc))

    def project_params(self, q):
        # the harmonic order is structural, not a fit parameter
        q = q.clone()
        q[0] = float(self.order)
        q[1] = q[1] % 1.0
        return q


class LCKernelDensity(LCPrimitive):
    """Non-parametric wrapped-Gaussian KDE of a photon-phase sample
    (reference: lcprimitives.py::LCKernelDensity).

    Construction evaluates a binned KDE once on a phase grid (host
    numpy, as in the JAX package): photons are histogrammed on
    ``nbins`` and circularly smoothed with a wrapped Gaussian kernel
    via FFT, the exact binned KDE on the circle. ``__call__`` then
    linearly interpolates the grid. ``bandwidth=None`` uses the
    circular Silverman rule h = 1.06 * sigma_c * n^(-1/5). p = [loc]:
    the single fit parameter is a phase shift of the frozen empirical
    shape.
    """

    n_params = 1

    def __init__(self, phases, weights=None, bandwidth=None, nbins=512,
                 loc=0.0):
        ph = np.asarray(phases, np.float64) % 1.0
        w = (np.ones_like(ph) if weights is None
             else np.asarray(weights, np.float64))
        if bandwidth is None:
            # circular Silverman: resultant-based sigma
            C = np.sum(w * np.cos(2 * np.pi * ph))
            S = np.sum(w * np.sin(2 * np.pi * ph))
            R = np.sqrt(C * C + S * S) / max(np.sum(w), 1e-300)
            R = min(max(R, 1e-12), 1.0 - 1e-12)
            sigma_c = np.sqrt(-2.0 * np.log(R)) / (2 * np.pi)
            n_eff = float(np.sum(w)) ** 2 / float(np.sum(w * w))
            bandwidth = 1.06 * max(sigma_c, 1.0 / nbins) * n_eff ** (-0.2)
        self.bandwidth = float(bandwidth)
        hist, _ = np.histogram(ph, bins=nbins, range=(0.0, 1.0), weights=w)
        # wrapped-Gaussian smoothing on the circle == multiply the
        # histogram's Fourier coefficients by exp(-2 (pi k h)^2)
        k = np.fft.rfftfreq(nbins, d=1.0 / nbins)
        F = np.fft.rfft(hist) * np.exp(-2.0 * (np.pi * k * self.bandwidth) ** 2)
        dens = np.fft.irfft(F, nbins) * nbins / max(np.sum(w), 1e-300)
        self.grid = np.maximum(dens, 1e-12)  # density, mean exactly 1
        self.nbins = nbins
        super().__init__([loc])

    @property
    def loc(self):
        return float(self.p[0]) % 1.0

    def __call__(self, phases, p=None):
        ph, p = _args(phases, self.p if p is None else p)
        # histogram mass for bin i sits at the bin CENTER (i+0.5)/nbins:
        # interpolate on center coordinates
        x = (ph - p[0]) % 1.0 * self.nbins - 0.5
        i0 = torch.floor(x).to(torch.int64) % self.nbins
        i1 = (i0 + 1) % self.nbins
        frac = x - torch.floor(x)
        g = torch.as_tensor(self.grid, dtype=DTYPE, device=ph.device)
        return g[i0] * (1.0 - frac) + g[i1] * frac
