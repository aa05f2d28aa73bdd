"""LCTemplate: normalized mixture of light-curve primitives + DC
(torch counterpart of the JAX package's ``templates/lctemplate.py``).

(reference: src/pint/templates/lctemplate.py — LCTemplate holds
primitives + NormAngles norms; __call__(phases) returns the density
1 + sum_i n_i (f_i(phi) - 1); integrates to 1 with DC fraction
1 - sum n_i.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import DTYPE, resolve_device
from .lcprimitives import _args


def _grid(lo, hi, n, device, endpoint=True):
    dev = resolve_device(device)
    if endpoint:
        return torch.linspace(lo, hi, n, dtype=DTYPE, device=dev)
    return torch.arange(n, dtype=DTYPE, device=dev) * ((hi - lo) / n) + lo


class LCTemplate:
    """Mixture template: density(phi) = (1-sum n) + sum n_i f_i(phi)."""

    def __init__(self, primitives, norms):
        self.primitives = list(primitives)
        self.norms = np.asarray(norms, float)
        if self.norms.sum() > 1.0 + 1e-9:
            raise ValueError("norms must sum to <= 1 (rest is DC)")
        if len(self.norms) != len(self.primitives):
            raise ValueError("one norm per primitive")

    # ---- parameter packing (for gradient fits) ----

    def get_parameters(self):
        """Flat vector [norms..., prim0.p..., prim1.p...]."""
        return np.concatenate([self.norms] + [pr.p for pr in self.primitives])

    def set_parameters(self, vec):
        vec = np.asarray(vec, float)
        n = len(self.primitives)
        self.norms = vec[:n].copy()
        i = n
        for pr in self.primitives:
            pr.p = vec[i:i + pr.n_params].copy()
            i += pr.n_params

    def __call__(self, phases, vec=None, log10_ens=None):
        """Density at phases; with vec given, a function of (vec,
        phases) that ``torch.autograd`` differentiates. ``log10_ens``
        (log10 MeV, per photon) feeds any energy-dependent primitives
        (reference: lctemplate.py::LCTemplate.__call__(phases, log10_ens))."""

        def evaluate(pr, ph, p):
            if pr.energy_dependent:
                return pr(ph, p=p, log10_ens=log10_ens)
            return pr(ph, p=p)

        ph, _ = _args(phases, self.norms if vec is None else vec)
        n = len(self.primitives)
        if vec is None:
            norms = torch.as_tensor(self.norms, dtype=DTYPE, device=ph.device)
            out = 1.0 - torch.sum(norms)
            for nm, pr in zip(self.norms, self.primitives):
                out = out + float(nm) * evaluate(pr, ph, pr.p)
            return out
        norms = vec[:n]
        out = (1.0 - torch.sum(norms)) * torch.ones_like(ph)
        i = n
        # norms indexed by primitive number, not by offset into vec (the
        # JAX package's fix: norms[i - n] walked past the end for the
        # second primitive on)
        for j, pr in enumerate(self.primitives):
            out = out + norms[j] * evaluate(pr, ph, vec[i:i + pr.n_params])
            i += pr.n_params
        return out

    def gradient_ready(self):
        """(density_fn(vec, phases[, log10_ens]), initial vec) for
        LCFitter; the energy argument reaches any energy-dependent
        primitives in the mixture."""
        vec0 = self.get_parameters()

        def fn(vec, phases, log10_ens=None):
            return self(phases, vec=vec, log10_ens=log10_ens)

        return fn, vec0

    def integrate(self, lo=0.0, hi=1.0, device="cuda"):
        x = _grid(lo, hi, 2049, device)
        return torch.trapezoid(self(x), x)

    def max_location(self, resolution=4096, device="cuda"):
        """Phase of the template peak."""
        x = _grid(0.0, 1.0, resolution, device, endpoint=False)
        return float(x[torch.argmax(self(x))])

    def as_binned(self, nbins=256, device="cuda"):
        """Bin-averaged template (for MCMCFitterBinnedTemplate)."""
        x = _grid(0.0, 1.0, nbins * 8, device, endpoint=False)
        return self(x).cpu().numpy().reshape(nbins, 8).mean(axis=1)


class LCEmpiricalFourier:
    """Template built nonparametrically from a binned profile via its
    Fourier series (reference: lctemplate.py::LCEmpiricalFourier).

    Keeps ``nharm`` harmonics of the (background-subtracted, normalized)
    profile; the density is 1 + sum_k [a_k cos(2 pi k phi) +
    b_k sin(2 pi k phi)], clipped to be nonnegative and renormalized.
    Exposes the same __call__/max_location surface as LCTemplate so
    fitters and phaseogram tools can take either.
    """

    def __init__(self, profile=None, phases=None, nharm=8, alpha=None,
                 beta=None):
        self.nharm = int(nharm)
        if alpha is not None:
            self.alpha = np.asarray(alpha, float)
            self.beta = np.asarray(beta, float)
            return
        if profile is not None:
            prof = np.asarray(profile, float)
            n = len(prof)
            spec = np.fft.rfft(prof)
            mean = spec[0].real / n
            kmax = min(self.nharm, len(spec) - 1)
            # density normalized to integrate to 1 on [0,1)
            self.alpha = 2.0 * spec[1:kmax + 1].real / (n * mean)
            self.beta = -2.0 * spec[1:kmax + 1].imag / (n * mean)
        elif phases is not None:
            ph = np.asarray(phases, float) % 1.0
            k = np.arange(1, self.nharm + 1)
            ang = 2 * np.pi * k[:, None] * ph[None, :]
            self.alpha = 2.0 * np.cos(ang).mean(axis=1)
            self.beta = 2.0 * np.sin(ang).mean(axis=1)
        else:
            raise ValueError("need profile=, phases=, or alpha=/beta=")

    def __call__(self, phases, vec=None, log10_ens=None):
        ph, alpha = _args(phases, self.alpha)
        beta = torch.as_tensor(self.beta, dtype=DTYPE, device=ph.device)
        k = torch.arange(1, len(self.alpha) + 1, dtype=DTYPE,
                         device=ph.device)
        ang = 2 * math.pi * k * ph[..., None]
        dens = (1.0 + torch.sum(alpha * torch.cos(ang), dim=-1)
                + torch.sum(beta * torch.sin(ang), dim=-1))
        # Fourier truncation can ring below zero on sharp pulses; the
        # density floor keeps log-likelihoods finite
        return torch.clamp(dens, min=1e-6)

    def max_location(self, resolution=4096, device="cuda"):
        x = _grid(0.0, 1.0, resolution, device, endpoint=False)
        return float(x[torch.argmax(self(x))])


# ---------------------------------------------------------------------------
# template file I/O (reference: lctemplate.py::gauss_template_from_file and
# the pygaussfit.py "# gauss" itemized format it reads; also prim_io writing)
# ---------------------------------------------------------------------------

_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))


def gauss_template_from_file(path) -> LCTemplate:
    """Read an itemized gaussian-template file into an LCTemplate.

    Accepts the presto/pygaussfit style used by the reference::

        const  = 0.30
        phas1  = 0.10 +/- 0.001
        fwhm1  = 0.03 +/- 0.001
        ampl1  = 0.50 +/- 0.01

    ``ampl`` entries are the pulsed norms (renormalized against const
    when they sum above 1-const); ``fwhm`` converts to the wrapped-
    Gaussian sigma.
    """
    from .lcprimitives import LCGaussian

    items = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            val = val.split("+/-")[0].strip()
            try:
                items[key.strip().lower()] = float(val)
            except ValueError:
                continue
    idx = sorted({int(k[4:]) for k in items
                  if k.startswith(("phas", "fwhm", "ampl")) and k[4:].isdigit()})
    if not idx:
        raise ValueError(f"{path}: no gaussian components found")
    prims, norms = [], []
    for i in idx:
        loc = items.get(f"phas{i}", 0.0) % 1.0
        sigma = items.get(f"fwhm{i}", 0.05) * _FWHM_TO_SIGMA
        prims.append(LCGaussian([max(sigma, 1e-4), loc]))
        norms.append(items.get(f"ampl{i}", 0.1))
    norms = np.asarray(norms, float)
    const = items.get("const", None)
    pulsed_cap = 1.0 if const is None else max(1.0 - const, 0.0)
    total = norms.sum()
    if total > pulsed_cap > 0:
        norms *= pulsed_cap / total
    elif total > 1.0:
        norms /= total
    return LCTemplate(prims, norms)


def write_gauss_template(template: LCTemplate, path):
    """Write an LCTemplate of plain Gaussians to the itemized file
    format; round-trips with gauss_template_from_file. Other primitive
    types have no representation in this format, so they are rejected
    rather than silently flattened to Gaussians."""
    from .lcprimitives import LCGaussian

    for pr in template.primitives:
        if type(pr) is not LCGaussian:
            raise ValueError(
                f"gauss template format only holds LCGaussian components; "
                f"got {type(pr).__name__}")
    lines = [f"const  = {1.0 - template.norms.sum():.6f}"]
    for i, (pr, nm) in enumerate(zip(template.primitives, template.norms),
                                 start=1):
        sigma = float(pr.p[0])
        lines.append(f"phas{i}  = {float(pr.loc) % 1.0:.6f}")
        lines.append(f"fwhm{i}  = {sigma / _FWHM_TO_SIGMA:.6f}")
        lines.append(f"ampl{i}  = {float(nm):.6f}")
    with open(path, "w") as f:
        f.write("# gauss\n" + "\n".join(lines) + "\n")
