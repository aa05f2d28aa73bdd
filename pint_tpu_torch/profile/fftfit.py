"""fftfit: the phase shift between a folded profile and a template by
Fourier-domain matching (Taylor 1992), on torch (counterpart of the
JAX package's ``profile/fftfit.py``).

(reference: src/pint/profile/fftfit_aarchiba.py::fftfit_full /
fftfit_basic — model: profile ~ offset + scale * template(phi - shift)
+ noise; solve for shift/scale/offset and their uncertainties.)

The FFTs and the shift objective run on ``device``; the 1-D maximum is
a dense grid's first argmax followed by a fixed count of Newton steps,
each clipped to one grid cell, so there is no data-dependent control
flow. The results come to the host as Python floats.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import DTYPE, resolve_device


@dataclass
class FFTFITResult:
    shift: float
    uncertainty: float
    scale: float
    offset: float
    snr: float


def _spectra(template, profile, device):
    dev = resolve_device(device)
    t = torch.as_tensor(template, dtype=DTYPE).to(dev)
    p = torch.as_tensor(profile, dtype=DTYPE).to(dev)
    return t.shape[0], torch.fft.rfft(t), torch.fft.rfft(p)


def _wrap(tau) -> float:
    """A shift in turns as a float in [-0.5, 0.5)."""
    shift = float(tau)
    return shift - round(shift)


def fftfit_full(template, profile, ngrid=1024, newton_iters=6,
                device="cuda"):
    """Full Taylor-method fit -> FFTFITResult.

    shift is the phase (in turns, in [-0.5, 0.5)) by which the template
    must be rotated to match the profile.
    """
    n, T, P = _spectra(template, profile, device)
    k = torch.arange(1, T.shape[0], dtype=DTYPE, device=T.device)
    Tk, Pk = T[1:], P[1:]
    amp = torch.abs(Pk) * torch.abs(Tk)
    dphi = torch.angle(Pk) - torch.angle(Tk)
    two_pi_k = 2 * math.pi * k

    def corr(tau):
        return torch.sum(amp * torch.cos(dphi + two_pi_k * tau))

    def dcorr(tau):
        return torch.sum(-two_pi_k * amp * torch.sin(dphi + two_pi_k * tau))

    def d2corr(tau):
        return torch.sum(-two_pi_k ** 2 * amp * torch.cos(dphi + two_pi_k * tau))

    taus = -0.5 + torch.arange(ngrid, dtype=DTYPE, device=T.device) / ngrid
    vals = torch.sum(amp[None, :] * torch.cos(
        dphi[None, :] + two_pi_k[None, :] * taus[:, None]), dim=1)
    tau = taus[torch.argmax(vals)]  # the first maximum
    for _ in range(newton_iters):
        step = dcorr(tau) / d2corr(tau)
        # stay inside the grid cell (d2 < 0 at a maximum)
        tau = tau - torch.clamp(step, -1.0 / ngrid, 1.0 / ngrid)
    # scale and offset (Taylor 1992)
    t2 = torch.sum(torch.abs(Tk) ** 2)
    b = corr(tau) / t2
    off = (P[0].real - b * T[0].real) / n
    # the noise from the residual power; the shift's from the curvature
    resid_pow = torch.sum(torch.abs(Pk) ** 2) - 2 * b * corr(tau) + b ** 2 * t2
    sigma2 = torch.clamp(resid_pow, min=1e-300) / (2.0 * k.shape[0])
    var_tau = sigma2 / torch.clamp(-b * d2corr(tau), min=1e-300)
    snr = b * torch.sqrt(t2 / torch.clamp(sigma2, min=1e-300))
    return FFTFITResult(shift=_wrap(tau),
                        uncertainty=float(torch.sqrt(var_tau)),
                        scale=float(b), offset=float(off), snr=float(snr))


def fftfit_basic(template, profile, **kw):
    """Shift only (reference: fftfit_basic)."""
    return fftfit_full(template, profile, **kw).shift


def fftfit_cc(template, profile, upsample=32, device="cuda"):
    """The cross-correlation backend: the zero-padded inverse FFT of
    P * conj(T) (an upsampled correlation series) and a parabola
    through its first maximum and the two neighbours. It maximizes
    fftfit_full's objective on a finer grid, so the two backends check
    each other (as the reference's several backends do:
    src/pint/profile/fftfit_aarchiba.py / fftfit_nustar.py /
    fftfit_presto.py). Returns the shift in turns, in [-0.5, 0.5)."""
    n, T, P = _spectra(template, profile, device)
    cross = P * torch.conj(T)
    # the DC term carries no shift information
    cross = torch.cat([torch.zeros_like(cross[:1]), cross[1:]])
    m = n * upsample
    corr = torch.fft.irfft(cross, m)
    i = torch.argmax(corr)
    y0 = corr[(i - 1) % m]
    y1 = corr[i]
    y2 = corr[(i + 1) % m]
    denom = y0 - 2 * y1 + y2
    frac = torch.where(torch.abs(denom) > 1e-300, 0.5 * (y0 - y2) / denom,
                       torch.zeros_like(denom))
    return _wrap((i + frac) / m)
