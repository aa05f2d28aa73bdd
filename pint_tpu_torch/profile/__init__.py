"""Folded-profile operations: fftfit template matching (counterpart of
the JAX package's ``profile/``).

(reference: src/pint/profile/__init__.py + fftfit_aarchiba.py /
fftfit_nustar.py / fftfit_presto.py — the three backends' call
surfaces over the one torch implementation of ``fftfit.py``.)
"""

import numpy as np
import torch

from .fftfit import (FFTFITResult, fftfit_basic, fftfit_cc,  # noqa: F401
                     fftfit_full)


def fftfit_full_aarchiba(template, profile, **kw):
    """The aarchiba backend's surface
    (reference: profile/fftfit_aarchiba.py::fftfit_full)."""
    return fftfit_full(template, profile, **kw)


def fftfit_basic_aarchiba(template, profile, **kw):
    return fftfit_basic(template, profile, **kw)


def fftfit_full_nustar(template, profile, **kw):
    """The nustar backend's surface: (shift, eshift, snr, esnr)."""
    r = fftfit_full(template, profile, **kw)
    return r.shift, r.uncertainty, r.snr, 0.0


def fftfit_full_presto(template, profile, **kw):
    """The presto backend's surface: shift and uncertainty in BINS."""
    r = fftfit_full(template, profile, **kw)
    n = len(profile)
    return r.shift * n, r.uncertainty * n


def fftfit_cprof(profile):
    """presto's cprof: (c, amp, phase), the harmonic decomposition of a
    profile, on the host (reference: profile/__init__.py::fftfit_cprof)."""
    if isinstance(profile, torch.Tensor):
        profile = profile.detach().cpu().numpy()
    p = np.asarray(profile, float)
    spec = np.fft.rfft(p)
    return p.sum(), np.abs(spec[1:]), np.angle(spec[1:])
