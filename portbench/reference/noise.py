"""The plain noise model: scaled white errors, ECORR epochs, power-law
red noise, and draws of a realisation of all three.

- sigma = sqrt((EFAC sigma_toa)^2 + EQUAD^2) on the TOAs of each mask
  (EQUAD in us);
- ECORR: the TOAs of a mask sorted by UTC MJD, a new epoch at every gap
  over 2 s, single-TOA epochs dropped; each epoch's TOAs share an offset
  of variance ECORR^2;
- red noise: sin/cos pairs at k / T, k = 1..TNREDC, T the UTC span plus
  one day, t from the first TOA; prior variance per column
  P(f_k) / T, P(f) = A^2 / (12 pi^2) (f / f_yr)^-gamma yr^3, with
  tempo's RNAMP (us yr^1/2) as A = RNAMP 2 pi sqrt(3) / (1e6 yr) and
  gamma = -RNIDX, yr the Julian year.

Variances are in s^2 here.
"""

from __future__ import annotations

import math

import numpy as np

SECS_PER_DAY = 86400.0
YEAR_S = 365.25 * SECS_PER_DAY
EPOCH_GAP_DAYS = 2.0 / SECS_PER_DAY


def sigma_s(psr):
    efac = np.ones(len(psr.error_us))
    equad = np.zeros(len(psr.error_us))
    for m in psr.par.mask_params("EFAC"):
        efac = np.where(psr.flag_mask(m.flag, m.flag_value), m.value, efac)
    for m in psr.par.mask_params("EQUAD"):
        equad = np.where(psr.flag_mask(m.flag, m.flag_value), m.value, equad)
    return np.sqrt((efac * psr.error_us) ** 2 + equad ** 2) * 1e-6


def epochs(psr):
    """[(member indices, variance s^2)] of every ECORR epoch."""
    out = []
    for m in psr.par.mask_params("ECORR"):
        idx = np.flatnonzero(psr.flag_mask(m.flag, m.flag_value))
        idx = idx[np.argsort(psr.mjd_utc[idx], kind="stable")]
        if len(idx) == 0:
            continue
        cut = np.flatnonzero(np.diff(psr.mjd_utc[idx]) > EPOCH_GAP_DAYS) + 1
        for members in np.split(idx, cut):
            if len(members) >= 2:
                out.append((members, (m.value * 1e-6) ** 2))
    return out


def red_basis(psr):
    """(F (n, 2H), prior variances (2H,) s^2), or (None, None)."""
    par = psr.par
    if "RNAMP" not in par.values and "TNREDAMP" not in par.values:
        return None, None
    H = int(par.values.get("TNREDC", 30))
    mjd = psr.mjd_utc
    tspan = (mjd.max() - mjd.min() + 1.0) * SECS_PER_DAY
    t = (mjd - mjd.min()) * SECS_PER_DAY
    f = np.arange(1, H + 1) / tspan
    arg = 2.0 * math.pi * np.outer(t, f)
    F = np.empty((len(mjd), 2 * H))
    F[:, 0::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    if "TNREDAMP" in par.values:
        A = 10.0 ** par.values["TNREDAMP"]
        gamma = par.values["TNREDGAM"]
    else:
        A = par.values["RNAMP"] * 2.0 * math.pi * math.sqrt(3.0) / (
            1e6 * YEAR_S)
        gamma = -par.values["RNIDX"]
    fyr = 1.0 / YEAR_S
    psd = A ** 2 / (12.0 * math.pi ** 2) * (f / fyr) ** (-gamma) / fyr ** 3
    return F, np.repeat(psd / tspan, 2)


def draw(psr, rng):
    """One realisation of the pulsar's noise, in seconds per TOA."""
    out = rng.standard_normal(len(psr.error_us)) * sigma_s(psr)
    for members, var in epochs(psr):
        out[members] += rng.standard_normal() * math.sqrt(var)
    F, phi = red_basis(psr)
    if F is not None:
        out += F @ (rng.standard_normal(len(phi)) * np.sqrt(phi))
    return out
