"""Derived astrophysical quantities from timing parameters.

(reference: src/pint/derived_quantities.py — mass_function,
companion_mass, pulsar_mass, pulsar_age, pulsar_B, pulsar_B_lightcyl,
pulsar_edot, omdot, gamma, pbdot, shklovskii_factor, dispersion_slope,
p_to_f / pferrs.)

No astropy here: arguments are plain floats, numpy arrays or torch
tensors in documented units (the reference wraps the same closed-form
expressions in astropy Quantities). A host-math copy of the JAX
package's ``derived_quantities.py``; only ``_sqrt`` differs (torch in
place of jax.numpy).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import (
    AU_M,
    C_M_S,
    DMconst,
    MASYR_TO_RADS,
    PC_M,
    SECS_PER_DAY,
    SECS_PER_JULIAN_YEAR,
    TSUN_S,
)

_TWO_PI = 2.0 * math.pi
# moment of inertia 1e45 g cm^2 = 1e38 kg m^2 (reference convention)
_I_NS_SI = 1.0e38


def _sqrt(x):
    """sqrt that follows the argument's world: torch for tensors,
    numpy otherwise (negative -> nan, never complex)."""
    if isinstance(x, torch.Tensor):
        return torch.sqrt(x)
    return np.sqrt(x)


def p_to_f(p, pd, pdd=None):
    """(P [s], Pdot) -> (F0 [Hz], F1); inverse of itself. Accepts
    scalars or array-likes (reference: derived_quantities.py::p_to_f)."""
    p = np.asarray(p, dtype=np.float64) if not np.isscalar(p) else p
    pd = np.asarray(pd, dtype=np.float64) if not np.isscalar(pd) else pd
    if pdd is not None and not np.isscalar(pdd):
        pdd = np.asarray(pdd, dtype=np.float64)
    f = 1.0 / p
    fd = -pd / p**2
    if pdd is None:
        return f, fd
    fdd = 2.0 * pd**2 / p**3 - pdd / p**2
    return f, fd, fdd


def pferrs(p, perr, pd=None, pderr=None):
    """Propagate (P, Pdot) uncertainties to (F0, F1)
    (reference: derived_quantities.py::pferrs)."""
    if pd is None:
        return 1.0 / p, perr / p**2
    f, fd = p_to_f(p, pd)
    ferr = perr / p**2
    fderr = _sqrt((4.0 * pd**2 * perr**2 / p**6) + pderr**2 / p**4)
    return f, ferr, fd, fderr


def mass_function(pb_days, a1_ls):
    """Binary mass function [Msun].

    f = 4 pi^2 x^3 / (T_sun Pb^2), x in ls, Pb in s
    (reference: derived_quantities.py::mass_funct).
    """
    pb_s = pb_days * SECS_PER_DAY
    return 4.0 * math.pi**2 * a1_ls**3 / (TSUN_S * pb_s**2)


# upstream spelling (reference: derived_quantities.py::mass_funct)
mass_funct = mass_function


def mass_funct2(mp, mc, sini):
    """Mass function from component masses [Msun]
    (reference: derived_quantities.py::mass_funct2)."""
    return (mc * sini) ** 3 / (mp + mc) ** 2


def companion_mass(pb_days, a1_ls, sini=1.0, mp=1.4, iters=64):
    """Solve the mass function for Mc [Msun] given Mp and sin(i).

    Newton iteration on (Mc sini)^3/(Mp+Mc)^2 = f(Pb, x)
    (reference: derived_quantities.py::companion_mass, which solves the
    same cubic via numpy roots; Newton from a guaranteed-left start is
    branch-free and converges monotonically).
    """
    f = mass_function(pb_days, a1_ls)
    mc = f + 1e-6  # start left of the root; Newton ascends monotonically
    for _ in range(iters):
        g = (mc * sini) ** 3 / (mp + mc) ** 2 - f
        dg = (3.0 * sini**3 * mc**2 * (mp + mc) - 2.0 * (mc * sini) ** 3) / (
            mp + mc
        ) ** 3
        mc = mc - g / dg
    return mc


def pulsar_mass(pb_days, a1_ls, mc, sini):
    """Mp [Msun] from the mass function given Mc and sin(i)
    (reference: derived_quantities.py::pulsar_mass)."""
    f = mass_function(pb_days, a1_ls)
    return _sqrt((mc * sini) ** 3 / f) - mc


def pulsar_age(f0, f1, n=3, fo=1e99):
    """Characteristic age [yr]; braking index n, original spin fo
    (reference: derived_quantities.py::pulsar_age)."""
    age_s = -f0 / ((n - 1.0) * f1) * (1.0 - (f0 / fo) ** (n - 1.0))
    return age_s / SECS_PER_JULIAN_YEAR


def pulsar_edot(f0, f1, I=_I_NS_SI):
    """Spin-down luminosity [W] (reference: derived_quantities.py::pulsar_edot).
    I in kg m^2 (default 1e38 = 1e45 g cm^2)."""
    return -4.0 * math.pi**2 * I * f0 * f1


def pulsar_B(f0, f1):
    """Surface dipole field [Gauss]: 3.2e19 sqrt(-F1/F0^3)
    (reference: derived_quantities.py::pulsar_B). _sqrt keeps
    spin-up (F1>0) as nan rather than a silent complex value."""
    return 3.2e19 * _sqrt(-f1 / f0**3)


def pulsar_B_lightcyl(f0, f1):
    """Field at the light cylinder [Gauss]
    (reference: derived_quantities.py::pulsar_B_lightcyl)."""
    p, pd = 1.0 / f0, -f1 / f0**2
    return 2.9e8 * p ** (-5.0 / 2.0) * _sqrt(pd)


def omdot(mp, mc, pb_days, e):
    """GR periastron advance [deg/yr]
    (reference: derived_quantities.py::omdot)."""
    pb_s = pb_days * SECS_PER_DAY
    rate = (
        3.0
        * (pb_s / _TWO_PI) ** (-5.0 / 3.0)
        * (TSUN_S * (mp + mc)) ** (2.0 / 3.0)
        / (1.0 - e**2)
    )  # rad/s
    return rate * SECS_PER_JULIAN_YEAR * 180.0 / math.pi


def gamma(mp, mc, pb_days, e):
    """GR time-dilation/grav-redshift amplitude gamma [s]
    (reference: derived_quantities.py::gamma)."""
    pb_s = pb_days * SECS_PER_DAY
    return (
        e
        * (pb_s / _TWO_PI) ** (1.0 / 3.0)
        * TSUN_S ** (2.0 / 3.0)
        * (mp + mc) ** (-4.0 / 3.0)
        * mc
        * (mp + 2.0 * mc)
    )


def pbdot(mp, mc, pb_days, e):
    """GR orbital decay Pbdot [s/s]
    (reference: derived_quantities.py::pbdot)."""
    pb_s = pb_days * SECS_PER_DAY
    fe = (1.0 + (73.0 / 24.0) * e**2 + (37.0 / 96.0) * e**4) * (1.0 - e**2) ** (
        -7.0 / 2.0
    )
    return (
        -192.0
        * math.pi
        / 5.0
        * (pb_s / _TWO_PI) ** (-5.0 / 3.0)
        * fe
        * TSUN_S ** (5.0 / 3.0)
        * mp
        * mc
        * (mp + mc) ** (-1.0 / 3.0)
    )


def sini_from_omdot(mp, mc, pb_days, e, a1_ls):
    """sin(i) implied by GR omdot masses via the mass function."""
    f = mass_function(pb_days, a1_ls)
    return (f * (mp + mc) ** 2) ** (1.0 / 3.0) / mc


def shklovskii_factor(pmtot_masyr, d_kpc):
    """Shklovskii apparent Pdot/P [1/s]: mu^2 d / c
    (reference: derived_quantities.py::shklovskii_factor)."""
    mu = pmtot_masyr * MASYR_TO_RADS  # rad/s
    d_m = d_kpc * 1000.0 * PC_M
    return mu**2 * d_m / C_M_S


def dispersion_slope(dm):
    """DM delay slope K*DM [s MHz^2]
    (reference: derived_quantities.py::dispersion_slope)."""
    return DMconst * dm


def pmtot(pmra_or_elong, pmdec_or_elat):
    """Total proper motion [mas/yr] (reference: utils.py::pmtot)."""
    return _sqrt(pmra_or_elong**2 + pmdec_or_elat**2)
