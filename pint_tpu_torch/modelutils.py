"""Model conversion helpers: equatorial <-> ecliptic astrometry (host
numpy; counterpart of the JAX package's ``modelutils.py``).

(reference: src/pint/modelutils.py::model_equatorial_to_ecliptic,
model_ecliptic_to_equatorial.)

The sky position and proper-motion vector are rotated by the chosen
obliquity; parameter uncertainties are propagated through the
Jacobian of the angle map, taken by one-sided differences of step
1e-8 rad (``_pm_jacobian``), as in the JAX package.
"""

from __future__ import annotations

import copy

import numpy as np

from .constants import ARCSEC_TO_RAD, OBLIQUITY_ARCSEC
from .models.astrometry import AstrometryEcliptic, AstrometryEquatorial


def _eq_to_ecl_angles(ra, dec, eps):
    se, ce = np.sin(eps), np.cos(eps)
    x = np.cos(dec) * np.cos(ra)
    y = ce * np.cos(dec) * np.sin(ra) + se * np.sin(dec)
    z = -se * np.cos(dec) * np.sin(ra) + ce * np.sin(dec)
    return np.arctan2(y, x) % (2 * np.pi), np.arcsin(np.clip(z, -1, 1))


def _ecl_to_eq_angles(lon, lat, eps):
    se, ce = np.sin(eps), np.cos(eps)
    x = np.cos(lat) * np.cos(lon)
    y = ce * np.cos(lat) * np.sin(lon) - se * np.sin(lat)
    z = se * np.cos(lat) * np.sin(lon) + ce * np.sin(lat)
    return np.arctan2(y, x) % (2 * np.pi), np.arcsin(np.clip(z, -1, 1))


def _pm_jacobian(fwd, a, b, pma, pmb, eps):
    """Rotate (pm_a*cos b, pm_b) through the position transform by
    finite differences of the angle map."""
    h = 1e-8
    a2, b2 = fwd(a, b, eps)
    da_da, db_da = fwd(a + h / np.cos(b), b, eps)
    da_db, db_db = fwd(a, b + h, eps)

    def wrap(d):
        # difference of two angles that individually wrap at 2 pi: a
        # perturbation across the seam would otherwise read as ~2 pi
        return (d + np.pi) % (2 * np.pi) - np.pi

    # columns: unit steps along (a*cos b, b); rows: response in
    # (a2*cos b2, b2)
    J = np.array([
        [wrap(da_da - a2) * np.cos(b2) / h, wrap(da_db - a2) * np.cos(b2) / h],
        [wrap(db_da - b2) / h, wrap(db_db - b2) / h],
    ])
    pm = J @ np.array([pma, pmb])
    return pm[0], pm[1], J


def model_equatorial_to_ecliptic(model, ecl="IERS2010"):
    """(reference: modelutils.py::model_equatorial_to_ecliptic)"""
    old = model.components.get("AstrometryEquatorial")
    if old is None:
        raise ValueError("model has no AstrometryEquatorial component")
    eps = (OBLIQUITY_ARCSEC.get(ecl.upper(), OBLIQUITY_ARCSEC["DEFAULT"])
           * ARCSEC_TO_RAD)
    out = copy.deepcopy(model)
    ra, dec = old.RAJ.value, old.DECJ.value
    lon, lat = _eq_to_ecl_angles(ra, dec, eps)
    pml, pmb, J = _pm_jacobian(_eq_to_ecl_angles, ra, dec,
                               old.PMRA.value or 0.0, old.PMDEC.value or 0.0,
                               eps)
    comp = AstrometryEcliptic()
    comp.ELONG.value = lon
    comp.ELAT.value = lat
    comp.PMELONG.value = pml
    comp.PMELAT.value = pmb
    comp.PX.value = old.PX.value
    comp.POSEPOCH.value = old.POSEPOCH.value
    comp.ECL.value = ecl.upper()
    for src, dst in (("RAJ", "ELONG"), ("DECJ", "ELAT"),
                     ("PMRA", "PMELONG"), ("PMDEC", "PMELAT"),
                     ("PX", "PX"), ("POSEPOCH", "POSEPOCH")):
        sp, dp = getattr(old, src), getattr(comp, dst)
        dp.frozen = sp.frozen
    # uncertainty propagation through the same Jacobian (angles and PM
    # rotate identically at linear order)
    if old.RAJ.uncertainty is not None or old.DECJ.uncertainty is not None:
        sa = (old.RAJ.uncertainty or 0.0) * np.cos(dec)
        sb = old.DECJ.uncertainty or 0.0
        ca = np.hypot(J[0, 0] * sa, J[0, 1] * sb)
        cb = np.hypot(J[1, 0] * sa, J[1, 1] * sb)
        comp.ELONG.uncertainty = ca / np.cos(lat)
        comp.ELAT.uncertainty = cb
    for su, du in (("PMRA", "PMELONG"), ("PMDEC", "PMELAT")):
        if getattr(old, su).uncertainty is not None:
            i = 0 if du == "PMELONG" else 1
            spm1 = getattr(old, "PMRA").uncertainty or 0.0
            spm2 = getattr(old, "PMDEC").uncertainty or 0.0
            getattr(comp, du).uncertainty = np.hypot(J[i, 0] * spm1,
                                                     J[i, 1] * spm2)
    comp.PX.uncertainty = old.PX.uncertainty
    out.remove_component("AstrometryEquatorial")
    out.add_component(comp)
    return out


def model_ecliptic_to_equatorial(model):
    """(reference: modelutils.py::model_ecliptic_to_equatorial)"""
    old = model.components.get("AstrometryEcliptic")
    if old is None:
        raise ValueError("model has no AstrometryEcliptic component")
    eps = old.obliquity_rad()
    out = copy.deepcopy(model)
    lon, lat = old.ELONG.value, old.ELAT.value
    ra, dec = _ecl_to_eq_angles(lon, lat, eps)
    pma, pmd, J = _pm_jacobian(_ecl_to_eq_angles, lon, lat,
                               old.PMELONG.value or 0.0,
                               old.PMELAT.value or 0.0, eps)
    comp = AstrometryEquatorial()
    comp.RAJ.value = ra
    comp.DECJ.value = dec
    comp.PMRA.value = pma
    comp.PMDEC.value = pmd
    comp.PX.value = old.PX.value
    comp.POSEPOCH.value = old.POSEPOCH.value
    for src, dst in (("ELONG", "RAJ"), ("ELAT", "DECJ"),
                     ("PMELONG", "PMRA"), ("PMELAT", "PMDEC"),
                     ("PX", "PX"), ("POSEPOCH", "POSEPOCH")):
        getattr(comp, dst).frozen = getattr(old, src).frozen
    if old.ELONG.uncertainty is not None or old.ELAT.uncertainty is not None:
        sa = (old.ELONG.uncertainty or 0.0) * np.cos(lat)
        sb = old.ELAT.uncertainty or 0.0
        comp.RAJ.uncertainty = np.hypot(J[0, 0] * sa, J[0, 1] * sb) / np.cos(dec)
        comp.DECJ.uncertainty = np.hypot(J[1, 0] * sa, J[1, 1] * sb)
    for i, du in ((0, "PMRA"), (1, "PMDEC")):
        s1 = old.PMELONG.uncertainty or 0.0
        s2 = old.PMELAT.uncertainty or 0.0
        if old.PMELONG.uncertainty is not None or old.PMELAT.uncertainty is not None:
            getattr(comp, du).uncertainty = np.hypot(J[i, 0] * s1, J[i, 1] * s2)
    comp.PX.uncertainty = old.PX.uncertainty
    out.remove_component("AstrometryEcliptic")
    out.add_component(comp)
    return out
