"""Checks of the TOA stage that the reference takes from the port: the
TDB epochs, the observatory's SSB position and the observatory->Sun
vector, each against what the raw inputs give on their own.

- ``tdb_gap_s``: the port's TDB against the tim file's UTC, plus TAI-UTC
  from the leap-second file, 32.184 s and the ten leading terms of
  Fairhead & Bretagnon's (1990) TDB-TT series with its T-term. The port
  integrates TDB-TT from its ephemeris and adds the topocentric term
  (~2 us), so this gap stays near ten microseconds: it catches a wrong
  leap second, day or time scale, not a small error.
- ``obs_geo_gap_m``: the observatory's distance from the geocentre
  (|SSB->obs - SSB->Earth|, the Earth from the ephemeris file at the
  port's TDB) against the site's ITRF radius, which no rotation changes.
- ``obs_sun_gap_m``: SSB->obs + obs->Sun against SSB->Sun from the file.

The ephemeris, leap-second and observatory files are the raw inputs
both sides read.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .spk import MJD_J2000, Kernel

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "pint_tpu_torch", "data")
NTP_EPOCH_MJD = 15020
TT_MINUS_TAI_S = 32.184
# Fairhead & Bretagnon (1990), their ten leading terms and the leading
# T-term, as ERFA's dtdb tabulates them: amplitude [s], rate [rad per
# Julian millennium], phase [rad]
FB_TERMS = (
    (1656.674564e-6, 6283.075849991, 6.240054195),
    (22.417471e-6, 5753.384884897, 4.296977442),
    (13.839792e-6, 12566.151699983, 6.196904410),
    (4.770086e-6, 529.690965095, 0.444401603),
    (4.676740e-6, 6069.776754553, 4.021195093),
    (2.256707e-6, 213.299095438, 5.543113262),
    (1.694205e-6, -3.523118349, 5.025132748),
    (1.554905e-6, 77713.771467920, 5.198467090),
    (1.276839e-6, 7860.419392439, 5.988822341),
    (1.193379e-6, 5223.693919802, 3.649823730),
)
FB_T_TERM = (102.156724e-6, 6283.075849991, 4.249032005)
_KERNEL = None


def kernel():
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = Kernel(os.path.join(DATA, "numeph_v1.bsp"))
    return _KERNEL


def leap_table():
    rows = []
    with open(os.path.join(DATA, "leap-seconds.list")) as f:
        for line in f:
            words = line.split()
            if words and not words[0].startswith("#"):
                rows.append((NTP_EPOCH_MJD + int(words[0]) // 86400,
                             float(words[1])))
    return np.array(rows)


def site_radius_m(site):
    """The ITRF radius of the site the tim file names (its name or one
    of its aliases in the observatory file)."""
    with open(os.path.join(DATA, "observatories.json")) as f:
        table = json.load(f)
    for name, entry in table.items():
        if site.lower() in (name, *entry.get("aliases", ())):
            return float(np.linalg.norm(entry["itrf_xyz"]))
    raise KeyError(f"no observatory {site!r}")


def tdb_minus_tt_fb(mjd_tt):
    T = (mjd_tt - MJD_J2000) / 365250.0
    out = np.zeros_like(T)
    for a, w, p in FB_TERMS:
        out += a * np.sin(w * T + p)
    a, w, p = FB_T_TERM
    return out + a * T * np.sin(w * T + p)


def rounded(psr, dtype):
    """The pulsar with the TOA stage's columns (TDB seconds, observatory
    and Sun vectors) rounded to ``dtype``: the stage's control."""
    import dataclasses

    return dataclasses.replace(
        psr, tdb_sec=psr.tdb_sec.astype(dtype).astype(np.float64),
        obs_pos_m=psr.obs_pos_m.astype(dtype).astype(np.float64),
        obs_sun_m=psr.obs_sun_m.astype(dtype).astype(np.float64))


def check(psr):
    leaps = leap_table()
    day_utc = np.floor(psr.mjd_utc)
    idx = np.searchsorted(leaps[:, 0], day_utc, side="right") - 1
    tai_utc = leaps[idx, 1]
    sec_utc = (psr.mjd_utc - day_utc) * 86400.0
    mjd_tt = psr.mjd_utc + (tai_utc + TT_MINUS_TAI_S) / 86400.0
    tdb_ref_s = sec_utc + tai_utc + TT_MINUS_TAI_S + tdb_minus_tt_fb(mjd_tt)
    tdb_port_s = (psr.tdb_day - day_utc) * 86400.0 + psr.tdb_sec
    et = (psr.tdb_day - MJD_J2000) * 86400.0 + psr.tdb_sec
    k = kernel()
    earth = k.ssb_km(399, et) * 1e3
    sun = k.ssb_km(10, et) * 1e3
    geo = np.linalg.norm(psr.obs_pos_m - earth, axis=-1)
    return {
        "tdb_gap_s": float(np.max(np.abs(tdb_port_s - tdb_ref_s))),
        "obs_geo_gap_m": float(np.max(np.abs(geo - site_radius_m(psr.site)))),
        "obs_sun_gap_m": float(np.max(np.linalg.norm(
            psr.obs_pos_m + psr.obs_sun_m - sun, axis=-1))),
    }
