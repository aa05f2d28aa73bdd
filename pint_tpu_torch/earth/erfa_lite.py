"""Earth rotation: ITRF -> GCRS observatory position/velocity (the JAX
package's ``earth/erfa_lite.py``, host numpy; ``ephemeris/vsop87.py``
reads its obliquity and precession too).

TPU-native replacement for the reference's ERFA chain
(reference: src/pint/erfautils.py::gcrs_posvel_from_itrf, which calls
astropy/ERFA pnm06a+era00+polar motion). ERFA (C) is not available in
the build environment, so this module implements the needed subset
directly:

- Earth Rotation Angle (ERA, IAU 2000)
- GMST/GAST via IAU 2006 polynomial + equation of the equinoxes
- Frame bias + IAU 1976/2000-style precession angles
- FULL 77-term IAU 2000B nutation (6-coefficient form + planetary
  bias; reproduces the published SOFA nut00b test values to ~1e-19
  rad — tests/test_precision_budget.py::test_nutation_sofa_nut00b_anchor)
- Polar motion hook (EOP table optional; zero fallback)

Accuracy budget (documented, honest): nutation = exact IAU2000B, so
the remaining nutation tier is the 2000B-vs-2000A model difference
~1 mas (~3 cm at Earth radius, ~0.1 ns Roemer); precession model
drift ~0.1 arcsec/century vs IAU2006 (~3 m, ~10 ns at 50 yr from
J2000); UT1=UTC fallback when no EOP table is provided (up to ±0.9 s
→ up to ~1.4 us Roemer; supply an IERS finals file to remove). All
host-side numpy f64; results feed the device TOABatch; the C++ mirror
receives this module's tables at load (native.py::_setup).
"""

from __future__ import annotations

import numpy as np

from ..constants import ARCSEC_TO_RAD, SECS_PER_DAY
from ..mjd import Epochs
from .. import timescales as ts
from .eop import EOPTable  # noqa: F401  (re-export: callers pass EOPTable in)

TWO_PI = 2.0 * np.pi
OMEGA_EARTH = 7.292115855306589e-5  # rad/s, Earth rotation rate (IERS)

# WGS84 / GRS80 ellipsoid for geodetic -> ITRF conversion
_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563


def geodetic_to_itrf(lat_deg, lon_deg, height_m):
    """Geodetic (lat, lon, h) -> ITRF XYZ [m] (reference: erfa gd2gc)."""
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg)
    e2 = _WGS84_F * (2 - _WGS84_F)
    n = _WGS84_A / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = (n + height_m) * np.cos(lat) * np.cos(lon)
    y = (n + height_m) * np.cos(lat) * np.sin(lon)
    z = (n * (1 - e2) + height_m) * np.sin(lat)
    return np.array([x, y, z])


def itrf_to_geodetic(xyz_m):
    """ITRF XYZ [m] -> geodetic (lat_deg, lon_deg, height_m)
    (reference: erfa gc2gd; Bowring's iterative method, WGS84)."""
    x, y, z = np.asarray(xyz_m, dtype=np.float64)
    e2 = _WGS84_F * (2 - _WGS84_F)
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(4):
        n = _WGS84_A / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1 - e2 * n / (n + h)))
    n = _WGS84_A / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - n
    return np.rad2deg(lat), np.rad2deg(lon), h


def _jc_tt(tt: Epochs) -> np.ndarray:
    """Julian centuries of TT since J2000.0."""
    return ((tt.day - 51544) - 0.5 + tt.sec / SECS_PER_DAY) / 36525.0


def era(ut1: Epochs) -> np.ndarray:
    """Earth Rotation Angle [rad] (reference: erfa era00)."""
    # Tu = JD(UT1) - 2451545.0 ; MJD 51544.5 == J2000.0
    du = (ut1.day - 51544).astype(np.float64) - 0.5 + ut1.sec / SECS_PER_DAY
    # Fractional-cycle carrier: Tu mod 1. Tu = (int days) - 0.5 + sec/day,
    # so the +0.5 is required (erfa era00 uses fmod(jd1,1)+fmod(jd2,1) = 0.5
    # + sec/day for MJD-split epochs); omitting it puts ERA off by exactly pi.
    frac = ut1.sec / SECS_PER_DAY + 0.5
    theta = TWO_PI * (0.7790572732640 + 0.00273781191135448 * du + frac)
    return np.mod(theta, TWO_PI)


# FULL IAU2000B luni-solar nutation series (McCarthy & Luzum 2003):
# 77 rows of (l, lp, F, D, Om multipliers, ps, pst, pc, ec, ect, es)
# with coefficients in 0.1 uas units —
#   dpsi = sum (ps + pst*T) sin(arg) + pc cos(arg)
#   deps = sum (ec + ect*T) cos(arg) + es sin(arg)
# plus fixed planetary-bias offsets (below) in lieu of the 2000A
# planetary terms. Validated against the published SOFA/ERFA nut00b
# test values (tests/test_precision_budget.py) — any wrong
# coefficient anywhere in the table shows at the 1e-13 rad level
# there. (reference: erfa nut00b)
_NUT_TERMS = np.array([
    # l lp  F  D Om      ps        pst      pc        ec       ect    es
    [0, 0, 0, 0, 1, -172064161.0, -174666.0, 33386.0, 92052331.0, 9086.0, 15377.0],
    [0, 0, 2, -2, 2, -13170906.0, -1675.0, -13696.0, 5730336.0, -3015.0, -4587.0],
    [0, 0, 2, 0, 2, -2276413.0, -234.0, 2796.0, 978459.0, -485.0, 1374.0],
    [0, 0, 0, 0, 2, 2074554.0, 207.0, -698.0, -897492.0, 470.0, -291.0],
    [0, 1, 0, 0, 0, 1475877.0, -3633.0, 11817.0, 73871.0, -184.0, -1924.0],
    [0, 1, 2, -2, 2, -516821.0, 1226.0, -524.0, 224386.0, -677.0, -174.0],
    [1, 0, 0, 0, 0, 711159.0, 73.0, -872.0, -6750.0, 0.0, 358.0],
    [0, 0, 2, 0, 1, -387298.0, -367.0, 380.0, 200728.0, 18.0, 318.0],
    [1, 0, 2, 0, 2, -301461.0, -36.0, 816.0, 129025.0, -63.0, 367.0],
    [0, -1, 2, -2, 2, 215829.0, -494.0, 111.0, -95929.0, 299.0, 132.0],
    [0, 0, 2, -2, 1, 128227.0, 137.0, 181.0, -68982.0, -9.0, 39.0],
    [-1, 0, 2, 0, 2, 123457.0, 11.0, 19.0, -53311.0, 32.0, -4.0],
    [-1, 0, 0, 2, 0, 156994.0, 10.0, -168.0, -1235.0, 0.0, 82.0],
    [1, 0, 0, 0, 1, 63110.0, 63.0, 27.0, -33228.0, 0.0, -9.0],
    [-1, 0, 0, 0, 1, -57976.0, -63.0, -189.0, 31429.0, 0.0, -75.0],
    [-1, 0, 2, 2, 2, -59641.0, -11.0, 149.0, 25543.0, -11.0, 66.0],
    [1, 0, 2, 0, 1, -51613.0, -42.0, 129.0, 26366.0, 0.0, 78.0],
    [-2, 0, 2, 0, 1, 45893.0, 50.0, 31.0, -24236.0, -10.0, 20.0],
    [0, 0, 0, 2, 0, 63384.0, 11.0, -150.0, -1220.0, 0.0, 29.0],
    [0, 0, 2, 2, 2, -38571.0, -1.0, 158.0, 16452.0, -11.0, 68.0],
    [0, -2, 2, -2, 2, 32481.0, 0.0, 0.0, -13870.0, 0.0, 0.0],
    [-2, 0, 0, 2, 0, -47722.0, 0.0, -18.0, 477.0, 0.0, -25.0],
    [2, 0, 2, 0, 2, -31046.0, -1.0, 131.0, 13238.0, -11.0, 59.0],
    [1, 0, 2, -2, 2, 28593.0, 0.0, -1.0, -12338.0, 10.0, -3.0],
    [-1, 0, 2, 0, 1, 20441.0, 21.0, 10.0, -10758.0, 0.0, -3.0],
    [2, 0, 0, 0, 0, 29243.0, 0.0, -74.0, -609.0, 0.0, 13.0],
    [0, 0, 2, 0, 0, 25887.0, 0.0, -66.0, -550.0, 0.0, 11.0],
    [0, 1, 0, 0, 1, -14053.0, -25.0, 79.0, 8551.0, -2.0, -45.0],
    [-1, 0, 0, 2, 1, 15164.0, 10.0, 11.0, -8001.0, 0.0, -1.0],
    [0, 2, 2, -2, 2, -15794.0, 72.0, -16.0, 6850.0, -42.0, -5.0],
    [0, 0, -2, 2, 0, 21783.0, 0.0, 13.0, -167.0, 0.0, 13.0],
    [1, 0, 0, -2, 1, -12873.0, -10.0, -37.0, 6953.0, 0.0, -14.0],
    [0, -1, 0, 0, 1, -12654.0, 11.0, 63.0, 6415.0, 0.0, 26.0],
    [-1, 0, 2, 2, 1, -10204.0, 0.0, 25.0, 5222.0, 0.0, 15.0],
    [0, 2, 0, 0, 0, 16707.0, -85.0, -10.0, 168.0, -1.0, 10.0],
    [1, 0, 2, 2, 2, -7691.0, 0.0, 44.0, 3268.0, 0.0, 19.0],
    [-2, 0, 2, 0, 0, -11024.0, 0.0, -14.0, 104.0, 0.0, 2.0],
    [0, 1, 2, 0, 2, 7566.0, -21.0, -11.0, -3250.0, 0.0, -5.0],
    [0, 0, 2, 2, 1, -6637.0, -11.0, 25.0, 3353.0, 0.0, 14.0],
    [0, -1, 2, 0, 2, -7141.0, 21.0, 8.0, 3070.0, 0.0, 4.0],
    [0, 0, 0, 2, 1, -6302.0, -11.0, 2.0, 3272.0, 0.0, 4.0],
    [1, 0, 2, -2, 1, 5800.0, 10.0, 2.0, -3045.0, 0.0, -1.0],
    [2, 0, 2, -2, 2, 6443.0, 0.0, -7.0, -2768.0, 0.0, -4.0],
    [-2, 0, 0, 2, 1, -5774.0, -11.0, -15.0, 3041.0, 0.0, -5.0],
    [2, 0, 2, 0, 1, -5350.0, 0.0, 21.0, 2695.0, 0.0, 12.0],
    [0, -1, 2, -2, 1, -4752.0, -11.0, -3.0, 2719.0, 0.0, -3.0],
    [0, 0, 0, -2, 1, -4940.0, -11.0, -21.0, 2720.0, 0.0, -9.0],
    [-1, -1, 0, 2, 0, 7350.0, 0.0, -8.0, -51.0, 0.0, 4.0],
    [2, 0, 0, -2, 1, 4065.0, 0.0, 6.0, -2206.0, 0.0, 1.0],
    [1, 0, 0, 2, 0, 6579.0, 0.0, -24.0, -199.0, 0.0, 2.0],
    [0, 1, 2, -2, 1, 3579.0, 0.0, 5.0, -1900.0, 0.0, 1.0],
    [1, -1, 0, 0, 0, 4725.0, 0.0, -6.0, -41.0, 0.0, 3.0],
    [-2, 0, 2, 0, 2, -3075.0, 0.0, -2.0, 1313.0, 0.0, -1.0],
    [3, 0, 2, 0, 2, -2904.0, 0.0, 15.0, 1233.0, 0.0, 7.0],
    [0, -1, 0, 2, 0, 4348.0, 0.0, -10.0, -81.0, 0.0, 2.0],
    [1, -1, 2, 0, 2, -2878.0, 0.0, 8.0, 1232.0, 0.0, 4.0],
    [0, 0, 0, 1, 0, -4230.0, 0.0, 5.0, -20.0, 0.0, -2.0],
    [-1, -1, 2, 2, 2, -2819.0, 0.0, 7.0, 1207.0, 0.0, 3.0],
    [-1, 0, 2, 0, 0, -4056.0, 0.0, 5.0, 40.0, 0.0, -2.0],
    [0, -1, 2, 2, 2, -2647.0, 0.0, 11.0, 1129.0, 0.0, 5.0],
    [-2, 0, 0, 0, 1, -2294.0, 0.0, -10.0, 1266.0, 0.0, -4.0],
    [1, 1, 2, 0, 2, 2481.0, 0.0, -7.0, -1062.0, 0.0, -3.0],
    [2, 0, 0, 0, 1, 2179.0, 0.0, -2.0, -1129.0, 0.0, -2.0],
    [-1, 1, 0, 1, 0, 3276.0, 0.0, 1.0, -9.0, 0.0, 0.0],
    [1, 1, 0, 0, 0, -3389.0, 0.0, 5.0, 35.0, 0.0, -2.0],
    [1, 0, 2, 0, 0, 3339.0, 0.0, -13.0, -107.0, 0.0, 1.0],
    [-1, 0, 2, -2, 1, -1987.0, 0.0, -6.0, 1073.0, 0.0, -2.0],
    [1, 0, 0, 0, 2, -1981.0, 0.0, 0.0, 854.0, 0.0, 0.0],
    [-1, 0, 0, 1, 0, 4026.0, 0.0, -353.0, -553.0, 0.0, -139.0],
    [0, 0, 2, 1, 2, 1660.0, 0.0, -5.0, -710.0, 0.0, -2.0],
    [-1, 0, 2, 4, 2, -1521.0, 0.0, 9.0, 647.0, 0.0, 4.0],
    [-1, 1, 0, 1, 1, 1314.0, 0.0, 0.0, -700.0, 0.0, 0.0],
    [0, -2, 2, -2, 1, -1283.0, 0.0, 0.0, 672.0, 0.0, 0.0],
    [1, 0, 2, 2, 1, -1331.0, 0.0, 8.0, 663.0, 0.0, 4.0],
    [-2, 0, 2, 2, 2, 1383.0, 0.0, -2.0, -594.0, 0.0, -2.0],
    [-1, 0, 0, 0, 2, 1405.0, 0.0, 4.0, -610.0, 0.0, 2.0],
    [1, 1, 2, -2, 2, 1290.0, 0.0, 0.0, -556.0, 0.0, 0.0],
])

# Fixed offsets in lieu of the IAU2000A planetary nutation terms
# [arcsec] (nut00b's dpplan/deplan).
_NUT_PLANETARY_BIAS_PSI = -0.135e-3
_NUT_PLANETARY_BIAS_EPS = 0.388e-3


def _fund_args_nut00b(T):
    """Fundamental arguments [rad] as prescribed for the IAU2000B
    series: LINEAR-only Delaunay expressions (nut00b truncates the
    IERS 2003 polynomials; using the quadratic forms here would move
    the series off the published model by ~10 uas at |T|~0.1)."""
    l = (485868.249036 + 1717915923.2178 * T) * ARCSEC_TO_RAD
    lp = (1287104.79305 + 129596581.0481 * T) * ARCSEC_TO_RAD
    F = (335779.526232 + 1739527262.8478 * T) * ARCSEC_TO_RAD
    D = (1072260.70369 + 1602961601.2090 * T) * ARCSEC_TO_RAD
    Om = (450160.398036 - 6962890.5431 * T) * ARCSEC_TO_RAD
    return l, lp, F, D, Om


def nutation(T):
    """(dpsi, deps) [rad], full IAU2000B (reference: erfa nut00b).

    Luni-solar series evaluated as one (N_epochs x 77) matrix product
    against the multiplier table plus the fixed planetary bias —
    ~1 mas of the full 2000A model, vs ~20 mas for the 13-term
    truncation this replaces (ERRORBUDGET.md)."""
    T = np.asarray(T, np.float64)
    scalar = T.ndim == 0
    Tv = np.atleast_1d(T)
    fund = np.stack(_fund_args_nut00b(Tv), axis=0)       # (5, N)
    arg = _NUT_TERMS[:, :5] @ fund                       # (77, N)
    s, c = np.sin(arg), np.cos(arg)
    ps, pst, pc = _NUT_TERMS[:, 5:6], _NUT_TERMS[:, 6:7], _NUT_TERMS[:, 7:8]
    ec, ect, es = _NUT_TERMS[:, 8:9], _NUT_TERMS[:, 9:10], _NUT_TERMS[:, 10:11]
    dpsi = np.sum((ps + pst * Tv) * s + pc * c, axis=0)
    deps = np.sum((ec + ect * Tv) * c + es * s, axis=0)
    scale = 1e-7 * ARCSEC_TO_RAD  # tables are in 0.1 uas
    dpsi = dpsi * scale + _NUT_PLANETARY_BIAS_PSI * ARCSEC_TO_RAD
    deps = deps * scale + _NUT_PLANETARY_BIAS_EPS * ARCSEC_TO_RAD
    if scalar:
        return float(dpsi[0]), float(deps[0])
    return dpsi, deps


def mean_obliquity(T):
    """Mean obliquity of the ecliptic [rad] (IAU 2006)."""
    eps = (84381.406 - 46.836769 * T - 0.0001831 * T**2 + 0.00200340 * T**3)
    return eps * ARCSEC_TO_RAD


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([o, z, z], -1),
        np.stack([z, c, s], -1),
        np.stack([z, -s, c], -1),
    ], -2)


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, z, -s], -1),
        np.stack([z, o, z], -1),
        np.stack([s, z, c], -1),
    ], -2)


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([
        np.stack([c, s, z], -1),
        np.stack([-s, c, z], -1),
        np.stack([z, z, o], -1),
    ], -2)


def precession_matrix(T):
    """Precession GCRS(J2000-ish)->mean-of-date, IAU1976 angles + frame bias.

    (reference: erfa pmat06 / bp06). zeta/z/theta polynomial form.
    """
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * ARCSEC_TO_RAD
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * ARCSEC_TO_RAD
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * ARCSEC_TO_RAD
    return _rz(-z) @ _ry(theta) @ _rz(-zeta)


# GCRS frame bias (ICRS vs mean J2000 equator/equinox), constant mas offsets
_BIAS = None


def _bias_matrix():
    global _BIAS
    if _BIAS is None:
        dpsi_b = -0.041775 * ARCSEC_TO_RAD
        deps_b = -0.0068192 * ARCSEC_TO_RAD
        dra0 = -0.0146 * ARCSEC_TO_RAD
        eps0 = 84381.406 * ARCSEC_TO_RAD
        _BIAS = (_rx(np.array(deps_b)) @ _ry(np.array(dpsi_b * np.sin(eps0)))
                 @ _rz(np.array(-dra0)))
    return _BIAS


def nutation_matrix(T):
    dpsi, deps = nutation(T)
    eps = mean_obliquity(T)
    return _rx(-(eps + deps)) @ _rz(-dpsi) @ _rx(eps)


def gast(ut1: Epochs, T_tt) -> np.ndarray:
    """Greenwich apparent sidereal time [rad] (reference: erfa gst06a)."""
    # GMST(IAU2006) = ERA + polynomial
    poly = (0.014506 + 4612.156534 * T_tt + 1.3915817 * T_tt**2
            - 0.00000044 * T_tt**3) * ARCSEC_TO_RAD
    dpsi, _ = nutation(T_tt)
    eps = mean_obliquity(T_tt)
    ee = dpsi * np.cos(eps)  # equation of the equinoxes (main term)
    return np.mod(era(ut1) + poly + ee, TWO_PI)


# default sentinel: "use the process-wide auto-discovered table".
# Distinct from None, which explicitly selects the zero-EOP tier for
# one call without touching global state.
AUTO_EOP = object()


def _earth_rotation_inputs(utc: Epochs, eop):
    """(tt, ut1, xp, yp) — the single home of the UTC->TT/UT1/EOP
    precompute shared by the numpy and native paths.

    eop=AUTO_EOP (the default everywhere) consults the process-wide
    auto-discovered table (earth/eop.py::get_eop_table) so dropping a
    finals2000A.all into the data dir upgrades every site->GCRS
    conversion transparently; eop=None forces UT1=UTC / zero polar
    motion for this call only."""
    from .eop import get_eop_table

    tt = ts.utc_to_tt(utc)
    if eop is AUTO_EOP:
        eop = get_eop_table()
    if eop is not None:
        dut1 = eop.ut1_minus_utc(utc)
        xp, yp = eop.polar_motion(utc)
    else:
        dut1 = np.zeros(len(utc))
        xp = yp = np.zeros(len(utc))
    ut1 = Epochs(utc.day, utc.sec + dut1, "ut1").normalized()
    return tt, ut1, xp, yp


def itrf_to_gcrs_matrix(utc: Epochs, eop=AUTO_EOP,
                        _inputs=None) -> np.ndarray:
    """Rotation matrices (n, 3, 3): r_GCRS = M @ r_ITRF.

    Chain: GCRS = B^T P^T N^T R3(-GAST) W^T r_ITRF
    (equinox-based; reference: erfa c2t06a equivalent).
    """
    tt, ut1, xp, yp = _inputs or _earth_rotation_inputs(utc, eop)
    T = _jc_tt(tt)
    theta = gast(ut1, T)
    # polar motion W = R1(yp) R2(xp) (s' neglected, <0.1 mas)
    W = _ry(xp) @ _rx(yp)
    c2t = W @ _rz(theta) @ nutation_matrix(T) @ precession_matrix(T) @ _bias_matrix()
    return np.swapaxes(c2t, -1, -2)  # transpose: ITRF->GCRS


def gcrs_posvel_from_itrf(itrf_xyz_m, utc: Epochs, eop=AUTO_EOP):
    """Observatory GCRS position [m] and velocity [m/s] at each epoch.

    (reference: src/pint/erfautils.py::gcrs_posvel_from_itrf)

    Dispatches to the C++ host kernel (``native.py``) when built —
    same chain, same truncated series; the numpy path below is the
    always-available mirror.
    """
    from ..native import itrf_to_gcrs as _native

    r = np.asarray(itrf_xyz_m, dtype=np.float64)
    inputs = _earth_rotation_inputs(utc, eop)
    tt, ut1, xp, yp = inputs
    nat = _native(tt.day, tt.sec, ut1.day, ut1.sec, xp, yp, r)
    if nat is not None:
        return nat
    M = itrf_to_gcrs_matrix(utc, eop, _inputs=inputs)
    pos = (M @ r).reshape(len(utc), 3)
    # velocity: d/dt R3(-theta) only (PN terms ~1e5 x slower)
    omega = np.array([0.0, 0.0, OMEGA_EARTH])
    vel = np.cross(np.broadcast_to(omega, pos.shape), pos)
    return pos, vel
