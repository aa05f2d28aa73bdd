"""Tropospheric propagation delay (torch counterpart of the JAX
package's ``models/troposphere.py``).

(reference: src/pint/models/troposphere_delay.py::TroposphereDelay —
CORRECT_TROPOSPHERE flag; zenith hydrostatic delay (Davis et al. 1985)
from a standard-atmosphere pressure at the site, a nominal zenith wet
delay, and Niell (1996) mapping functions vs elevation.)

Host pack: per-TOA zenith unit vector in GCRS (observatory geodetic
up-vector rotated by the erfa_lite ITRF->GCRS chain), site latitude /
height, and day-of-year for the seasonal Niell term. Device: elevation
from the differentiable pulsar direction, continued-fraction mapping
functions, delay in seconds. TOAs from non-topocentric observatories
(barycenter/geocenter/satellites) get zero delay via a packed mask.
The site latitude and height come from the port's observatory registry
(``TopoObs.earth_location_itrf``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import C_M_S, SECS_PER_DAY
from .parameter import boolParameter
from .timing_model import DelayComponent

# Niell (1996) hydrostatic mapping coefficients at latitudes 15..75 deg:
# time-average (a, b, c) and seasonal amplitude (a, b, c); public
# geodesy constants (JGR 101, B2, 3227).
_NMF_LAT = np.array([15.0, 30.0, 45.0, 60.0, 75.0])
_NMF_H_AVG = np.array([
    [1.2769934e-3, 2.9153695e-3, 62.610505e-3],
    [1.2683230e-3, 2.9152299e-3, 62.837393e-3],
    [1.2465397e-3, 2.9288445e-3, 63.721774e-3],
    [1.2196049e-3, 2.9022565e-3, 63.824265e-3],
    [1.2045996e-3, 2.9024912e-3, 64.258455e-3],
])
_NMF_H_AMP = np.array([
    [0.0, 0.0, 0.0],
    [1.2709626e-5, 2.1414979e-5, 9.0128400e-5],
    [2.6523662e-5, 3.0160779e-5, 4.3497037e-5],
    [3.4000452e-5, 7.2562722e-5, 84.795348e-5],
    [4.1202191e-5, 11.723375e-5, 170.37206e-5],
])
# height correction coefficients (Niell 1996, per km)
_NMF_HT = (2.53e-5, 5.49e-3, 1.14e-3)
# wet mapping coefficients (no seasonal term)
_NMF_W = np.array([
    [5.8021897e-4, 1.4275268e-3, 4.3472961e-2],
    [5.6794847e-4, 1.5138625e-3, 4.6729510e-2],
    [5.8118019e-4, 1.4572752e-3, 4.3908931e-2],
    [5.9727542e-4, 1.5007428e-3, 4.4626982e-2],
    [6.1641693e-4, 1.7599082e-3, 5.4736038e-2],
])


def _interp_coeffs(table, abs_lat_deg):
    """Piecewise-linear latitude interpolation of Niell coefficient rows."""
    out = [np.interp(abs_lat_deg, _NMF_LAT, table[:, k]) for k in range(3)]
    return np.array(out)


def zenith_hydrostatic_delay_m(lat_rad, height_m):
    """Davis et al. (1985) ZHD [m] with standard-atmosphere pressure."""
    p_hpa = 1013.25 * (1.0 - 2.25577e-5 * height_m) ** 5.25588
    return 0.0022768 * p_hpa / (
        1.0 - 0.00266 * np.cos(2.0 * lat_rad) - 0.00028 * height_m / 1000.0)


class TroposphereDelay(DelayComponent):
    category = "troposphere"
    order = 21

    # nominal zenith wet delay [m]; the reference likewise has no met
    # data and uses a fixed nominal wet term
    ZWD_M = 0.1

    def __init__(self):
        super().__init__()
        p = boolParameter("CORRECT_TROPOSPHERE",
                          description="Enable tropospheric delay correction")
        p.value = True
        self.add_param(p)

    def device_slot(self, pname):
        raise KeyError(pname)  # nothing fittable

    def pack(self, model, toas, prep, params0, device=None):
        from ..earth.erfa_lite import (itrf_to_gcrs_matrix, itrf_to_geodetic)
        from ..mjd import Epochs
        from ..observatory import get_observatory

        n = len(toas)
        zenith = np.zeros((n, 3))
        lat = np.zeros(n)
        height = np.zeros(n)
        topo = np.zeros(n, dtype=bool)
        utc = Epochs(toas.day, toas.sec + toas.clock_corr_s, "utc").normalized()
        for obs_name in np.unique(toas.obs.astype(str)):
            ob = get_observatory(obs_name)
            xyz = getattr(ob, "earth_location_itrf", lambda: None)()
            mask = toas.obs.astype(str) == obs_name
            if xyz is None:
                continue
            lat_d, lon_d, h = itrf_to_geodetic(xyz)
            lat_r, lon_r = np.deg2rad(lat_d), np.deg2rad(lon_d)
            up_itrf = np.array([np.cos(lat_r) * np.cos(lon_r),
                                np.cos(lat_r) * np.sin(lon_r),
                                np.sin(lat_r)])
            sub = Epochs(utc.day[mask], utc.sec[mask], "utc")
            M = itrf_to_gcrs_matrix(sub)
            zenith[mask] = (M @ up_itrf).reshape(-1, 3)
            lat[mask] = lat_r
            height[mask] = h
            topo[mask] = True
        # day of year for the seasonal Niell term (southern hemisphere
        # shifted by half a year, per Niell 1996)
        doy = (toas.get_mjds() - 44239.0) % 365.25  # MJD 44239 = 1980-01-01
        doy = np.where(lat < 0, doy + 365.25 / 2.0, doy)
        season = np.cos(2.0 * np.pi * (doy - 28.0) / 365.25)
        abs_lat_deg = np.abs(np.rad2deg(lat))
        h_avg = np.stack([np.interp(abs_lat_deg, _NMF_LAT, _NMF_H_AVG[:, k])
                          for k in range(3)], axis=-1)
        h_amp = np.stack([np.interp(abs_lat_deg, _NMF_LAT, _NMF_H_AMP[:, k])
                          for k in range(3)], axis=-1)
        w_abc = np.stack([np.interp(abs_lat_deg, _NMF_LAT, _NMF_W[:, k])
                          for k in range(3)], axis=-1)
        habc = h_avg - h_amp * season[:, None]
        prep["tropo_zenith"] = zenith
        prep["tropo_mask"] = topo.astype(np.float64)
        prep["tropo_zhd_m"] = np.where(
            topo, zenith_hydrostatic_delay_m(lat, height), 0.0)
        prep["tropo_habc"] = habc
        prep["tropo_wabc"] = w_abc
        prep["tropo_height_km"] = height / 1000.0
        prep["tropo_on"] = bool(self.CORRECT_TROPOSPHERE.value)

    @staticmethod
    def _cfrac(sin_e, a, b, c):
        """Niell continued-fraction mapping, normalized to 1 at zenith."""
        top = 1.0 + a / (1.0 + b / (1.0 + c))
        bot = sin_e + a / (sin_e + b / (sin_e + c))
        return top / bot

    def delay(self, params, batch, prep, delay_accum):
        if not prep.get("tropo_on", False):
            return torch.zeros_like(batch.tdb_sec)
        astrom = next((c for c in self._parent.delay_components()
                       if c.category == "astrometry"), None)
        if astrom is None:
            return torch.zeros_like(batch.tdb_sec)
        n = astrom.ssb_to_psb_xyz(params, prep)
        sin_e = torch.sum(prep["tropo_zenith"] * n, dim=-1)
        # floor at 5 deg elevation: mapping functions diverge at horizon
        sin_e = torch.clip(sin_e, float(np.sin(np.deg2rad(5.0))), 1.0)
        ha, hb, hc = (prep["tropo_habc"][:, 0], prep["tropo_habc"][:, 1],
                      prep["tropo_habc"][:, 2])
        m_h = self._cfrac(sin_e, ha, hb, hc)
        # Niell height correction
        aht, bht, cht = _NMF_HT
        dm = (1.0 / sin_e - self._cfrac(sin_e, aht, bht, cht)) * prep["tropo_height_km"]
        m_h = m_h + dm
        wa, wb, wc = (prep["tropo_wabc"][:, 0], prep["tropo_wabc"][:, 1],
                      prep["tropo_wabc"][:, 2])
        m_w = self._cfrac(sin_e, wa, wb, wc)
        path_m = prep["tropo_zhd_m"] * m_h + self.ZWD_M * m_w
        return prep["tropo_mask"] * path_m / C_M_S
