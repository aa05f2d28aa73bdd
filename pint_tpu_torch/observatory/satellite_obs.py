"""Satellite observatories: the spacecraft's position from an orbit file
(host numpy; counterpart of the JAX package's
``observatory/satellite_obs.py``).

(reference: src/pint/observatory/satellite_obs.py —
get_satellite_observatory(), orbit FT2/FPorbit interpolation.)

The orbit table gives the spacecraft's ECI (GCRS) position, and usually
its velocity, on a grid of MET seconds; ``posvel_ssb`` adds the Earth's
SSB position to the spacecraft vectors interpolated by a cubic Hermite.
Photon times from these missions are TT (MET seconds past the mission's
MJDREF), so ``timescale`` is "tt" and there is no site clock chain.
Creating the observatory registers it under the mission's name, so
``event_toas.load_event_TOAs`` tables of spacecraft-frame events pack
through it.
"""

from __future__ import annotations

import numpy as np

from ..ephemeris import objPosVel_wrt_SSB
from ..mjd import Epochs
from ..timescales import tdb_to_tt
from ..utils import PosVel
from . import Observatory


def _mjdref_days(header) -> float:
    if "MJDREFI" in header:
        return float(header["MJDREFI"]) + float(header.get("MJDREFF", 0.0))
    if "MJDREF" in header:
        return float(header["MJDREF"])
    raise KeyError(
        "orbit file header has no MJDREFI/MJDREF — cannot anchor the MET "
        "time grid (a silent 0.0 would put every photon out of span)")


def _orbit_columns(cols):
    """(pos_m (n, 3), vel_m_s (n, 3) or None) from the orbit table, in
    the FT2 (SC_POSITION), FPorbit (X/Y/Z[, VX..]) or generic
    POSITION/VELOCITY layouts."""
    def grab(*names):
        for nm in names:
            for k in cols:
                if k.upper() == nm:
                    return np.asarray(cols[k], float)
        return None

    pos = grab("SC_POSITION", "POSITION")
    vel = grab("SC_VELOCITY", "VELOCITY")
    if pos is None:
        x, y, z = grab("X"), grab("Y"), grab("Z")
        if x is None:
            raise KeyError("orbit table has no position columns")
        pos = np.stack([x, y, z], axis=-1)
        vx, vy, vz = grab("VX"), grab("VY"), grab("VZ")
        if vx is not None:
            vel = np.stack([vx, vy, vz], axis=-1)
    return pos, vel


class SatelliteObs(Observatory):
    """A spacecraft observatory (reference: satellite_obs.py). The orbit
    rows are sorted by time; a table without velocities gets the grid
    derivative."""

    def __init__(self, name, met_s, pos_m, vel_m_s=None, mjdref=0.0,
                 aliases=()):
        super().__init__(name, aliases)
        order = np.argsort(met_s)
        self.met_s = np.asarray(met_s, float)[order]
        self.pos_m = np.asarray(pos_m, float)[order]
        if vel_m_s is None:
            self.vel_m_s = np.gradient(self.pos_m, self.met_s, axis=0)
        else:
            self.vel_m_s = np.asarray(vel_m_s, float)[order]
        self.mjdref = float(mjdref)

    @property
    def timescale(self):
        return "tt"

    @classmethod
    def from_orbit_file(cls, name, path, extname=None, aliases=()):
        from ..io.fits import read_fits

        hdus = [h for h in read_fits(path) if h["data"] is not None]
        if extname is not None:
            hdus = [h for h in hdus if h["name"].upper() == extname.upper()]
        for h in hdus:
            if any(k.upper() in ("TIME", "START") for k in h["data"]):
                header, cols = h["header"], h["data"]
                break
        else:
            raise KeyError(f"no orbit table found in {path}")
        tcol = next(k for k in cols if k.upper() in ("TIME", "START"))
        met = np.asarray(cols[tcol], float)
        pos, vel = _orbit_columns(cols)
        # FT2 and FPorbit products store metres; a table whose first
        # radius is below 1e5 is in km
        if np.linalg.norm(pos[0]) < 1e5:
            pos = pos * 1e3
            if vel is not None:
                vel = vel * 1e3
        return cls(name, met, pos, vel, mjdref=_mjdref_days(header),
                   aliases=aliases)

    def _interp(self, met):
        """Cubic-Hermite position [m] and velocity [m/s] at MET seconds.
        An epoch more than one grid step outside the table raises: the
        frozen edge position would be wrong by up to the orbit's size."""
        step = np.median(np.diff(self.met_s))
        bad = (met < self.met_s[0] - step) | (met > self.met_s[-1] + step)
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())}/{met.size} event times outside the orbit "
                f"file span [MET {self.met_s[0]:.1f}, {self.met_s[-1]:.1f}] "
                "— supply an orbit file covering the observation")
        t = np.clip(met, self.met_s[0], self.met_s[-1])
        i = np.clip(np.searchsorted(self.met_s, t) - 1, 0,
                    len(self.met_s) - 2)
        h = self.met_s[i + 1] - self.met_s[i]
        u = (t - self.met_s[i]) / h
        p0, p1 = self.pos_m[i], self.pos_m[i + 1]
        m0, m1 = self.vel_m_s[i] * h[:, None], self.vel_m_s[i + 1] * h[:, None]
        u = u[:, None]
        pos = ((2 * u**3 - 3 * u**2 + 1) * p0 + (u**3 - 2 * u**2 + u) * m0
               + (-2 * u**3 + 3 * u**2) * p1 + (u**3 - u**2) * m1)
        vel = ((6 * u**2 - 6 * u) * p0 + (3 * u**2 - 4 * u + 1) * m0
               + (-6 * u**2 + 6 * u) * p1 + (3 * u**2 - 2 * u) * m1) / h[:, None]
        return pos, vel

    def posvel_ssb(self, tdb: Epochs, utc: Epochs, ephem: str,
                   provider: str | None = None, gcrs=None) -> PosVel:
        """The Earth's SSB posvel plus the spacecraft's, looked up at the
        TT MET of each TDB epoch."""
        earth = objPosVel_wrt_SSB("earth", tdb, ephem, provider=provider)
        tt = tdb_to_tt(tdb)
        met = (tt.day - self.mjdref) * 86400.0 + tt.sec
        pos, vel = self._interp(np.asarray(met, float))
        return PosVel(earth.pos + pos, earth.vel + vel, origin="ssb",
                      obj=self.name)


def get_satellite_observatory(name, orbit_path, extname=None, overwrite=True):
    """Create and register a satellite observatory from an orbit FITS
    file (reference: satellite_obs.py::get_satellite_observatory)."""
    return SatelliteObs.from_orbit_file(str(name).lower(), orbit_path,
                                        extname=extname)
