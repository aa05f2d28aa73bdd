"""Observatories of the port (torch package; host numpy).

Counterpart of the JAX package's ``observatory/__init__.py``, for the
two special locations whose TOAs need no clock chain and no Earth
rotation:

- :class:`BarycenterObs` (``barycenter``, ``@``, ``bat``, ``ssb``):
  TOAs already at the solar-system barycentre, in TDB (barycentred
  photon events). The observatory is the SSB itself.
- :class:`GeocenterObs` (``geocenter``, ``coe``): the Earth's centre,
  whose TOAs ``simulation.py`` makes and fills.

Every other observatory (a radio telescope, a mission's satellite
observatory with its orbit file) is host ingest — clock chains, the
TT->TDB chain, the SPK ephemeris, the orbit interpolation — and
:func:`get_observatory` raises ``NotImplementedError`` for it.
"""

from __future__ import annotations

import numpy as np

from ..ephemeris.analytic import _all_positions_icrs, earth_sun_icrs
from ..mjd import Epochs
from ..utils import PosVel

HOST_INGEST = ("host ingest (clock chains, TT->TDB, the SPK ephemeris and "
               "observatory or orbit-file posvels; ROADMAP item 7) is not "
               "ported")


def _julian_centuries(tdb: Epochs):
    """Julian centuries of TDB since J2000, the analytic ephemeris'
    time argument."""
    return (tdb.mjd_float() - 51544.5) / 36525.0


class Observatory:
    name = ""
    aliases: tuple = ()

    def fill_posvels(self, toas):
        raise NotImplementedError


class BarycenterObs(Observatory):
    """@ / bat / ssb: TOAs already at the SSB (reference:
    special_locations.py; JAX ``observatory/__init__.py::
    BarycenterObs``)."""

    name = "barycenter"
    aliases = ("@", "bat", "ssb", "barycentre")
    timescale = "tdb"

    def fill_posvels(self, toas):
        """``tdb`` the epochs as given (TDB, the JAX package's
        ``compute_TDBs`` for a TDB observatory), ``ssb_obs`` exactly
        zero, ``obs_sun`` the Sun with respect to the SSB from the
        analytic ephemeris (``ephemeris/analytic.py::earth_sun_icrs``,
        the substitution the port makes for the SPK ephemeris), and
        ``planet_pos`` the planets with respect to the SSB when
        ``toas.planets``. Velocities are zero, as in the JAX package."""
        norm = Epochs(toas.day, toas.sec, "utc").normalized()
        toas.tdb = Epochs(norm.day, norm.sec, "tdb")
        t = _julian_centuries(toas.tdb)
        _, sun = earth_sun_icrs(t)
        zero = np.zeros((len(toas), 3))
        toas.ssb_obs = PosVel(zero, zero.copy(), origin="ssb",
                              obj="barycenter")
        toas.obs_sun = PosVel(sun, np.zeros_like(sun), origin="obs",
                              obj="sun")
        toas.planet_pos = {}
        if toas.planets:
            pos = _all_positions_icrs(t)
            toas.planet_pos = {p: pos[p] for p in toas.PLANETS}
        return toas


class GeocenterObs(Observatory):
    """geocenter / coe: the Earth's centre, epochs taken as TDB
    (``simulation.geocenter_posvels``)."""

    name = "geocenter"
    aliases = ("coe", "geocentre")
    timescale = "tdb"

    def fill_posvels(self, toas):
        from ..simulation import geocenter_posvels

        return geocenter_posvels(toas)


_REGISTRY = {}
for _cls in (BarycenterObs, GeocenterObs):
    for _name in (_cls.name, *_cls.aliases):
        _REGISTRY[_name] = _cls()


def get_observatory(name: str) -> Observatory:
    """The observatory called ``name`` (case-insensitive), for the
    special locations the port knows; any other raises
    ``NotImplementedError``."""
    key = str(name).strip().lower()
    if key not in _REGISTRY:
        raise NotImplementedError(f"observatory {name!r}: {HOST_INGEST}")
    return _REGISTRY[key]


__all__ = ["BarycenterObs", "GeocenterObs", "Observatory",
           "get_observatory", "HOST_INGEST"]
