"""Observatories of the port (torch package; host numpy).

Counterpart of the JAX package's ``observatory/__init__.py``, for the
two special locations whose TOAs need no clock chain and no Earth
rotation:

- :class:`BarycenterObs` (``barycenter``, ``@``, ``bat``, ``ssb``):
  TOAs already at the solar-system barycentre, in TDB (barycentred
  photon events). The observatory is the SSB itself.
- :class:`GeocenterObs` (``geocenter``, ``coe``): the Earth's centre,
  whose TOAs ``simulation.py`` makes and fills.

Both take the Sun, the Earth and the planets from the ephemeris tiers
of ``ephemeris/`` (``objPosVel_wrt_SSB`` under the tier that
``ephemeris_provider`` resolves once for the table, as the JAX
package's ``TOAs.compute_posvels`` does). Every other observatory (a
radio telescope, a mission's satellite observatory with its orbit file)
is host ingest — clock chains, the UTC->TDB chain, Earth rotation, the
orbit interpolation — and :func:`get_observatory` raises
``NotImplementedError`` for it.
"""

from __future__ import annotations

import numpy as np

from ..ephemeris import ephemeris_provider, objPosVel_wrt_SSB
from ..mjd import Epochs
from ..utils import PosVel

HOST_INGEST = ("host ingest (clock chains, UTC->TDB, Earth rotation and "
               "observatory or orbit-file posvels; ROADMAP §1 item 1) is not "
               "ported")


def solar_system_posvels(toas, earth=None):
    """``toas.ephem_provider``, ``obs_sun`` and ``planet_pos`` for an
    observatory at ``earth`` (a PosVel wrt the SSB, or None for the SSB
    itself) at the table's TDB epochs: the tier resolved once on every
    epoch, then the Sun (and, when ``toas.planets``, the planets) from
    it, relative to the observatory (JAX ``toa.py::compute_posvels``).
    The Sun's velocity is zero, as in the JAX package."""
    tdb = toas.tdb
    toas.ephem_provider = ephemeris_provider(toas.ephem, tdb)
    obs = 0.0 if earth is None else earth.pos
    sun = objPosVel_wrt_SSB("sun", tdb, toas.ephem,
                            provider=toas.ephem_provider).pos - obs
    toas.obs_sun = PosVel(sun, np.zeros_like(sun), origin="obs", obj="sun")
    toas.planet_pos = {}
    if toas.planets:
        toas.planet_pos = {
            p: objPosVel_wrt_SSB(p, tdb, toas.ephem,
                                 provider=toas.ephem_provider).pos - obs
            for p in toas.PLANETS}
    return toas


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
        zero, and the Sun and planets from the ephemeris tier
        (:func:`solar_system_posvels`)."""
        norm = Epochs(toas.day, toas.sec, "utc").normalized()
        toas.tdb = Epochs(norm.day, norm.sec, "tdb")
        zero = np.zeros((len(toas), 3))
        toas.ssb_obs = PosVel(zero, zero.copy(), origin="ssb",
                              obj="barycenter")
        return solar_system_posvels(toas)


class GeocenterObs(Observatory):
    """geocenter / coe: the Earth's centre, epochs taken as TDB
    (``simulation.geocenter_posvels``; the JAX package reads them as
    UTC, which waits for the port of ``timescales.py``)."""

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
