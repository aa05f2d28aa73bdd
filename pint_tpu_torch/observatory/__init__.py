"""Observatory registry: sites, clock chains, positions (host numpy).

Counterpart of the JAX package's ``observatory/__init__.py``
(reference: src/pint/observatory/__init__.py::Observatory/get_observatory,
observatory/topo_obs.py::TopoObs, observatory/special_locations.py).

Ground stations carry published ITRF XYZ (the port's copy of
``data/observatories.json``) and a clock-chain spec; the special
locations (the barycentre, the geocentre) override ``posvel_ssb``.
Clock corrections come from tempo/tempo2-format files in
``data/clock/`` or ``$PINT_TPU_CLOCK_DIR`` (none are bundled); a site
whose files are missing gets a zero correction, with a warning given
once. ``TOAs.compute_posvels`` loops over a table's observatories and
calls ``posvel_ssb`` for each, under the ephemeris tier resolved once
for the table.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from ..earth import gcrs_posvel_from_itrf
from ..ephemeris import objPosVel_wrt_SSB
from ..mjd import Epochs
from ..utils import PosVel
from .clock_file import ClockFile, find_clock_file

_registry: dict[str, "Observatory"] = {}
_alias_map: dict[str, str] = {}


class Observatory:
    """Base observatory (reference: observatory/__init__.py::Observatory)."""

    def __init__(self, name: str, aliases=()):
        self.name = name.lower()
        self.aliases = tuple(a.lower() for a in aliases)
        _registry[self.name] = self
        for a in self.aliases:
            _alias_map[a] = self.name

    def clock_corrections(self, utc: Epochs, include_gps=True,
                          include_bipm=True, bipm_version="BIPM2019",
                          limits="warn") -> np.ndarray:
        """Seconds to ADD to raw topocentric UTC TOAs."""
        return np.zeros(len(utc))

    def posvel_ssb(self, tdb: Epochs, utc: Epochs, ephem: str,
                   provider: str | None = None, gcrs=None) -> PosVel:
        raise NotImplementedError

    @property
    def timescale(self):
        return "utc"


class TopoObs(Observatory):
    """Ground telescope with ITRF XYZ (reference: topo_obs.py::TopoObs)."""

    def __init__(self, name, itrf_xyz, aliases=(), clock_files=(),
                 clock_fmt="tempo2", origin=""):
        super().__init__(name, aliases)
        self.itrf_xyz = np.asarray(itrf_xyz, dtype=np.float64)
        self.clock_files = tuple(clock_files)
        self.clock_fmt = clock_fmt
        self.origin = origin
        self._clock: list[ClockFile] | None = None
        self._warned = False

    def earth_location_itrf(self):
        """The site's ITRF position [m] (TroposphereDelay reads its
        latitude and height from it)."""
        return self.itrf_xyz

    def _load_clock(self):
        if self._clock is None:
            self._clock = []
            for fname in self.clock_files:
                cf = find_clock_file(fname, self.clock_fmt)
                if cf is not None:
                    self._clock.append(cf)
        return self._clock

    def clock_corrections(self, utc: Epochs, include_gps=True,
                          include_bipm=True, bipm_version="BIPM2019",
                          limits="warn") -> np.ndarray:
        corr = np.zeros(len(utc))
        chain = self._load_clock()
        if self.clock_files and not chain and not self._warned:
            warnings.warn(
                f"no clock files found for {self.name} "
                f"({self.clock_files}); proceeding with zero site-clock "
                "correction — drop files into pint_tpu_torch/data/clock/ "
                "for real chains")
            self._warned = True
        for cf in chain:
            corr += cf.evaluate(utc, limits=limits)
        if include_gps:
            gps = find_clock_file("gps2utc.clk", "tempo2")
            if gps is not None:
                corr += gps.evaluate(utc, limits=limits)
        if include_bipm:
            fname = f"tai2tt_{bipm_version.lower()}.clk"
            bipm = find_clock_file(fname, "tempo2")
            if bipm is not None:
                # the file gives TT(BIPM)-TT(TAI); the constant 32.184
                # is already applied in the TAI->TT step
                corr += bipm.evaluate(utc, limits=limits) - 32.184
        return corr

    def posvel_ssb(self, tdb: Epochs, utc: Epochs, ephem: str,
                   provider: str | None = None, gcrs=None) -> PosVel:
        earth = objPosVel_wrt_SSB("earth", tdb, ephem, provider=provider)
        # gcrs: (pos, vel) from the topocentric-TDB step at the same
        # epochs, which saves a second precession/nutation chain
        gpos, gvel = (gcrs if gcrs is not None
                      else gcrs_posvel_from_itrf(self.itrf_xyz, utc))
        return PosVel(earth.pos + gpos, earth.vel + gvel, origin="ssb",
                      obj=self.name)


class BarycenterObs(Observatory):
    """@ / bat: TOAs already at the SSB, in TDB (reference:
    special_locations.py)."""

    @property
    def timescale(self):
        return "tdb"

    def posvel_ssb(self, tdb, utc, ephem, provider=None, gcrs=None):
        z = np.zeros((len(tdb), 3))
        return PosVel(z, z, origin="ssb", obj="barycenter")


class GeocenterObs(Observatory):
    """geocenter / coe: the Earth's centre, with UTC epochs converted
    by ``timescales.py`` (reference: special_locations.py::GeocenterObs)."""

    def posvel_ssb(self, tdb, utc, ephem, provider=None, gcrs=None):
        e = objPosVel_wrt_SSB("earth", tdb, ephem, provider=provider)
        return PosVel(e.pos, e.vel, origin="ssb", obj="geocenter")


def _load_builtin():
    if "gbt" in _registry:
        return
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "observatories.json")
    with open(path) as f:
        defs = json.load(f)
    for name, d in defs.items():
        TopoObs(name, d["itrf_xyz"], aliases=d.get("aliases", ()),
                clock_files=d.get("clock_files", ()),
                clock_fmt=d.get("clock_fmt", "tempo2"),
                origin=d.get("origin", ""))
    BarycenterObs("barycenter", aliases=("@", "bat", "ssb"))
    GeocenterObs("geocenter", aliases=("coe", "geo", "0"))


def get_observatory(name: str) -> Observatory:
    """The observatory called ``name`` or one of its aliases
    (case-insensitive); ``KeyError`` for an unknown name (reference:
    observatory/__init__.py::get_observatory)."""
    _load_builtin()
    key = str(name).lower()
    if key in _registry:
        return _registry[key]
    if key in _alias_map:
        return _registry[_alias_map[key]]
    raise KeyError(f"unknown observatory {str(name)!r}")


def list_observatories():
    _load_builtin()
    return sorted(_registry)


__all__ = ["BarycenterObs", "GeocenterObs", "Observatory", "TopoObs",
           "get_observatory", "list_observatories"]
