"""TOAs and their device packing, slimmed to what the ported slices
need.

Counterpart of the JAX package's ``toa.py``. The host table here holds
TOAs that arrive already barycentred — TDB epochs, observatory and Sun
positions — or whose observatory is one of the special locations of
``observatory/`` (the barycentre, the geocentre), which fill those
columns themselves (``compute_posvels``). ``TOAs.to_batch(device)``
packs them into a ``TOABatch`` of float64 tensors, the single
host->device boundary. The special locations take the Sun, the Earth
and the planets from the ephemeris tiers of ``ephemeris/`` (a real SPK
kernel, the shipped numeph kernel, the analytic series), resolved once
per table as the JAX package does. Tim-file parsing, clock chains,
UTC->TDB and the posvels of real observatories are host ingest and are
not part of this package yet.

Per-TOA flags are lazy, as in the JAX package: a table built without
flags (a photon table of millions of rows) stores no dicts, and
``get_pulse_numbers`` reads none.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from . import DTYPE, resolve_device
from .constants import C_M_S
from .mjd import Epochs
from .utils import PosVel


class TOABatch(NamedTuple):
    """Device-side TOA tensor bundle (float64; same fields and units as
    the JAX package's TOABatch: seconds, MHz, microseconds,
    light-seconds)."""

    tdb_day: torch.Tensor  # integer-valued TDB MJD day
    tdb_sec: torch.Tensor  # seconds of day
    freq_mhz: torch.Tensor  # observing frequency (inf = infinite-frequency TOA)
    error_us: torch.Tensor  # TOA uncertainty
    obs_pos_ls: torch.Tensor  # (n,3) observatory wrt SSB, light-seconds
    obs_vel_ls: torch.Tensor  # (n,3) light-seconds/second
    obs_sun_ls: torch.Tensor  # (n,3) sun wrt observatory, light-seconds
    planet_pos_ls: torch.Tensor  # (n_planets, n, 3) planets wrt observatory (may be empty)
    pulse_number: torch.Tensor  # tracked pulse numbers (nan = untracked)

    @property
    def n_toas(self):
        return self.tdb_day.shape[-1]


class TOAs:
    """Host-side TOA table (reference: toa.py::TOAs), barycentred
    columns only. ``day``/``sec`` are the TOA epochs as given (what
    ``get_mjds`` reads, like the JAX package), ``tdb`` the TDB epochs,
    ``ssb_obs``/``obs_sun`` the observatory and Sun positions, ``ephem``
    the ephemeris they come from and ``ephem_provider`` the tier that
    served it ('spk', 'numeph' or 'analytic'; None until
    ``compute_posvels`` runs)."""

    PLANETS = ("venus", "mars", "jupiter", "saturn", "uranus", "neptune")

    def __init__(self):
        self.day = np.zeros(0, np.int64)
        self.sec = np.zeros(0)
        self.error_us = np.zeros(0)
        self.freq_mhz = np.zeros(0)
        self.obs = np.zeros(0, dtype=object)
        self._flags: list[dict] | None = None  # lazy; see ``flags``
        self.weights: np.ndarray | None = None  # per-photon probabilities
        self.planets = False  # whether planet positions are wanted
        self.filename = None  # the file a loader read, if any
        self.ephem = "de440s"
        self.ephem_provider: str | None = None
        self.tdb: Epochs | None = None
        self.ssb_obs: PosVel | None = None
        self.obs_sun: PosVel | None = None
        self.planet_pos: dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.day)

    @property
    def flags(self) -> list[dict]:
        """Per-TOA flag dicts; a table built without flags makes its
        empty dicts only when this is read (JAX ``toa.py:114-128``)."""
        if self._flags is None:
            self._flags = [{} for _ in range(len(self))]
        return self._flags

    @flags.setter
    def flags(self, value):
        self._flags = None if value is None else list(value)

    def has_flags(self) -> bool:
        """True when the table holds flag dicts (the check to use
        instead of reading ``flags``, which would make them)."""
        return self._flags is not None

    @classmethod
    def from_arrays(cls, day, sec, error_us=1.0, freq_mhz=np.inf,
                    obs="geocenter", flags=None, tdb=None, ssb_obs=None,
                    obs_sun=None, planet_pos=None, weights=None,
                    ephem="de440s") -> "TOAs":
        """Vectorized constructor from barycentred columns: ``tdb`` an
        :class:`~pint_tpu_torch.mjd.Epochs`, ``ssb_obs``/``obs_sun``
        :class:`~pint_tpu_torch.utils.PosVel` (metres, m/s),
        ``planet_pos`` {name: (n, 3) metres wrt the observatory},
        ``flags`` a list of per-TOA dicts or None (no dicts are made),
        ``weights`` per-photon probabilities or None, ``ephem`` the
        ephemeris name the posvels are (or will be) computed from."""
        t = cls()
        t.ephem = ephem
        n = len(day)
        t.day = np.asarray(day, np.int64)
        t.sec = np.asarray(sec, np.float64)
        t.error_us = np.broadcast_to(
            np.asarray(error_us, np.float64), (n,)).copy()
        t.freq_mhz = np.broadcast_to(
            np.asarray(freq_mhz, np.float64), (n,)).copy()
        t.obs = (np.full(n, obs, dtype=object) if isinstance(obs, str)
                 else np.asarray(obs, dtype=object))
        t.flags = flags
        if t.has_flags() and len(t.flags) != n:
            raise ValueError(f"{len(t.flags)} flag dicts for {n} TOAs")
        t.weights = None if weights is None else np.asarray(weights, float)
        if t.weights is not None and t.weights.shape != (n,):
            raise ValueError(f"{t.weights.shape} weights for {n} TOAs")
        t.tdb = tdb
        t.ssb_obs = ssb_obs
        t.obs_sun = obs_sun
        t.planet_pos = dict(planet_pos or {})
        return t

    def adjust_times(self, delta_sec):
        """Shift the TOA epochs in place by ``delta_sec`` (scalar or
        per-TOA) and drop every derived column, which the caller
        recomputes (reference: toa.py::TOAs.adjust_TOAs)."""
        norm = Epochs(self.day, self.sec + np.asarray(delta_sec),
                      "utc").normalized()
        self.day, self.sec = norm.day, norm.sec
        self.tdb = None
        self.ssb_obs = None
        self.obs_sun = None
        self.planet_pos = {}
        self.ephem_provider = None

    def get_flag_value(self, flag: str, fill=""):
        return np.array([f.get(flag, fill) for f in self.flags], dtype=object)

    def get_pulse_numbers(self):
        pn = np.full(len(self), np.nan)
        if not self.has_flags():
            return pn
        for i, f in enumerate(self.flags):
            if "pn" in f:
                pn[i] = float(f["pn"])
        return pn

    def get_mjds(self) -> np.ndarray:
        return Epochs(self.day, self.sec, "utc").mjd_float()

    def mask(self, condition) -> "TOAs":
        """A new table of the TOAs where ``condition`` (bool array) is
        true, every column carried (reference: toa.py::TOAs.mask)."""
        return _concat([(self, np.asarray(condition, dtype=bool))])

    def compute_posvels(self):
        """Fill ``tdb``, ``ssb_obs``, ``obs_sun`` (and ``planet_pos``)
        from the table's observatory, one of the special locations of
        ``observatory/`` (reference: toa.py::TOAs.compute_posvels). Any
        other observatory, or a table that mixes observatories, raises
        ``NotImplementedError``: that is host ingest."""
        from .observatory import HOST_INGEST, get_observatory

        names = {str(o) for o in np.unique(self.obs.astype(str))}
        obs = {type(get_observatory(n)) for n in names}
        if len(obs) > 1:
            raise NotImplementedError(
                f"TOAs from several observatories {sorted(names)}: "
                f"{HOST_INGEST}")
        if obs:
            get_observatory(names.pop()).fill_posvels(self)
        return self

    def ensure_posvels(self):
        """``compute_posvels`` if ``tdb``, ``ssb_obs`` or ``obs_sun`` is
        missing (as the JAX package's to_batch does); returns self."""
        if self.tdb is None or self.ssb_obs is None or self.obs_sun is None:
            self.compute_posvels()
        return self

    def to_batch(self, device="cuda") -> TOABatch:
        """Pack into a TOABatch of float64 tensors on ``device``; a
        table without posvels gets them first (``ensure_posvels``)."""
        dev = resolve_device(device)
        self.ensure_posvels()
        ls = C_M_S  # meters per light-second
        planet = (np.stack([self.planet_pos[p] for p in self.PLANETS]) / ls
                  if self.planet_pos else np.zeros((0, len(self), 3)))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=DTYPE,
                                   device=dev)

        return TOABatch(
            tdb_day=t(self.tdb.day), tdb_sec=t(self.tdb.sec),
            freq_mhz=t(self.freq_mhz), error_us=t(self.error_us),
            obs_pos_ls=t(self.ssb_obs.pos / ls),
            obs_vel_ls=t(self.ssb_obs.vel / ls),
            obs_sun_ls=t(self.obs_sun.pos / ls),
            planet_pos_ls=t(planet),
            pulse_number=t(self.get_pulse_numbers()))


def _concat(parts) -> TOAs:
    """One table of the rows ``index`` of each ``(toas, index)`` part,
    in order; a derived column (tdb, posvels, planets, weights) is
    carried when every part has it, flags when any part has them; the
    ephemeris name is the first part's, and the tier is kept when every
    part's posvels came from one tier (else None, with a warning, as in
    the JAX package's merge_TOAs)."""
    tabs = [t for t, _ in parts]

    def cat(get):
        return np.concatenate([np.asarray(get(t))[i] for t, i in parts])

    def posvel(name):
        if any(getattr(t, name) is None for t in tabs):
            return None
        return PosVel(cat(lambda t: getattr(t, name).pos),
                      cat(lambda t: getattr(t, name).vel))

    tdb = None
    if all(t.tdb is not None for t in tabs):
        tdb = Epochs(cat(lambda t: t.tdb.day), cat(lambda t: t.tdb.sec),
                     "tdb", cat(lambda t: t.tdb.lo))
    planet_pos = {}
    if all(t.planet_pos for t in tabs):
        planet_pos = {p: cat(lambda t: t.planet_pos[p])
                      for p in tabs[0].planet_pos}
    flags = None
    if any(t.has_flags() for t in tabs):
        flags = [dict(f) for t, i in parts
                 for f in np.asarray(t.flags, dtype=object)[i]]
    weights = None
    if all(t.weights is not None for t in tabs):
        weights = cat(lambda t: t.weights)
    out = TOAs.from_arrays(
        cat(lambda t: t.day), cat(lambda t: t.sec),
        error_us=cat(lambda t: t.error_us),
        freq_mhz=cat(lambda t: t.freq_mhz), obs=cat(lambda t: t.obs),
        flags=flags, tdb=tdb, ssb_obs=posvel("ssb_obs"),
        obs_sun=posvel("obs_sun"), planet_pos=planet_pos, weights=weights,
        ephem=tabs[0].ephem)
    out.planets = tabs[0].planets
    if out.ssb_obs is not None:
        providers = {t.ephem_provider for t in tabs}
        if len(providers) > 1:
            warnings.warn(f"merging TOAs computed under different "
                          f"ephemeris tiers {sorted(map(str, providers))}; "
                          "recompute posvels for a consistent dataset")
        out.ephem_provider = (providers.pop() if len(providers) == 1
                              else None)
    return out


def merge_TOAs(toas_list) -> TOAs:
    """One table of every TOA of ``toas_list``, in order (reference:
    toa.py::merge_TOAs, for the port's barycentred tables: the TDB
    epochs keep their compensation term and the Sun's velocity is
    carried, where the JAX package drops the one and zeroes the other;
    no device computation reads either)."""
    return _concat([(t, slice(None)) for t in toas_list])
