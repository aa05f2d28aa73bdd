"""TOA loading, preparation, and device packing (host numpy; torch only
in ``to_batch``).

Counterpart of the JAX package's ``toa.py`` (reference:
src/pint/toa.py — TOA/TOAs/get_TOAs/read_toa_file). The host side
parses tim files (the C++ parser of ``native.py`` for plain FORMAT-1
files, the Python parsers otherwise), applies clock chains, converts
UTC to TDB (``timescales.py``, plus the topocentric term of ground
observatories), and computes the observatory, Sun and planet positions
per observatory (``observatory/``) under the ephemeris tier resolved
once per table. ``TOAs.to_batch(device)`` then packs everything into a
``TOABatch`` of float64 tensors, the single host->device boundary.

The pipeline order is the JAX package's: ``apply_clock_corrections``
-> ``compute_TDBs`` -> ``compute_posvels``; ``compute_TDBs`` reads
``clock_corr_s`` whether or not clocks were applied (zeros until
then), and ``to_batch`` computes missing posvels without applying
clocks.

Per-TOA flags are lazy: a table built without flags (a photon table of
millions of rows) stores no dicts, and the native parser's packed flags
are decoded only when read.
"""

from __future__ import annotations

import os
import pickle
import re
import warnings
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from . import DTYPE, resolve_device
from . import timescales as ts
from .constants import C_M_S, SECS_PER_DAY
from .mjd import LD, Epochs, format_mjds, parse_mjd_string
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


@dataclass
class TOA:
    """One arrival time (host-side record; reference: toa.py::TOA)."""

    day: int
    sec: float
    error_us: float = 1.0
    freq_mhz: float = np.inf
    obs: str = "barycenter"
    flags: dict = field(default_factory=dict)


class TOAs:
    """Host-side TOA table (reference: toa.py::TOAs).

    Columns are numpy arrays; ``flags`` is a list of dicts. ``day``/
    ``sec`` are the TOA epochs as given (UTC for ground observatories
    and the geocentre, TDB at the barycentre), ``clock_corr_s`` the
    clock chain's seconds, ``tdb`` the TDB epochs, ``ssb_obs``/
    ``obs_sun`` the observatory and Sun positions, ``ephem`` the
    ephemeris and ``ephem_provider`` the tier that served it ('spk',
    'numeph' or 'analytic'; None until ``compute_posvels`` runs).
    """

    PLANETS = ("venus", "mars", "jupiter", "saturn", "uranus", "neptune")

    def __init__(self, toalist: list[TOA], ephem="de440s", planets=False,
                 include_gps=True, include_bipm=True,
                 bipm_version="BIPM2019"):
        self.ephem = ephem
        self.planets = planets
        self.include_gps = include_gps
        self.include_bipm = include_bipm
        self.bipm_version = bipm_version
        self.include_site_clock = True  # False only for CLOCK UNCORR
        self.commands: list[str] = []
        self.filename = None
        n = len(toalist)
        self.day = np.array([t.day for t in toalist], dtype=np.int64)
        self.sec = np.array([t.sec for t in toalist], dtype=np.float64)
        self.error_us = np.array([t.error_us for t in toalist],
                                 dtype=np.float64)
        self.freq_mhz = np.array([t.freq_mhz for t in toalist],
                                 dtype=np.float64)
        self.obs = np.array([t.obs for t in toalist], dtype=object)
        self._flags: list[dict] | None = [dict(t.flags) for t in toalist]
        # packed (blob, offsets) from the native tim parser, decoded
        # into dicts only when flags are read
        self._flags_raw: tuple | None = None
        self.weights: np.ndarray | None = None  # per-photon probabilities
        self.clock_corr_s = np.zeros(n)
        self.tdb: Epochs | None = None
        self.ssb_obs: PosVel | None = None
        self.obs_sun: PosVel | None = None
        self.planet_pos: dict[str, np.ndarray] = {}
        self.ephem_provider: str | None = None
        # per-observatory ITRF->GCRS products of the topocentric-TDB
        # step, consumed (and cleared) by the next compute_posvels over
        # the same epochs
        self._gcrs_cache: dict = {}
        self._clock_applied = False

    def __len__(self):
        return len(self.day)

    @property
    def flags(self) -> list[dict]:
        """Per-TOA flag dicts, made (or decoded from the native
        parser's blob) when first read."""
        if self._flags is None:
            if self._flags_raw is not None:
                self._flags = _decode_flags(*self._flags_raw)
                self._flags_raw = None
            else:
                self._flags = [{} for _ in range(len(self))]
        return self._flags

    @flags.setter
    def flags(self, value):
        self._flags = None if value is None else list(value)
        self._flags_raw = None

    def has_flags(self) -> bool:
        """True when the table holds flag data (the check to use
        instead of reading ``flags``, which would make empty dicts)."""
        if self._flags_raw is not None:
            self.flags
        return self._flags is not None

    @classmethod
    def from_arrays(cls, day, sec, error_us=1.0, freq_mhz=np.inf,
                    obs="barycenter", ephem="de440s", planets=False,
                    weights=None, flags=None, tdb=None, ssb_obs=None,
                    obs_sun=None, planet_pos=None, **kw) -> "TOAs":
        """Vectorized constructor, no per-row Python objects. ``flags``
        is a list of per-TOA dicts or None (no dicts are made),
        ``weights`` per-photon probabilities or None; ``tdb`` (an
        :class:`~pint_tpu_torch.mjd.Epochs`), ``ssb_obs``/``obs_sun``
        (:class:`~pint_tpu_torch.utils.PosVel`, metres, m/s) and
        ``planet_pos`` ({name: (n, 3) metres wrt the observatory})
        supply columns computed elsewhere; ``kw`` are the clock-chain
        settings of the constructor."""
        t = cls([], ephem=ephem, planets=planets, **kw)
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
        if t._flags is not None and len(t._flags) != n:
            raise ValueError(f"{len(t._flags)} flag dicts for {n} TOAs")
        t.weights = None if weights is None else np.asarray(weights, float)
        if t.weights is not None and t.weights.shape != (n,):
            raise ValueError(f"{t.weights.shape} weights for {n} TOAs")
        t.clock_corr_s = np.zeros(n)
        t.tdb = tdb
        t.ssb_obs = ssb_obs
        t.obs_sun = obs_sun
        t.planet_pos = dict(planet_pos or {})
        return t

    def _by_observatory(self):
        """[(name, mask)] for each distinct observatory, sorted by name,
        as np.unique orders them; found from a set, and with no
        per-TOA string array for a one-observatory table (photon tables
        have millions of rows)."""
        names = sorted({str(o) for o in set(self.obs.tolist())})
        if len(names) == 1:
            return [(names[0], np.ones(len(self), dtype=bool))]
        obs_names = self.obs.astype(str)
        return [(name, obs_names == name) for name in names]

    # ---- pipeline steps (reference: toa.py same names) ----

    def apply_clock_corrections(self, limits="warn"):
        from .observatory import get_observatory

        if self._clock_applied:
            return
        if not self.include_site_clock:
            # CLOCK UNCORR: raw TOAs, no site/GPS/BIPM chain at all
            self._clock_applied = True
            return
        for obs_name, mask in self._by_observatory():
            ob = get_observatory(obs_name)
            if ob.timescale == "utc":
                sub = Epochs(self.day[mask], self.sec[mask], "utc")
                self.clock_corr_s[mask] = ob.clock_corrections(
                    sub, include_gps=self.include_gps,
                    include_bipm=self.include_bipm,
                    bipm_version=self.bipm_version, limits=limits)
        self._clock_applied = True

    def compute_TDBs(self):
        from .observatory import get_observatory

        corrected = Epochs(self.day, self.sec + self.clock_corr_s,
                           "utc").normalized()
        groups = self._by_observatory()
        toa_scale = np.empty(len(self), dtype="<U3")
        for o, mask in groups:
            toa_scale[mask] = get_observatory(o).timescale
        if (toa_scale == "tdb").all():
            self.tdb = Epochs(corrected.day, corrected.sec, "tdb")
            return
        self.tdb = ts.utc_to_tdb(corrected)
        for scale in ("tdb", "tt"):
            m = toa_scale == scale
            if not m.any():
                continue
            sub = Epochs(corrected.day[m], corrected.sec[m], scale)
            out = sub if scale == "tdb" else ts.tt_to_tdb(sub)
            self.tdb.day[m] = out.day
            self.tdb.sec[m] = out.sec
        self._apply_topocentric_tdb(corrected, groups, toa_scale)

    def _apply_topocentric_tdb(self, corrected_utc, groups, toa_scale):
        """Add the topocentric part of TDB-TT, v_earth . r_obs / c^2
        (~2.1 us diurnal at the equator), for ground observatories.

        ``timescales.tdb_minus_tt`` is geocentric; this term depends on
        the observatory (the reference gets it through location-aware
        astropy Time.tdb). The geocentre and the barycentre keep the
        geocentric convention. The Earth velocity's tier barely matters
        here (1 m/s moves the term by 7e-17 s).
        """
        from .earth.erfa_lite import gcrs_posvel_from_itrf
        from .ephemeris import objPosVel_wrt_SSB
        from .observatory import get_observatory

        for obs_name, at_obs in groups:
            ob = get_observatory(obs_name)
            itrf = getattr(ob, "itrf_xyz", None)
            if itrf is None:
                continue
            mask = at_obs & (toa_scale == "utc")
            if not mask.any():
                continue
            utc_sub = Epochs(corrected_utc.day[mask],
                             corrected_utc.sec[mask], "utc")
            tdb_sub = Epochs(self.tdb.day[mask], self.tdb.sec[mask], "tdb")
            r_gcrs, v_gcrs = gcrs_posvel_from_itrf(np.asarray(itrf, float),
                                                   utc_sub)
            # compute_posvels needs the same ITRF->GCRS products; the
            # corrected-UTC epochs ride along as the validity key, so a
            # mutation of the epochs or the clock corrections in between
            # (even one that keeps the length) recomputes them
            self._gcrs_cache[obs_name] = (r_gcrs, v_gcrs,
                                          utc_sub.day.copy(),
                                          utc_sub.sec.copy())
            v_earth = objPosVel_wrt_SSB("earth", tdb_sub, self.ephem).vel
            dtopo = np.sum(v_earth * r_gcrs, axis=-1) / C_M_S**2
            self.tdb.sec[mask] += dtopo
        self.tdb = self.tdb.normalized()

    def compute_posvels(self):
        """Fill ``ssb_obs``, ``obs_sun`` and (with ``planets``)
        ``planet_pos``, observatory by observatory, under the ephemeris
        tier resolved once on every epoch (reference:
        toa.py::TOAs.compute_posvels); computes the TDB epochs first if
        they are missing. Returns self."""
        from .ephemeris import ephemeris_provider, objPosVel_wrt_SSB
        from .observatory import get_observatory

        if self.tdb is None:
            self.compute_TDBs()
        # one tier for the whole table: subsets straddling the numeph
        # coverage edge must not mix tiers
        self.ephem_provider = ephemeris_provider(self.ephem, self.tdb)
        n = len(self)
        pos = np.zeros((n, 3))
        vel = np.zeros((n, 3))
        sun = np.zeros((n, 3))
        utc = Epochs(self.day, self.sec + self.clock_corr_s,
                     "utc").normalized()
        planet_pos = {p: np.zeros((n, 3))
                      for p in (self.PLANETS if self.planets else ())}
        for obs_name, mask in self._by_observatory():
            ob = get_observatory(obs_name)
            tdb_sub = Epochs(self.tdb.day[mask], self.tdb.sec[mask], "tdb")
            utc_sub = Epochs(utc.day[mask], utc.sec[mask], "utc")
            cached = self._gcrs_cache.pop(obs_name, None)
            gcrs = None
            if cached is not None:
                r_g, v_g, cday, csec = cached
                # exact epoch match: both sides build the corrected UTC
                # as Epochs(day, sec + clock_corr_s).normalized(), so
                # unchanged inputs are bitwise equal and any change misses
                if (len(cday) == int(mask.sum())
                        and np.array_equal(cday, utc_sub.day)
                        and np.array_equal(csec, utc_sub.sec)):
                    gcrs = (r_g, v_g)
            pv = ob.posvel_ssb(tdb_sub, utc_sub, self.ephem,
                               provider=self.ephem_provider, gcrs=gcrs)
            pos[mask] = pv.pos
            vel[mask] = pv.vel
            sun_pv = objPosVel_wrt_SSB("sun", tdb_sub, self.ephem,
                                       provider=self.ephem_provider)
            sun[mask] = sun_pv.pos - pv.pos
            for p in planet_pos:
                ppv = objPosVel_wrt_SSB(p, tdb_sub, self.ephem,
                                        provider=self.ephem_provider)
                planet_pos[p][mask] = ppv.pos - pv.pos
        self.ssb_obs = PosVel(pos, vel, origin="ssb", obj="obs")
        self.obs_sun = PosVel(sun, np.zeros_like(sun), origin="obs",
                              obj="sun")
        self.planet_pos = planet_pos
        return self

    def ensure_posvels(self):
        """``compute_posvels`` if ``tdb``, ``ssb_obs`` or ``obs_sun`` is
        missing (clocks are not applied here, as in the JAX package's
        ``to_batch``); returns self."""
        if self.tdb is None or self.ssb_obs is None or self.obs_sun is None:
            self.compute_posvels()
        return self

    # ---- selection (reference: toa.py::TOAs.mask/select) ----

    def mask(self, condition) -> "TOAs":
        """A new table of the TOAs where ``condition`` (bool array) is
        true, every column carried."""
        return _concat([(self, np.asarray(condition, dtype=bool))])

    def select(self, condition):
        """In-place subset with a restore stack (reference:
        toa.py::TOAs.select); :meth:`unselect` pops back."""
        stack = getattr(self, "_selection", [])
        saved = dict(self.__dict__)
        if self._flags is not None:
            # snapshot the dicts: a flag edit while selected must not
            # leak into the restored state
            saved["_flags"] = [dict(f) for f in self._flags]
        sub = self.mask(np.asarray(condition, dtype=bool))
        self.__dict__ = dict(sub.__dict__)
        self._selection = stack + [saved]

    def unselect(self):
        """Undo the last :meth:`select` (reference: toa.py::TOAs.unselect)."""
        stack = getattr(self, "_selection", [])
        if not stack:
            raise ValueError("no prior TOAs.select() state to restore")
        self.__dict__ = stack[-1]

    def adjust_times(self, delta_sec):
        """Shift the TOA epochs in place by ``delta_sec`` (scalar or
        per-TOA) and drop every derived column and the clock state, so
        they are recomputed (reference: toa.py::TOAs.adjust_TOAs)."""
        norm = Epochs(self.day, self.sec + np.asarray(delta_sec),
                      "utc").normalized()
        self.day, self.sec = norm.day, norm.sec
        self.tdb = None
        self.ssb_obs = None
        self.obs_sun = None
        self.planet_pos = {}
        self._clock_applied = False

    # ---- getters (reference: toa.py::TOAs same names) ----

    def get_flag_value(self, flag: str, fill=""):
        if not self.has_flags():
            return np.full(len(self), fill, dtype=object)
        return np.array([f.get(flag, fill) for f in self._flags],
                        dtype=object)

    def compute_pulse_numbers(self, model, device="cuda"):
        """Set each TOA's ``-pn`` flag to its nearest absolute pulse
        number under ``model`` (the phase runs on ``device``), so a
        written tim file reloads with its tracking intact (reference:
        toa.py::TOAs.compute_pulse_numbers)."""
        ph = model.phase(self, device=device)
        pn = ph.int_.cpu().numpy().astype(np.float64)
        for f, v in zip(self.flags, pn):
            f["pn"] = f"{v:.0f}"
        return pn

    def get_pulse_numbers(self):
        pn = np.full(len(self), np.nan)
        if not self.has_flags():
            return pn
        for i, f in enumerate(self._flags):
            if "pn" in f:
                pn[i] = float(f["pn"])
        return pn

    def get_errors(self) -> np.ndarray:
        """TOA uncertainties [us] (reference: TOAs.get_errors)."""
        return self.error_us

    def get_freqs(self) -> np.ndarray:
        """Observing frequencies [MHz] (reference: TOAs.get_freqs)."""
        return self.freq_mhz

    def get_obss(self) -> np.ndarray:
        """Observatory names (reference: TOAs.get_obss)."""
        return self.obs.astype(str)

    def get_mjds(self) -> np.ndarray:
        return Epochs(self.day, self.sec, "utc").mjd_float()

    def first_mjd(self) -> float:
        return float(self.get_mjds().min())

    def last_mjd(self) -> float:
        return float(self.get_mjds().max())

    def print_summary(self):
        """(reference: toa.py::TOAs.print_summary)"""
        print(self.get_summary())

    def get_summary(self) -> str:
        """(reference: toa.py::TOAs.get_summary)"""
        lines = [f"Number of TOAs: {len(self)}"]
        for obs_name, mask in self._by_observatory():
            lines.append(f"  {obs_name}: {int(mask.sum())}")
        mjds = self.get_mjds()
        lines.append(f"MJD span: {mjds.min():.3f} to {mjds.max():.3f}")
        err = self.error_us
        lines.append(f"TOA errors [us]: min {err.min():.3g}, median "
                     f"{np.median(err):.3g}, max {err.max():.3g}")
        return "\n".join(lines)

    # ---- device packing ----

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

    # ---- writing (reference: toa.py::TOAs.write_TOA_file) ----

    def write_TOA_file(self, path, name="pint_tpu", format="tempo2"):
        """Write a FORMAT-1 tim file, byte for byte what the JAX
        package writes: MJDs to 16 fractional digits, errors at full
        precision (``%.3f`` would truncate 1.8125 to 1.812), flags in
        order. The MJD digits are formed for the whole table at once."""
        mjd = format_mjds(self.day, self.sec, 16)
        flag_dicts = self.flags
        with open(path, "w") as f:
            f.write("FORMAT 1\n")
            f.writelines(
                f"{name} {fr:.6f} {m} {_format_error(e)} {o} "
                f"{' '.join(f'-{k} {v}' for k, v in fl.items())}"
                .rstrip() + "\n"
                for fr, m, e, o, fl in zip(self.freq_mhz.tolist(), mjd,
                                           self.error_us.tolist(),
                                           self.obs, flag_dicts))


def _format_error(e: float) -> str:
    err = f"{e:.6f}".rstrip("0").rstrip(".")
    if "." not in err and "e" not in err:
        err += ".0"
    return err


def _concat(parts) -> TOAs:
    """One table of the rows ``index`` of each ``(toas, index)`` part,
    in order. A derived column (clock corrections, tdb, posvels,
    planets, weights) is carried when every part has it, flags when any
    part has them; settings, commands and the file name are the first
    part's, and the tier is kept when every part's posvels came from
    one tier (else None, with a warning, as in the JAX package's
    merge_TOAs). Unlike the JAX package's merge, the TDB epochs keep
    their compensation term and the Sun's velocity is carried; no
    device computation reads either."""
    tabs = [t for t, _ in parts]
    first = tabs[0]

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
                      for p in first.planet_pos}
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
        ephem=first.ephem, planets=first.planets, weights=weights,
        flags=flags, tdb=tdb, ssb_obs=posvel("ssb_obs"),
        obs_sun=posvel("obs_sun"), planet_pos=planet_pos,
        include_gps=first.include_gps, include_bipm=first.include_bipm,
        bipm_version=first.bipm_version)
    out.clock_corr_s = cat(lambda t: t.clock_corr_s)
    out._clock_applied = all(t._clock_applied for t in tabs)
    out.include_site_clock = first.include_site_clock
    out.commands = list(first.commands)
    out.filename = first.filename
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
    toa.py::merge_TOAs; see :func:`_concat`)."""
    return _concat([(t, slice(None)) for t in toas_list])


# --------------------------------------------------------------------------
# tim parsing (reference: toa.py::read_toa_file / _parse_TOA_line)
# --------------------------------------------------------------------------

_COMMANDS = {"FORMAT", "MODE", "INFO", "INCLUDE", "TIME", "EFAC", "EQUAD",
             "EMIN", "EMAX", "SKIP", "NOSKIP", "JUMP", "PHASE", "TRACK", "END"}


def _parse_tempo2_line(parts):
    name = parts[0]
    freq = float(parts[1])
    day, sec = parse_mjd_string(parts[2])
    err = float(parts[3])
    obs = parts[4]
    flags = {}
    i = 5
    while i < len(parts):
        if parts[i].startswith("-") and not _is_number(parts[i]):
            key = parts[i][1:]
            if i + 1 < len(parts) and not (parts[i + 1].startswith("-")
                                           and not _is_number(parts[i + 1])):
                flags[key] = parts[i + 1]
                i += 2
            else:
                flags[key] = ""
                i += 1
        else:
            i += 1
    flags.setdefault("name", name)
    return TOA(day, sec, err, freq, obs.lower(), flags)


def _is_number(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def _parse_princeton_line(line):
    """Princeton format: obs code col 0, freq cols 15-24, MJD 24-44, err 44-53."""
    obs_code = line[0]
    freq = float(line[15:24])
    day, sec = parse_mjd_string(line[24:44].strip())
    err = float(line[44:53])
    return TOA(day, sec, err, freq, obs_code.lower(), {})


def _parse_parkes_line(line):
    """Parkes/Jodrell fixed-column format (reference: toa.py parkes
    branch of _parse_TOA_line): col 0 blank, freq cols 25-34,
    MJD cols 34-55, phase offset cols 55-63, error cols 63-71,
    observatory code col 79."""
    freq = float(line[25:34])
    day, sec = parse_mjd_string(line[34:55].strip())
    phase_off = line[55:63].strip()
    err = float(line[63:71])
    obs_code = line[79] if len(line) > 79 else line.rstrip()[-1]
    flags = {}
    if phase_off and float(phase_off) != 0.0:
        flags["padd"] = phase_off  # phase offset in periods (tempo PADD)
    return TOA(day, sec, err, freq, obs_code.lower(), flags)


def read_tim_file(path: str, _depth=0,
                  _state: dict | None = None) -> tuple[list[TOA], list[str]]:
    """Parse a tim file into TOA records + commands seen.

    Handles FORMAT 1 (tempo2), princeton and parkes lines, INCLUDE
    recursion, and the TIME/EFAC/EQUAD/EMIN/EMAX/SKIP/NOSKIP/JUMP/
    PHASE/END commands (reference: toa.py::read_toa_file). The command
    state is shared with INCLUDEd files (one dict threaded through the
    recursion): a TIME offset or an open JUMP block in the parent
    applies inside the include, and jump indices stay distinct.
    """
    if _depth > 10:
        raise RuntimeError("INCLUDE recursion too deep")
    toas: list[TOA] = []
    commands: list[str] = []
    st = _state if _state is not None else {
        "fmt": "princeton", "skipping": False, "time_offset": 0.0,
        "efac": 1.0, "equad_us": 0.0, "emin_us": 0.0, "emax_us": np.inf,
        "jump_level": 0, "jump_index": 0, "phase_offset": 0,
    }
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            ls = line.strip()
            if not ls or ls.startswith(("#", "C ", "c ")):
                continue
            parts = ls.split()
            head = parts[0].upper()
            if head in _COMMANDS:
                commands.append(ls)
                if head == "FORMAT" and len(parts) > 1 and parts[1] == "1":
                    st["fmt"] = "tempo2"
                elif head == "INCLUDE":
                    inc = parts[1]
                    if not os.path.isabs(inc):
                        inc = os.path.join(os.path.dirname(path), inc)
                    sub, subcmd = read_tim_file(inc, _depth + 1, _state=st)
                    toas.extend(sub)
                    commands.extend(subcmd)
                elif head == "TIME":
                    st["time_offset"] += float(parts[1])
                elif head == "EFAC":
                    st["efac"] = float(parts[1])
                elif head == "EQUAD":
                    st["equad_us"] = float(parts[1])
                elif head == "EMIN":
                    st["emin_us"] = float(parts[1])
                elif head == "EMAX":
                    st["emax_us"] = (float(parts[1]) if float(parts[1]) > 0
                                     else np.inf)
                elif head == "SKIP":
                    st["skipping"] = True
                elif head == "NOSKIP":
                    st["skipping"] = False
                elif head == "JUMP":
                    st["jump_level"] = 1 - st["jump_level"]
                    if st["jump_level"]:
                        st["jump_index"] += 1
                elif head == "PHASE":
                    st["phase_offset"] += int(float(parts[1]))
                elif head == "END":
                    break
                # MODE, INFO, TRACK: recorded in commands only
                continue
            if st["skipping"]:
                continue
            try:
                if st["fmt"] == "tempo2":
                    toa = _parse_tempo2_line(parts)
                elif line[:1] == " " and len(line.rstrip()) >= 70:
                    # parkes format: leading blank, obs code col 79
                    toa = _parse_parkes_line(line)
                else:
                    toa = _parse_princeton_line(line)
            except (ValueError, IndexError) as e:
                warnings.warn(f"{path}: unparseable TOA line {ls[:60]!r}: {e}")
                continue
            if st["time_offset"]:
                toa.sec += st["time_offset"]
                carry = int(np.floor(toa.sec / SECS_PER_DAY))
                toa.day += carry
                toa.sec -= carry * SECS_PER_DAY
            if st["efac"] != 1.0:
                toa.error_us *= st["efac"]
            if st["equad_us"]:
                toa.error_us = float(np.hypot(toa.error_us, st["equad_us"]))
            # EMIN/EMAX: drop TOAs outside the (scaled) error window
            if toa.error_us < st["emin_us"] or toa.error_us > st["emax_us"]:
                continue
            if st["jump_level"]:
                # one value per block, so each tim JUMP group can become
                # its own JUMP parameter
                toa.flags["tim_jump"] = str(st["jump_index"])
            if st["phase_offset"]:
                toa.flags["phase_offset"] = str(st["phase_offset"])
            toas.append(toa)
    return toas, commands


def _decode_flags(blob: bytes, off) -> list[dict]:
    """Unpack the native parser's flags blob (``key\\x1fvalue`` pairs
    joined by ``\\x1e``, offsets delimiting each TOA) into dicts. The
    offsets are byte positions, so slicing happens on the bytes and
    each key/value decodes on its own (a non-ASCII value must not
    shift later TOAs' slices)."""
    out = []
    for i in range(len(off) - 1):
        s = blob[off[i]:off[i + 1]]
        d = {}
        if s:
            for pair in s.split(b"\x1e"):
                k, _, v = pair.partition(b"\x1f")
                d[k.decode(errors="replace")] = v.decode(errors="replace")
        out.append(d)
    return out


_TIM_CMD_RE = re.compile(
    rb"^[ \t]*(FORMAT|MODE|INFO|TRACK|END)(?:[ \t]|$)", re.I)
_TIM_EOL_RE = re.compile(rb"\r\n|\r|\n")  # Python's universal newlines


def _collect_tim_commands(data: bytes) -> list[str]:
    """The benign command lines in file order, split exactly as Python
    text mode splits (\\n, \\r\\n, bare \\r), up to END inclusive: the
    native path's counterpart of read_tim_file's commands list."""
    cmds = []
    for ln in _TIM_EOL_RE.split(data):
        if _TIM_CMD_RE.match(ln):
            line = ln.strip().decode(errors="replace")
            cmds.append(line)
            if line.split()[0].upper() == "END":
                break
    return cmds


def _read_tim_native(path: str, **toas_kw) -> "TOAs | None":
    """TOAs straight from the C++ tim parser, for a plain ASCII FORMAT-1
    file (the common case at PTA scale). None when the library is not
    loaded or the file needs the Python parser's semantics (INCLUDE,
    TIME/EFAC/... state, princeton/parkes lines, any non-ASCII byte);
    ``read_tim_file`` then handles it."""
    from . import native

    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    res = native.parse_tim_t2(data)
    if res is None:
        return None
    day, sec, freq, err, obs, blob, flag_off, n_bad = res
    if n_bad:
        warnings.warn(f"{path}: {n_bad} unparseable TOA line(s) skipped")
    t = TOAs.from_arrays(day, sec, error_us=err, freq_mhz=freq, obs=obs,
                         flags=None, **toas_kw)
    t._flags_raw = (blob, flag_off)
    t.commands = _collect_tim_commands(data)
    t.filename = str(path)
    return t


# --------------------------------------------------------------------------
# get_TOAs and its pickle cache (reference: toa.py::get_TOAs)
# --------------------------------------------------------------------------

# Bump whenever the posvel/clock/TDB pipeline or the tim parser's
# semantics change: a cached pickle carries computed columns.
_PHYSICS_REV = 6

# The cache's own suffix: the JAX package writes ``<tim>.pickle.gz``
# with the same layout and settings key, and its pickles hold its own
# classes.
PICKLE_SUFFIX = ".torch.pickle.gz"


class _PortUnpickler(pickle.Unpickler):
    """Resolves only this package's, numpy's and the builtin types, so a
    pickle of another package's TOAs is a miss and never imports that
    package."""

    _MODULES = ("pint_tpu_torch", "numpy", "builtins", "collections",
                "copyreg", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] not in self._MODULES:
            raise pickle.UnpicklingError(f"{module}.{name} is not a type "
                                         "of pint_tpu_torch's TOAs")
        return super().find_class(module, name)


def _pickle_settings_key(ephem, planets, include_gps, include_bipm,
                         bipm_version, include_site_clock=True):
    from . import __version__
    from .ephemeris import ephemeris_provider, numeph_fingerprint
    from .utils import compute_hash

    # the package, its version, the physics revision, the active tier and
    # the numeph kernel's fingerprint are in the key: a change to any of
    # them changes the columns a pickle holds
    return compute_hash(repr((ephem, planets, include_gps, include_bipm,
                              bipm_version, include_site_clock,
                              __name__, __version__, _PHYSICS_REV,
                              ephemeris_provider(ephem),
                              numeph_fingerprint())))


def _tim_content_hash(path) -> str:
    """Hash a tim file and every file it INCLUDEs (recursively), so an
    edit to an included file misses the cache too."""
    from .utils import compute_hash

    chunks = []

    def visit(p, depth=0):
        if depth > 10:
            return
        with open(p, "rb") as f:
            data = f.read()
        chunks.append(data)
        for raw in data.decode("utf-8", errors="replace").splitlines():
            parts = raw.split()
            if parts and parts[0].upper() == "INCLUDE" and len(parts) > 1:
                inc = parts[1]
                if not os.path.isabs(inc):
                    inc = os.path.join(os.path.dirname(str(p)), inc)
                if os.path.exists(inc):
                    visit(inc, depth + 1)

    visit(str(path))
    return compute_hash(*chunks)


def save_pickle(toas: TOAs, picklefile=None):
    """Cache prepared TOAs next to their tim file, keyed on its
    contents and the load settings (reference: toa.py::save_pickle).
    TOAs without a source file need an explicit ``picklefile`` and are
    stored unvalidated."""
    import gzip

    if picklefile is None:
        if toas.filename is None:
            raise ValueError("no picklefile given and TOAs has no filename")
        picklefile = str(toas.filename) + PICKLE_SUFFIX
    content_hash = (_tim_content_hash(toas.filename)
                    if toas.filename is not None else None)
    key = _pickle_settings_key(toas.ephem, toas.planets, toas.include_gps,
                               toas.include_bipm, toas.bipm_version,
                               toas.include_site_clock)
    with gzip.open(picklefile, "wb") as f:
        pickle.dump({"content_hash": content_hash, "settings": key,
                     "toas": toas}, f)
    return picklefile


def load_pickle(timfile, picklefile=None, ephem="de440s", planets=False,
                include_gps=True, include_bipm=True,
                bipm_version="BIPM2019", include_site_clock=True) -> TOAs | None:
    """Cached TOAs if fresh, else None (reference: toa.py::load_pickle).
    A pickle that holds anything but this package's TOAs is a miss."""
    import gzip

    if picklefile is None:
        if timfile is None:
            raise ValueError("need timfile or picklefile")
        picklefile = str(timfile) + PICKLE_SUFFIX
    if not os.path.exists(picklefile):
        return None
    try:
        with gzip.open(picklefile, "rb") as f:
            blob = _PortUnpickler(f).load()
        if not isinstance(blob, dict) or not isinstance(blob.get("toas"), TOAs):
            return None
        key = _pickle_settings_key(ephem, planets, include_gps, include_bipm,
                                   bipm_version, include_site_clock)
        if blob["settings"] != key:
            return None
        if timfile is not None:
            if blob["content_hash"] != _tim_content_hash(timfile):
                return None  # the tim file (or an INCLUDE) changed
        elif blob["content_hash"] is not None:
            return None
        return blob["toas"]
    except (OSError, pickle.UnpicklingError, KeyError, EOFError,
            ImportError, AttributeError):
        return None


def get_TOAs(timfile, ephem="de440s", planets=False, model=None,
             include_gps=True, include_bipm=True, bipm_version="BIPM2019",
             limits="warn", usepickle=False) -> TOAs:
    """Load and prepare TOAs: parse, clock chain, TDB, posvels
    (reference: toa.py::get_TOAs; all host numpy).

    With ``model``, its EPHEM, PLANET_SHAPIRO and CLOCK settings apply
    (``TT(BIPMxxxx)``, ``TT(TAI)``/``UTC(NIST)``/``UTC`` without the
    BIPM step, ``UNCORR`` without any clock chain). With
    ``usepickle=True`` a cache next to the tim file, validated by its
    contents and the settings, skips the pipeline on reload.
    """
    uncorr = False
    if model is not None:
        if "EPHEM" in model.params and model.EPHEM.value:
            ephem = model.EPHEM.value
        if "PLANET_SHAPIRO" in model.params and model.PLANET_SHAPIRO.value:
            planets = True
        clock = model.CLOCK if "CLOCK" in model.params else None
        if clock is not None and clock.value:
            cv = str(clock.value).upper().replace(" ", "")
            m_bipm = re.match(r"TT\(BIPM(\d{4})?\)", cv)
            if m_bipm:
                include_bipm = True
                if m_bipm.group(1):
                    bipm_version = f"BIPM{m_bipm.group(1)}"
            elif cv in ("TT(TAI)", "UTC(NIST)", "UTC"):
                include_bipm = False
            elif cv == "UNCORR":
                # tempo2: no clock corrections at all
                include_bipm = False
                include_gps = False
                uncorr = True
            else:
                warnings.warn(
                    f"unrecognized CLOCK realization {clock.value!r}; "
                    f"proceeding with the default chain (include_bipm="
                    f"{include_bipm}, {bipm_version})")
    if usepickle:
        cached = load_pickle(timfile, ephem=ephem, planets=planets,
                             include_gps=include_gps,
                             include_bipm=include_bipm,
                             bipm_version=bipm_version,
                             include_site_clock=not uncorr)
        if cached is not None:
            return cached
    t = _read_tim_native(str(timfile), ephem=ephem, planets=planets,
                         include_gps=include_gps, include_bipm=include_bipm,
                         bipm_version=bipm_version)
    if t is None:
        toalist, commands = read_tim_file(str(timfile))
        t = TOAs(toalist, ephem=ephem, planets=planets,
                 include_gps=include_gps, include_bipm=include_bipm,
                 bipm_version=bipm_version)
        t.commands = commands
        t.filename = str(timfile)
    t.include_site_clock = not uncorr
    t.apply_clock_corrections(limits=limits)
    t.compute_TDBs()
    t.compute_posvels()
    if usepickle:
        save_pickle(t)
    return t
