"""Dispersion delays (torch counterpart of the JAX package's
``models/dispersion.py``).

(reference: src/pint/models/dispersion_model.py — DispersionDM, the DM
Taylor series at DMEPOCH with delay = DMconst*DM/freq^2; DispersionDMX,
piecewise-constant windows DMX_####/DMXR1_####/DMXR2_####;
DispersionJump, the wideband DMJUMP offsets.)
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..constants import SECS_PER_DAY, SECS_PER_JULIAN_YEAR, DMconst
from .parameter import (MJDParameter, floatParameter, maskParameter,
                        pack_mask_values, prefixParameter)
from .timing_model import DelayComponent, MissingParameter


class DispersionDM(DelayComponent):
    category = "dispersion"
    order = 30

    def __init__(self):
        super().__init__()
        self.add_param(prefixParameter("DM", "DM", 0, units="pc cm^-3",
                                       description="Dispersion measure"))
        self.add_param(MJDParameter("DMEPOCH", units="MJD",
                                    description="Epoch of DM measurement"))

    def validate(self):
        if self.DM.value is None:
            raise MissingParameter("DispersionDM", "DM")

    def n_terms(self):
        n = 0
        while f"DM{n + 1}" in self.params:
            n += 1
        return n + 1

    def add_dmterm(self, index, value=0.0, frozen=True):
        p = prefixParameter(f"DM{index}", "DM", index,
                            units=f"pc cm^-3/yr^{index}", frozen=frozen)
        p.value = value
        self.add_param(p)

    def device_slot(self, pname):
        if pname == "DM":
            return "DM", 0
        return "DM", int(pname[2:])

    def pack(self, model, toas, prep, params0, device=None):
        vals = np.array([getattr(self, f"DM{i}" if i else "DM").value or 0.0
                         for i in range(self.n_terms())], dtype=np.float64)
        params0["DM"] = vals
        de = self.DMEPOCH
        if de is not None and de.day is not None:
            day, sec = de.day, de.sec
        else:
            day, sec = prep["pepoch_day"], prep["pepoch_sec"]
        prep["dmepoch_dt"] = ((toas.tdb.day - day).astype(np.float64)
                              * SECS_PER_DAY + (toas.tdb.sec - sec))

    def dm_value(self, params, prep):
        """DM(t) Taylor series [pc/cm^3]; DM1, DM2, ... in
        pc cm^-3 / yr^i, so the expansion runs in Julian years."""
        dm = params["DM"]
        dt = prep["dmepoch_dt"] / SECS_PER_JULIAN_YEAR
        out = 0.0 * dt
        fact = 1.0
        tp = 1.0
        for i in range(dm.shape[0]):
            if i > 0:
                fact *= i
            out = out + dm[i] * tp / fact
            tp = tp * dt
        return out

    def delay(self, params, batch, prep, delay_accum):
        dm = self.dm_value(params, prep)
        f2 = torch.square(batch.freq_mhz)
        return torch.where(torch.isfinite(f2), DMconst * dm / f2, 0.0)


class DispersionDMX(DelayComponent):
    """Piecewise-constant DM offsets (reference: DispersionDMX)."""

    category = "dispersion_dmx"
    order = 31

    def __init__(self):
        super().__init__()
        # bare "DMX <days>" par line: the legacy tempo bin width, kept
        # for round trips and not used in the delay
        self.add_param(floatParameter(
            "DMX", units="d",
            description="legacy DMX bin width marker (unused in delay)"))
        self.dmx_ids: list[int] = []

    def validate(self):
        super().validate()
        # the bare bin-width marker has no device slot: freeze it
        # loudly rather than fail in prepare()
        if not self.DMX.frozen:
            warnings.warn("bare DMX is a legacy bin-width marker, not a "
                          "fittable parameter; freezing it")
            self.DMX.frozen = True
        # a missing DMXR1/DMXR2 pair would be the empty window [0, 0]
        # and an identically-zero design column
        windows = []
        for i in self.dmx_ids:
            r1 = getattr(self, f"DMXR1_{i:04d}").value
            r2 = getattr(self, f"DMXR2_{i:04d}").value
            if r1 is None or r2 is None or not r1 < r2:
                raise MissingParameter(
                    "DispersionDMX", f"DMXR1_{i:04d}/DMXR2_{i:04d}",
                    f"DMX_{i:04d} needs a non-empty MJD window "
                    f"(got [{r1}, {r2}])")
            windows.append((r1, r2, i))
        # overlapping windows apply additively to shared TOAs: say so
        # once (the tempo convention is disjoint bins)
        windows.sort()
        for (a1, a2, ia), (b1, b2, ib) in zip(windows, windows[1:]):
            if b1 < a2:
                warnings.warn(
                    f"DMX windows DMX_{ia:04d} [{a1}, {a2}] and "
                    f"DMX_{ib:04d} [{b1}, {b2}] overlap; both offsets "
                    "apply additively to TOAs in the overlap")
                break

    def add_dmx_range(self, index, mjd_start, mjd_end, value=0.0, frozen=True):
        p = prefixParameter(f"DMX_{index:04d}", "DMX_", index,
                            units="pc cm^-3", frozen=frozen)
        p.value = value
        self.add_param(p)
        r1 = MJDParameter(f"DMXR1_{index:04d}", units="MJD")
        r1.set_mjd(int(mjd_start), (mjd_start % 1) * SECS_PER_DAY)
        self.add_param(r1)
        r2 = MJDParameter(f"DMXR2_{index:04d}", units="MJD")
        r2.set_mjd(int(mjd_end), (mjd_end % 1) * SECS_PER_DAY)
        self.add_param(r2)
        self.dmx_ids.append(index)

    def device_slot(self, pname):
        if pname.startswith("DMX_"):
            return "DMX", self.dmx_ids.index(int(pname[4:]))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        params0["DMX"] = np.array([getattr(self, f"DMX_{i:04d}").value or 0.0
                                   for i in self.dmx_ids], dtype=np.float64)
        mjds = toas.get_mjds()
        masks = np.zeros((len(self.dmx_ids), len(toas)))
        for k, i in enumerate(self.dmx_ids):
            lo = getattr(self, f"DMXR1_{i:04d}").value
            hi = getattr(self, f"DMXR2_{i:04d}").value
            masks[k] = (mjds >= lo) & (mjds <= hi)
        # windows are inclusive on both ends, so a TOA on the shared
        # boundary of abutting bins gets both offsets: report it here,
        # where the TOAs are known
        multi = masks.sum(axis=0) > 1
        if multi.any():
            warnings.warn(
                f"{int(multi.sum())} TOA(s) fall inside more than one "
                "DMX window (inclusive boundaries); the window offsets "
                "apply additively to them")
        prep["dmx_masks"] = masks

    def delay(self, params, batch, prep, delay_accum):
        dm_per_toa = params["DMX"] @ prep["dmx_masks"]
        f2 = torch.square(batch.freq_mhz)
        return torch.where(torch.isfinite(f2), DMconst * dm_per_toa / f2, 0.0)


class DispersionJump(DelayComponent):
    """DMJUMP: per-subset DM offsets applied to wideband DM
    measurements only — no TOA delay (reference:
    dispersion_model.py::DispersionJump). The jump enters the model DM
    negated (the reference's jump_dm sign), so fitted values
    interchange with reference par files."""

    category = "dispersion_jump"
    order = 31

    def __init__(self):
        super().__init__()
        self.dmjump_ids: list[int] = []

    def add_dmjump(self, key="", key_value=(), value=0.0, frozen=False,
                   index=None):
        index = index if index is not None else len(self.dmjump_ids) + 1
        p = maskParameter(f"DMJUMP{index}", "DMJUMP", index,
                          units="pc cm^-3", frozen=frozen)
        p.key = key
        p.key_value = list(key_value)
        p.value = value
        self.add_param(p)
        self.dmjump_ids.append(index)
        return p

    def device_slot(self, pname):
        return "DMJUMP", self.dmjump_ids.index(int(pname[6:]))

    def pack(self, model, toas, prep, params0, device=None):
        vals, masks = pack_mask_values(
            self, [f"DMJUMP{i}" for i in self.dmjump_ids], toas)
        params0["DMJUMP"] = vals
        prep["dmjump_masks"] = masks

    def delay(self, params, batch, prep, delay_accum):
        return torch.zeros_like(batch.tdb_sec)
