"""Dispersion delay (torch counterpart of the JAX package's
``models/dispersion.py::DispersionDM``).

(reference: src/pint/models/dispersion_model.py — DispersionDM, the DM
Taylor series at DMEPOCH with delay = DMconst*DM/freq^2.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SECS_PER_DAY, SECS_PER_JULIAN_YEAR, DMconst
from .parameter import MJDParameter, prefixParameter
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
