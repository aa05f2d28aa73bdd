"""Tabulated phase offsets (IFUNC) (torch counterpart of the JAX
package's ``models/ifunc.py``).

(reference: src/pint/models/ifunc.py::IFunc — SIFUNC selects the
interpolation mode (0 = constant, 2 = linear), IFUNC1..n are
(MJD, value_s) pairs; phase += F0 * interp(t).)

The node MJDs are packed static; the values are device parameters, so
each IFUNCn is fittable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SECS_PER_DAY
from .parameter import intParameter, pairParameter
from .timing_model import PhaseComponent


class IFunc(PhaseComponent):
    category = "ifunc"
    order = 37

    def __init__(self):
        super().__init__()
        p = intParameter("SIFUNC", description="IFUNC interpolation mode (0|2)")
        p.value = 2
        self.add_param(p)
        self.if_ids: list[int] = []

    def add_ifunc(self, index=None, mjd=0.0, value=0.0):
        index = index if index is not None else len(self.if_ids) + 1
        p = pairParameter(f"IFUNC{index}", "IFUNC", index, units="(MJD, s)",
                          description=f"IFUNC node {index}")
        p.value = (mjd, value)
        self.add_param(p)
        self.if_ids.append(index)
        return index

    def validate(self):
        if self.if_ids and self.SIFUNC.value not in (0, 2):
            raise ValueError(f"unsupported SIFUNC {self.SIFUNC.value} (0|2)")

    def device_slot(self, pname):
        if pname.startswith("IFUNC"):
            return "IFUNC", self.if_ids.index(int(pname[5:]))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        nodes = np.array([getattr(self, f"IFUNC{i}").value for i in self.if_ids],
                         dtype=np.float64)
        # params stay in if_ids order (device_slot indexes that order);
        # a static permutation orders the nodes by MJD on the device
        params0["IFUNC"] = nodes[:, 1] if len(nodes) else np.zeros(0)
        order = np.argsort(nodes[:, 0]) if len(nodes) else np.arange(0)
        prep["ifunc_sortidx"] = np.asarray(order, dtype=np.int32)
        prep["ifunc_mjd"] = nodes[order, 0] if len(nodes) else np.zeros(0)
        prep["ifunc_t"] = (toas.tdb.day.astype(np.float64)
                           + toas.tdb.sec / SECS_PER_DAY)
        prep["ifunc_mode"] = int(self.SIFUNC.value or 2)

    def phase(self, params, batch, prep, delay_total):
        if params["IFUNC"].shape[-1] == 0:
            return torch.zeros_like(prep["ifunc_t"])
        vals = params["IFUNC"][prep["ifunc_sortidx"]]
        x = prep["ifunc_mjd"]
        t = prep["ifunc_t"]
        if prep["ifunc_mode"] == 0:
            idx = torch.clamp(torch.searchsorted(x, t) - 1, 0, vals.shape[-1] - 1)
            off_s = vals[idx]
        else:
            # linear interpolation, clamped at the ends
            j = torch.clamp(torch.searchsorted(x, t), 1, vals.shape[-1] - 1)
            x0, x1 = x[j - 1], x[j]
            w = torch.clamp((t - x0) / torch.where(x1 > x0, x1 - x0, 1.0),
                            0.0, 1.0)
            off_s = (1.0 - w) * vals[j - 1] + w * vals[j]
        return params["F"][..., 0] * off_s
