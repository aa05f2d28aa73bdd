"""Piecewise spindown segments (torch counterpart of the JAX package's
``models/piecewise.py``).

(reference: src/pint/models/piecewise.py::PiecewiseSpindown
*(version-dependent)* — per-window (PWEP_####, PWSTART_####,
PWSTOP_####) extra spin solutions PWPH/PWF0/PWF1/PWF2_#### added to
the phase inside the window.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SECS_PER_DAY
from .parameter import MJDParameter, prefixParameter
from .timing_model import MissingParameter, PhaseComponent


class PiecewiseSpindown(PhaseComponent):
    category = "piecewise_spindown"
    order = 55

    def __init__(self):
        super().__init__()
        self.pw_ids: list[int] = []

    def add_segment(self, index, start_mjd=None, stop_mjd=None,
                    epoch_mjd=None):
        ep = MJDParameter(f"PWEP_{index:04d}", units="MJD",
                          description="Segment phase epoch")
        if epoch_mjd is not None:
            ep.value = epoch_mjd
        self.add_param(ep)
        r1 = MJDParameter(f"PWSTART_{index:04d}", units="MJD")
        if start_mjd is not None:
            r1.value = start_mjd
        self.add_param(r1)
        r2 = MJDParameter(f"PWSTOP_{index:04d}", units="MJD")
        if stop_mjd is not None:
            r2.value = stop_mjd
        self.add_param(r2)
        for stem, unit in (("PWPH", ""), ("PWF0", "1/s"), ("PWF1", "1/s^2"),
                           ("PWF2", "1/s^3")):
            p = prefixParameter(f"{stem}_{index:04d}", f"{stem}_", index,
                                units=unit)
            p.value = 0.0
            self.add_param(p)
        self.pw_ids.append(index)

    def validate(self):
        for i in self.pw_ids:
            for stem in ("PWSTART", "PWSTOP"):
                if getattr(self, f"{stem}_{i:04d}").value is None:
                    raise MissingParameter(
                        "PiecewiseSpindown", f"{stem}_{i:04d}",
                        "(segment window bounds are required)")

    def device_slot(self, pname):
        stem = pname.split("_")[0]
        if stem in ("PWPH", "PWF0", "PWF1", "PWF2"):
            return stem, self.pw_ids.index(int(pname.split("_")[1]))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        n_seg = len(self.pw_ids)
        for stem in ("PWPH", "PWF0", "PWF1", "PWF2"):
            params0[stem] = np.array(
                [getattr(self, f"{stem}_{i:04d}").value or 0.0
                 for i in self.pw_ids], dtype=np.float64)
        mjd_f = toas.tdb.day + toas.tdb.sec / SECS_PER_DAY
        masks = np.zeros((n_seg, len(toas)))
        dts = np.zeros((n_seg, len(toas)))
        for j, i in enumerate(self.pw_ids):
            lo = getattr(self, f"PWSTART_{i:04d}").value
            hi = getattr(self, f"PWSTOP_{i:04d}").value
            ep = getattr(self, f"PWEP_{i:04d}")
            masks[j] = (mjd_f >= lo) & (mjd_f < hi)
            dts[j] = ((toas.tdb.day - ep.day).astype(np.float64) * SECS_PER_DAY
                      + (toas.tdb.sec - ep.sec))
        prep["pw_masks"] = masks
        prep["pw_dts"] = dts

    def phase(self, params, batch, prep, delay_total):
        dt = prep["pw_dts"] - delay_total[..., None, :]
        ph = (params["PWPH"][..., :, None]
              + params["PWF0"][..., :, None] * dt
              + 0.5 * params["PWF1"][..., :, None] * dt**2
              + params["PWF2"][..., :, None] * dt**3 / 6.0)
        return torch.sum(ph * prep["pw_masks"], dim=-2)
