"""BT_piecewise: BT binary with piecewise-constant T0 and A1 (torch
counterpart of the JAX package's ``models/binary/bt_piecewise.py``).

(reference: src/pint/models/binary_piecewise.py::BinaryBTPiecewise +
stand_alone_psr_binaries/BT_piecewise.py — groups T0X_####/A1X_####
with MJD boundaries XR1_####/XR2_####; TOAs inside a group's window use
that group's T0/A1, TOAs outside every window the global values.)

Group membership is resolved at pack time into a static per-TOA
segment index (the windows never change during a fit); the piece
values T0X/A1X are device vectors indexed by piece, so every piece
parameter is differentiable and fittable, one gather away from the
plain BT path.
"""

from __future__ import annotations

import numpy as np
import torch

from ...constants import SECS_PER_DAY
from ..parameter import MJDParameter, prefixParameter
from ..timing_model import MissingParameter
from .bt import BinaryBT


class BinaryBTPiecewise(BinaryBT):
    binary_model_name = "BT_piecewise"

    def __init__(self):
        super().__init__()
        self.piece_ids: list[int] = []

    def add_piece(self, index=None, mjd_start=None, mjd_end=None,
                  t0x=None, a1x=None, frozen=True):
        """Create piece ``index`` with window [mjd_start, mjd_end].
        Either of ``t0x``/``a1x`` may stay None: the piece then keeps
        the global value for that element."""
        index = index if index is not None else (
            max(self.piece_ids, default=-1) + 1)
        t0p = MJDParameter(f"T0X_{index:04d}", units="MJD", frozen=frozen,
                           description=f"piecewise T0, group {index}")
        if t0x is not None:
            t0p.set_mjd(int(t0x), (t0x % 1) * SECS_PER_DAY)
        self.add_param(t0p)
        a1p = prefixParameter(f"A1X_{index:04d}", "A1X_", index, units="ls",
                              frozen=frozen,
                              description=f"piecewise A1, group {index}")
        if a1x is not None:
            a1p.value = a1x
        self.add_param(a1p)
        r1 = MJDParameter(f"XR1_{index:04d}", units="MJD")
        if mjd_start is not None:
            r1.set_mjd(int(mjd_start), (mjd_start % 1) * SECS_PER_DAY)
        self.add_param(r1)
        r2 = MJDParameter(f"XR2_{index:04d}", units="MJD")
        if mjd_end is not None:
            r2.set_mjd(int(mjd_end), (mjd_end % 1) * SECS_PER_DAY)
        self.add_param(r2)
        self.piece_ids.append(index)
        return index

    def add_prefix_members(self, keys):
        super().add_prefix_members(keys)
        ids = sorted({int(k.split("_")[1]) for k in keys
                      if k.split("_")[0] in ("T0X", "A1X", "XR1", "XR2")
                      and k.split("_")[-1].isdigit()})
        for i in ids:
            self.add_piece(i)

    def validate(self):
        super().validate()
        for i in self.piece_ids:
            r1 = getattr(self, f"XR1_{i:04d}").value
            r2 = getattr(self, f"XR2_{i:04d}").value
            if r1 is None or r2 is None or not r1 < r2:
                raise MissingParameter(
                    "BinaryBTPiecewise", f"XR1_{i:04d}/XR2_{i:04d}",
                    f"piece {i} needs a non-empty MJD window "
                    f"(got [{r1}, {r2}])")
        # overlapping windows make the piece assignment order-dependent
        wins = sorted((getattr(self, f"XR1_{i:04d}").value,
                       getattr(self, f"XR2_{i:04d}").value, i)
                      for i in self.piece_ids)
        for (lo1, hi1, i1), (lo2, hi2, i2) in zip(wins, wins[1:]):
            if lo2 < hi1:
                raise ValueError(
                    f"BT_piecewise windows {i1} [{lo1},{hi1}] and "
                    f"{i2} [{lo2},{hi2}] overlap")

    def device_slot(self, pname):
        stem = pname.split("_")[0]
        if stem in ("T0X", "A1X") and pname.split("_")[-1].isdigit():
            return stem, self.piece_ids.index(int(pname.split("_")[1]))
        return super().device_slot(pname)

    def pack(self, model, toas, prep, params0, device=None):
        super().pack(model, toas, prep, params0, device)
        ids = self.piece_ids
        t0_global = self.T0.value
        a1_global = self.A1.value
        n = max(len(ids), 1)
        t0x = np.full(n, t0_global, dtype=np.float64)
        a1x = np.full(n, a1_global, dtype=np.float64)
        has_t0 = np.zeros(n, dtype=bool)
        has_a1 = np.zeros(n, dtype=bool)
        mjds = toas.get_mjds()
        seg = np.full(len(toas), -1, dtype=np.int32)
        for k, i in enumerate(ids):
            tp = getattr(self, f"T0X_{i:04d}")
            ap = getattr(self, f"A1X_{i:04d}")
            has_t0[k] = tp.value is not None
            has_a1[k] = ap.value is not None
            t0x[k] = tp.value if has_t0[k] else t0_global
            a1x[k] = ap.value if has_a1[k] else a1_global
            lo = getattr(self, f"XR1_{i:04d}").value
            hi = getattr(self, f"XR2_{i:04d}").value
            # half-open [lo, hi): a TOA on a shared boundary of touching
            # windows belongs to one piece
            seg[(mjds >= lo) & (mjds < hi)] = k
        params0["T0X"] = t0x
        params0["A1X"] = a1x
        # the base pack published each member as a scalar leaf; the
        # device reads only the packed vectors
        for i in ids:
            for stem in ("T0X", "A1X", "XR1", "XR2"):
                params0.pop(f"{stem}_{i:04d}", None)
        prep["btpw_seg"] = seg
        prep["btpw_has_t0"] = has_t0
        prep["btpw_has_a1"] = has_a1

    def delay(self, params, batch, prep, delay_accum):
        if not self.piece_ids:
            return super().delay(params, batch, prep, delay_accum)
        seg = prep["btpw_seg"]
        safe = torch.clamp(seg, min=0)
        in_piece = seg >= 0
        # per-TOA effective elements: a piece that never set T0X/A1X
        # follows the (possibly fitted) global parameter
        eff = dict(params)
        eff["T0"] = torch.where(in_piece & prep["btpw_has_t0"][safe],
                                params["T0X"][safe], params["T0"])
        eff["A1"] = torch.where(in_piece & prep["btpw_has_a1"][safe],
                                params["A1X"][safe], params["A1"])
        return super().delay(eff, batch, prep, delay_accum)
