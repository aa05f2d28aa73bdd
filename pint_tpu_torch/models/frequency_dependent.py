"""Frequency-dependent (profile evolution) delays (torch counterpart of
the JAX package's ``models/frequency_dependent.py``).

(reference: src/pint/models/frequency_dependent.py::FD — FD1..FDn;
delay = sum_i FDi * log(freq/1 GHz)^i, FDi in seconds; and
src/pint/models/fdjump.py::FDJump — system-dependent FD<n>JUMP mask
parameters with the FDJUMPLOG basis convention.)
"""

from __future__ import annotations

import numpy as np
import torch

from .parameter import (boolParameter, maskParameter, pack_mask_values,
                        prefixParameter)
from .timing_model import DelayComponent


class FD(DelayComponent):
    category = "frequency_dependent"
    order = 40

    def __init__(self):
        super().__init__()
        self.fd_ids: list[int] = []

    def add_fd(self, index=None):
        index = index if index is not None else len(self.fd_ids) + 1
        p = prefixParameter(f"FD{index}", "FD", index, units="s",
                            description=f"FD delay term, log(GHz)^{index}")
        p.value = 0.0
        self.add_param(p)
        self.fd_ids.append(index)
        return index

    def device_slot(self, pname):
        return "FD", self.fd_ids.index(int(pname[2:]))

    def pack(self, model, toas, prep, params0, device=None):
        params0["FD"] = np.array([getattr(self, f"FD{i}").value or 0.0
                                  for i in self.fd_ids], dtype=np.float64)

    def delay(self, params, batch, prep, delay_accum):
        logf = torch.log(batch.freq_mhz / 1000.0)  # log(freq/GHz)
        logf = torch.where(torch.isfinite(logf), logf, 0.0)
        out = torch.zeros_like(logf)
        lp = logf
        for i in range(params["FD"].shape[-1]):
            out = out + params["FD"][..., i] * lp
            lp = lp * logf
        return torch.where(torch.isfinite(batch.freq_mhz), out, 0.0)


class FDJump(DelayComponent):
    """System-dependent profile-frequency-evolution jumps
    (reference: src/pint/models/fdjump.py::FDJump).

    ``FD<n>JUMP <mask> <value>`` adds ``value * b(nu)^n`` seconds of
    delay to mask-selected TOAs, with ``b = log(nu / 1 GHz)`` when
    ``FDJUMPLOG`` is true (PINT's FD convention, the default) or
    ``b = nu / 1 GHz`` when false (tempo2's linear convention)."""

    category = "fdjump"
    order = 41

    def __init__(self):
        super().__init__()
        # parallel lists over mask-parameter slots
        self.fdjump_names: list[str] = []
        self.fdjump_orders: list[int] = []
        p = boolParameter("FDJUMPLOG",
                          description="log-frequency FDJUMP basis (Y) "
                                      "vs linear tempo2 basis (N)")
        p.value = True
        self.add_param(p)

    def add_fdjump(self, n, key="", key_value=(), value=0.0, frozen=False):
        """Add one FD<n>JUMP mask parameter (order n >= 1)."""
        n = int(n)
        if n < 1:
            raise ValueError(f"FDJUMP order must be >= 1, got {n}")
        seq = sum(1 for o in self.fdjump_orders if o == n) + 1
        name = f"FD{n}JUMP{seq}"
        p = maskParameter(name, f"FD{n}JUMP", seq, units="s", frozen=frozen)
        p.key = key
        p.key_value = list(key_value)
        p.value = value
        self.add_param(p)
        self.fdjump_names.append(name)
        self.fdjump_orders.append(int(n))
        return p

    def device_slot(self, pname):
        return "FDJUMP", self.fdjump_names.index(pname)

    def pack(self, model, toas, prep, params0, device=None):
        vals, masks = pack_mask_values(self, self.fdjump_names, toas)
        params0["FDJUMP"] = vals
        prep["fdjump_masks"] = masks
        # the orders choose the basis powers: static host ints
        prep["fdjump_orders"] = tuple(int(n) for n in self.fdjump_orders)
        prep["fdjump_log"] = bool(self.FDJUMPLOG.value)

    def delay(self, params, batch, prep, delay_accum):
        vals = params["FDJUMP"]
        if vals.shape[-1] == 0:
            return torch.zeros_like(batch.freq_mhz)
        nu = batch.freq_mhz / 1000.0  # GHz
        if prep["fdjump_log"]:
            b = torch.log(nu)
            b = torch.where(torch.isfinite(b), b, 0.0)
        else:
            b = torch.where(torch.isfinite(nu), nu, 0.0)
        basis = torch.stack([b ** n for n in prep["fdjump_orders"]])  # (P, N)
        out = (vals[..., :, None] * prep["fdjump_masks"] * basis).sum(dim=-2)
        return torch.where(torch.isfinite(batch.freq_mhz), out, 0.0)
