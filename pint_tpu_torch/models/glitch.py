"""Pulsar glitches: steps in phase and spin with exponential recovery
(torch counterpart of the JAX package's ``models/glitch.py``).

(reference: src/pint/models/glitch.py::Glitch — prefix families
GLEP_n (epoch), GLPH_n (phase step), GLF0_n/GLF1_n/GLF2_n (permanent
frequency/derivative steps), GLF0D_n + GLTD_n (decaying frequency step
with timescale)).

Phase contribution for each glitch, for t after GLEP (dt in seconds):

    dphi = GLPH + GLF0*dt + GLF1*dt^2/2 + GLF2*dt^3/6
         + GLF0D * tau * (1 - exp(-dt/tau)),  tau = GLTD [days -> s]

Every glitch parameter lives in a flat device vector indexed by glitch,
so each (GLEP too, away from the step) has a design column.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SECS_PER_DAY
from .parameter import MJDParameter, prefixParameter
from .timing_model import MissingParameter, PhaseComponent

_FIELDS = ("GLPH", "GLF0", "GLF1", "GLF2", "GLF0D", "GLTD")
_UNITS = {"GLPH": "pulse phase", "GLF0": "Hz", "GLF1": "Hz/s",
          "GLF2": "Hz/s^2", "GLF0D": "Hz", "GLTD": "d"}


class Glitch(PhaseComponent):
    category = "glitch"
    order = 30

    def __init__(self):
        super().__init__()
        self.glitch_ids: list[int] = []

    def add_glitch(self, index=None):
        index = index if index is not None else len(self.glitch_ids) + 1
        ep = MJDParameter(f"GLEP_{index}", units="MJD",
                          description=f"Epoch of glitch {index}")
        self.add_param(ep)
        for f in _FIELDS:
            p = prefixParameter(f"{f}_{index}", f, index, units=_UNITS[f],
                                description=f"{f} of glitch {index}")
            p.value = 0.0
            self.add_param(p)
        self.glitch_ids.append(index)
        return index

    def validate(self):
        for i in self.glitch_ids:
            if getattr(self, f"GLEP_{i}").value is None:
                raise MissingParameter("Glitch", f"GLEP_{i}")

    def device_slot(self, pname):
        stem, idx = pname.rsplit("_", 1)
        if stem == "GLEP" or stem in _FIELDS:
            return stem, self.glitch_ids.index(int(idx))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        ids = self.glitch_ids
        # GLEP stays in MJD on the device (so a fit writes it back as
        # is); phase() converts it against this packed epoch
        params0["GLEP"] = np.array([getattr(self, f"GLEP_{i}").value
                                    for i in ids], dtype=np.float64)
        prep["glitch_pepoch_mjd"] = (float(prep["pepoch_day"])
                                     + prep["pepoch_sec"] / SECS_PER_DAY)
        for f in _FIELDS:
            params0[f] = np.array([getattr(self, f"{f}_{i}").value or 0.0
                                   for i in ids], dtype=np.float64)

    def phase(self, params, batch, prep, delay_total):
        T = prep["T_hi"] + prep["T_lo"] - delay_total  # (n,)
        ep_s = (params["GLEP"] - prep["glitch_pepoch_mjd"]) * SECS_PER_DAY
        dt = T[..., :, None] - ep_s[..., None, :]        # (n, nglitch)
        on = (dt > 0).to(dt.dtype)
        dtp = torch.where(dt > 0, dt, 0.0)
        tau = params["GLTD"] * SECS_PER_DAY
        # tau = 0 (no decaying term): the guard sits on the divisor, so
        # neither branch of the where divides by zero
        safe_tau = torch.where(tau > 0, tau, 1.0)
        decay = torch.where(tau > 0,
                            params["GLF0D"] * safe_tau
                            * (1.0 - torch.exp(-dtp / safe_tau)), 0.0)
        dphi = (params["GLPH"] + params["GLF0"] * dtp
                + params["GLF1"] * dtp**2 / 2.0
                + params["GLF2"] * dtp**3 / 6.0 + decay)
        return torch.sum(on * dphi, dim=-1)
