"""BT (Blandford & Teukolsky 1976) binary model (torch counterpart of
the JAX package's ``models/binary/bt.py``).

(reference: src/pint/models/stand_alone_psr_binaries/BT_model.py::BTmodel,
wrapper src/pint/models/binary_bt.py::BinaryBT.)

  delay = x sin(om) (cos E - e) + [x cos(om) sqrt(1-e^2) + GAMMA] sin E

with E from Kepler's equation; applied via 2 fixed-point iterations of
the inverse timing formula (delay evaluated at t - delay).
"""

from __future__ import annotations

import torch

from ..parameter import floatParameter
from .base import PulsarBinary, kepler_solve


class BinaryBT(PulsarBinary):
    binary_model_name = "BT"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("ECC", units="", aliases=("E",),
                                      description="Eccentricity"))
        self.add_param(floatParameter("EDOT", units="1/s"))
        self.add_param(floatParameter("OM", units="deg",
                                      description="Longitude of periastron"))
        self.add_param(floatParameter("OMDOT", units="deg/yr"))
        self.add_param(floatParameter("GAMMA", units="s",
                                      description="Einstein delay amplitude"))

    def _bt_delay_at(self, params, prep, delay_accum):
        M = self.orbital_phase(params, prep, delay_accum)
        e = self.ecc(params, prep, delay_accum)
        E = kepler_solve(M, e)
        om = self.omega_rad(params, prep, delay_accum)
        x = self.x_ls(params, prep, delay_accum)
        gamma = params.get("GAMMA", 0.0)
        return (x * torch.sin(om) * (torch.cos(E) - e)
                + (x * torch.cos(om) * torch.sqrt(1.0 - e**2) + gamma)
                * torch.sin(E))

    def delay(self, params, batch, prep, delay_accum):
        # inverse timing formula: evaluate at binary time t - delay
        d = self._bt_delay_at(params, prep, delay_accum)
        d = self._bt_delay_at(params, prep, delay_accum + d)
        return self._bt_delay_at(params, prep, delay_accum + d)


class BinaryBTX(BinaryBT):
    """BTX (reference: BT_model.py BTX mode): the BT orbit
    parameterized by orbital-frequency terms FB0, FB1, ... The FBn
    orbit lives in PulsarBinary.orbital_phase; this subclass fixes the
    name so BINARY BTX par files round-trip."""

    binary_model_name = "BTX"
