"""Explicit overall phase offset (torch counterpart of the JAX
package's ``models/phase_offset.py``).

(reference: src/pint/models/phase_offset.py::PhaseOffset — PHOFF; the
explicit alternative to the implicit 'Offset' design-matrix column.
When PHOFF is free, the design matrix drops the implicit column.)
"""

from __future__ import annotations

import torch

from .parameter import floatParameter
from .timing_model import PhaseComponent


class PhaseOffset(PhaseComponent):
    category = "phase_offset"
    order = 45

    def __init__(self):
        super().__init__()
        p = floatParameter("PHOFF", units="pulse phase",
                           description="Overall phase offset")
        p.value = 0.0
        self.add_param(p)

    def device_slot(self, pname):
        return "PHOFF", None

    def pack(self, model, toas, prep, params0, device=None):
        params0["PHOFF"] = self.PHOFF.value or 0.0

    def phase(self, params, batch, prep, delay_total):
        return -params["PHOFF"] * torch.ones_like(prep["T_hi"])
