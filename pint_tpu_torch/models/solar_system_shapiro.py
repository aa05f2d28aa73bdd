"""Solar-system Shapiro delay (torch counterpart of the JAX package's
``models/solar_system_shapiro.py``).

(reference: src/pint/models/solar_system_shapiro.py::SolarSystemShapiro
— ln-term delay from the Sun, plus planets when PLANET_SHAPIRO is set
and planet posvels were computed.)
"""

from __future__ import annotations

import torch

from ..constants import AU_LS, GM_C3_S, TSUN_S
from .parameter import boolParameter
from .timing_model import DelayComponent

_PLANET_ORDER = ("venus", "mars", "jupiter", "saturn", "uranus", "neptune")


class SolarSystemShapiro(DelayComponent):
    category = "solar_system_shapiro"
    order = 20

    def __init__(self):
        super().__init__()
        p = boolParameter("PLANET_SHAPIRO", description="Include planetary Shapiro delays")
        p.value = False
        self.add_param(p)

    def device_slot(self, pname):
        raise KeyError(pname)  # no fittable params

    def pack(self, model, toas, prep, params0, device=None):
        prep["planet_shapiro"] = bool(self.PLANET_SHAPIRO.value) and bool(toas.planet_pos)

    @staticmethod
    def _body_delay(body_pos_ls, psr_dir, gm_c3):
        """-2 GM/c^3 * ln((r - r.n)/AU): standard log Shapiro term."""
        r = torch.linalg.norm(body_pos_ls, dim=-1)
        rcos = torch.sum(body_pos_ls * psr_dir, dim=-1)
        return -2.0 * gm_c3 * torch.log((r - rcos) / AU_LS)

    def delay(self, params, batch, prep, delay_accum):
        astrom = next((c for c in self._parent.delay_components()
                       if c.category == "astrometry"), None)
        if astrom is None:
            return torch.zeros_like(batch.tdb_sec)
        n = astrom.ssb_to_psb_xyz(params, prep)
        d = self._body_delay(batch.obs_sun_ls, n, TSUN_S)
        if prep.get("planet_shapiro"):
            for k, name in enumerate(_PLANET_ORDER):
                d = d + self._body_delay(batch.planet_pos_ls[k], n, GM_C3_S[name])
        return d
