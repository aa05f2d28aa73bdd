"""ELL1 / ELL1H / ELL1k low-eccentricity binary models (torch
counterpart of the JAX package's ``models/binary/ell1.py``).

(reference: src/pint/models/stand_alone_psr_binaries/ELL1_model.py::ELL1model,
ELL1H_model.py::ELL1Hmodel, ELL1k_model.py, wrapper
src/pint/models/binary_ell1.py.)

Lange et al. (2001) expansion in eccentricity around TASC with
EPS1 = e sin(omega), EPS2 = e cos(omega):

  Roemer = x [ sin(Phi) - (EPS1/2) cos(2 Phi) + (EPS2/2) sin(2 Phi) ]
  Shapiro = -2 r ln(1 - SINI sin Phi)

ELL1H replaces (M2, SINI) by orthometric (H3, H4 | STIGMA)
(Freire & Wex 2010): sigma = H4/H3, SINI = 2 sigma/(1+sigma^2),
r = H3/sigma^3.
"""

from __future__ import annotations

import math

import torch

from ...constants import SECS_PER_JULIAN_YEAR, TSUN_S
from ..parameter import MJDParameter, floatParameter
from ..timing_model import MissingParameter
from .base import PulsarBinary, orthometric_shapiro_rs

_DEG2RAD = math.pi / 180.0


class BinaryELL1(PulsarBinary):
    binary_model_name = "ELL1"

    def __init__(self):
        super().__init__()
        self.add_param(MJDParameter("TASC", units="MJD",
                                    description="Epoch of ascending node"))
        self.add_param(floatParameter("EPS1", units="", description="e*sin(omega)"))
        self.add_param(floatParameter("EPS2", units="", description="e*cos(omega)"))
        self.add_param(floatParameter("EPS1DOT", units="1/s"))
        self.add_param(floatParameter("EPS2DOT", units="1/s"))
        self.add_param(floatParameter("M2", units="Msun", description="Companion mass"))
        self.add_param(floatParameter("SINI", units="", description="Sine of inclination"))

    def _epoch_param(self):
        return self.TASC if self.TASC.value is not None else self.T0

    def validate(self):
        if self.TASC.value is None and self.T0.value is None:
            raise MissingParameter("BinaryELL1", "TASC")
        super().validate()

    def eps(self, params, prep, delay_accum):
        dt = prep["orb_dt_hi"] + prep["orb_dt_lo"] - delay_accum
        e1 = params.get("EPS1", 0.0) + params.get("EPS1DOT", 0.0) * dt
        e2 = params.get("EPS2", 0.0) + params.get("EPS2DOT", 0.0) * dt
        return e1, e2

    def shapiro_rs(self, params):
        """(range r [s], shape s) of the Shapiro delay."""
        return TSUN_S * params.get("M2", 0.0), params.get("SINI", 0.0)

    def _ell1_delay_at(self, params, prep, delay_accum):
        phi = self.orbital_phase(params, prep, delay_accum)
        x = self.x_ls(params, prep, delay_accum)
        e1, e2 = self.eps(params, prep, delay_accum)
        roemer = x * (torch.sin(phi)
                      - 0.5 * (e1 * torch.cos(2 * phi) - e2 * torch.sin(2 * phi)))
        r, s = self.shapiro_rs(params)
        shapiro = -2.0 * r * torch.log(1.0 - s * torch.sin(phi))
        return roemer + shapiro

    def delay(self, params, batch, prep, delay_accum):
        # inverse timing formula by fixed point: the reference expands
        # Dre*(1 - nhat*Drep + ...) (ELL1_model.py::delayI); the
        # iteration sums the same series to all orders
        d = self._ell1_delay_at(params, prep, delay_accum)
        d = self._ell1_delay_at(params, prep, delay_accum + d)
        return self._ell1_delay_at(params, prep, delay_accum + d)


class BinaryELL1k(BinaryELL1):
    """ELL1k (reference: ELL1k_model.py): the eccentricity vector
    rotates rigidly with OMDOT and its magnitude evolves as
    e(t) = e0 (1 + LNEDOT dt):

      eps1(t) = (1 + LNEDOT dt) [ eps1 cos(w) + eps2 sin(w) ]
      eps2(t) = (1 + LNEDOT dt) [ eps2 cos(w) - eps1 sin(w) ],
      w = OMDOT * dt.
    """

    binary_model_name = "ELL1K"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("OMDOT", units="deg/yr",
                                      description="Periastron advance rate"))
        self.add_param(floatParameter("LNEDOT", units="1/s",
                                      description="d(ln e)/dt"))
        # the rotation replaces the linearized rates, which would be
        # dead (zero-column) fit parameters here
        self.remove_param("EPS1DOT")
        self.remove_param("EPS2DOT")

    def eps(self, params, prep, delay_accum):
        dt = prep["orb_dt_hi"] + prep["orb_dt_lo"] - delay_accum
        w = (params.get("OMDOT", 0.0) * _DEG2RAD / SECS_PER_JULIAN_YEAR) * dt
        scale = 1.0 + params.get("LNEDOT", 0.0) * dt
        e1, e2 = params.get("EPS1", 0.0), params.get("EPS2", 0.0)
        cw, sw = torch.cos(w), torch.sin(w)
        return scale * (e1 * cw + e2 * sw), scale * (e2 * cw - e1 * sw)


class BinaryELL1H(BinaryELL1):
    binary_model_name = "ELL1H"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("H3", units="s", description="Orthometric amplitude h3"))
        self.add_param(floatParameter("H4", units="s", description="Orthometric amplitude h4"))
        self.add_param(floatParameter("STIGMA", units="", aliases=("VARSIGMA", "STIG"),
                                      description="Orthometric ratio"))

    def shapiro_rs(self, params):
        h3 = params.get("H3", 0.0)
        if self.STIGMA.value is not None:
            sig = params.get("STIGMA", 0.0)
        else:
            # sigma = H4/H3 (Freire & Wex 2010 eq. 25)
            sig = params.get("H4", 0.0) / torch.where(h3 == 0.0, 1.0, h3)
        return orthometric_shapiro_rs(h3, sig)
