"""DD (Damour & Deruelle 1986) binary model family: DD, DDS, DDH, DDGR
and DDK (torch counterpart of the JAX package's ``models/binary/dd.py``).

(reference: src/pint/models/stand_alone_psr_binaries/DD_model.py::DDmodel,
DDS_model.py, DDGR_model.py, DDK_model.py; wrappers binary_dd.py,
binary_ddk.py.)

Roemer with e_r/e_theta, Einstein (GAMMA sin u), Shapiro (M2/SINI log
term), aberration (A0/B0), with periastron advance applied through the
true anomaly. DDS: SINI = 1 - exp(-SHAPMAX). DDH: orthometric Shapiro.
DDGR: the post-Keplerian parameters from (MTOT, M2) by the GR
relations. DDK: Kopeikin annual-orbital parallax and proper-motion
terms from KIN/KOM and the packed observatory positions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...constants import (C_M_S, MASYR_TO_RADS, PC_M, SECS_PER_DAY,
                          SECS_PER_JULIAN_YEAR, TSUN_S)
from ..parameter import floatParameter
from ..timing_model import MissingParameter
from .base import PulsarBinary, _TWO_PI, kepler_solve, orthometric_shapiro_rs

_DEG2RAD = math.pi / 180.0


class BinaryDD(PulsarBinary):
    binary_model_name = "DD"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("ECC", units="", aliases=("E",)))
        self.add_param(floatParameter("EDOT", units="1/s"))
        self.add_param(floatParameter("OM", units="deg"))
        self.add_param(floatParameter("OMDOT", units="deg/yr"))
        self.add_param(floatParameter("GAMMA", units="s"))
        self.add_param(floatParameter("M2", units="Msun"))
        self.add_param(floatParameter("SINI", units=""))
        self.add_param(floatParameter("DR", units=""))
        self.add_param(floatParameter("DTH", units=""))
        self.add_param(floatParameter("A0", units="s", description="Aberration A0"))
        self.add_param(floatParameter("B0", units="s", description="Aberration B0"))

    def sini(self, params):
        return params.get("SINI", 0.0)

    def shapiro_rs(self, params):
        """(range r [s], shape s) of the Shapiro delay — the hook DDH
        overrides with the orthometric parameterization."""
        return TSUN_S * params.get("M2", 0.0), self.sini(params)

    def _dd_delay_at(self, params, prep, delay_accum):
        M = self.orbital_phase(params, prep, delay_accum)
        e = self.ecc(params, prep, delay_accum)
        u = kepler_solve(M, e)
        su, cu = torch.sin(u), torch.cos(u)
        # true anomaly
        nu = 2.0 * torch.arctan2(torch.sqrt(1.0 + e) * torch.sin(u / 2.0),
                                 torch.sqrt(1.0 - e) * torch.cos(u / 2.0))
        om = self.omega_rad(params, prep, delay_accum, nu=nu)
        so, co = torch.sin(om), torch.cos(om)
        x = self.x_ls(params, prep, delay_accum)
        er = e * (1.0 + params.get("DR", 0.0))
        eth = e * (1.0 + params.get("DTH", 0.0))
        # Roemer + Einstein (DD86 eq. 46-52)
        alpha = x * so
        beta = x * torch.sqrt(1.0 - eth**2) * co
        roemer = alpha * (cu - er) + beta * su
        einstein = params.get("GAMMA", 0.0) * su
        # Shapiro (DD86 eq. 26)
        r, s = self.shapiro_rs(params)
        shapiro = -2.0 * r * torch.log(1.0 - e * cu
                                       - s * (so * (cu - e)
                                              + torch.sqrt(1.0 - e**2) * co * su))
        # aberration (DD86 eq. 27)
        a0 = params.get("A0", 0.0)
        b0 = params.get("B0", 0.0)
        aberr = (a0 * (torch.sin(om + nu) + e * so)
                 + b0 * (torch.cos(om + nu) + e * co))
        return roemer + einstein + shapiro + aberr

    def delay(self, params, batch, prep, delay_accum):
        d = self._dd_delay_at(params, prep, delay_accum)
        d = self._dd_delay_at(params, prep, delay_accum + d)
        return self._dd_delay_at(params, prep, delay_accum + d)


class BinaryDDGR(BinaryDD):
    """DDGR: GR-constrained DD (reference: DDGR_model.py::DDGRmodel).

    OMDOT, GAMMA, PBDOT, SINI, DR and DTH follow from the total mass
    MTOT and the companion mass M2 by the GR relations (Damour &
    Deruelle 1986; Taylor & Weisberg 1989); XOMDOT/XPBDOT are additive
    excess terms. The design matrix in MTOT/M2 flows through these
    relations by forward-mode autodiff."""

    binary_model_name = "DDGR"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("MTOT", units="Msun", aliases=("M",),
                                      description="Total system mass"))
        self.add_param(floatParameter("XOMDOT", units="deg/yr",
                                      description="Excess periastron advance"))
        self.add_param(floatParameter("XPBDOT", units="s/s",
                                      description="Excess orbital period decay"))

    def validate(self):
        super().validate()
        if self.MTOT.value is None:
            raise MissingParameter("BinaryDDGR", "MTOT")
        if self.M2.value is None:
            raise MissingParameter("BinaryDDGR", "M2")

    def _gr_params(self, params, prep):
        """Derived PK parameters from (MTOT, M2), masses in Msun via
        TSUN_S."""
        M = params["MTOT"]
        m2 = params["M2"]
        m1 = M - m2
        e = params.get("ECC", 0.0)
        if prep["orb_mode_fb"]:
            n = _TWO_PI * params["FB"][..., 0]
        else:
            n = _TWO_PI / (params["PB"] * SECS_PER_DAY)
        u2 = (TSUN_S * M * n) ** (2.0 / 3.0)  # (GM n / c^3)^(2/3)
        k = 3.0 * u2 / (1.0 - e**2)  # periastron advance per radian of nu
        gamma = (e * (TSUN_S ** (2.0 / 3.0)) * n ** (-1.0 / 3.0)
                 * m2 * (m1 + 2.0 * m2) * M ** (-4.0 / 3.0))
        pbdot = (-(192.0 * math.pi / 5.0) * (TSUN_S * n) ** (5.0 / 3.0)
                 * m1 * m2 * M ** (-1.0 / 3.0)
                 * (1.0 + (73.0 / 24.0) * e**2 + (37.0 / 96.0) * e**4)
                 * (1.0 - e**2) ** (-3.5))
        sini = (params["A1"] * n ** (2.0 / 3.0) * M ** (2.0 / 3.0)
                / (TSUN_S ** (1.0 / 3.0) * m2))
        dr = (3.0 * m1**2 + 6.0 * m1 * m2 + 2.0 * m2**2) / M**2 * u2
        dth = (3.5 * m1**2 + 6.0 * m1 * m2 + 2.0 * m2**2) / M**2 * u2
        return {"k": k, "GAMMA": gamma, "PBDOT": pbdot, "SINI": sini,
                "DR": dr, "DTH": dth, "n": n}

    def _merged(self, params, prep):
        if "_GR_MERGED" in params:
            return params
        gr = self._gr_params(params, prep)
        # omega advances by k per radian of true anomaly; omega_rad
        # applies OMDOT/n_orb * nu, so the effective OMDOT is k*n
        # (+ excess XOMDOT)
        omdot = (gr["k"] * gr["n"] * SECS_PER_JULIAN_YEAR / _DEG2RAD
                 + params.get("XOMDOT", 0.0))
        out = dict(params)
        out.update(GAMMA=gr["GAMMA"], SINI=gr["SINI"], DR=gr["DR"],
                   DTH=gr["DTH"], OMDOT=omdot,
                   PBDOT=params.get("PBDOT", 0.0) + gr["PBDOT"]
                   + params.get("XPBDOT", 0.0))
        out["_GR_MERGED"] = True
        return out

    def orbital_phase(self, params, prep, delay_accum):
        return super().orbital_phase(self._merged(params, prep), prep,
                                     delay_accum)

    def _dd_delay_at(self, params, prep, delay_accum):
        return super()._dd_delay_at(self._merged(params, prep), prep,
                                    delay_accum)


class BinaryDDS(BinaryDD):
    """DDS: high-inclination reparameterization SHAPMAX = -ln(1-SINI)
    (reference: DDS_model.py::DDSmodel)."""

    binary_model_name = "DDS"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("SHAPMAX", units=""))

    def sini(self, params):
        return 1.0 - torch.exp(-params["SHAPMAX"])


class BinaryDDH(BinaryDD):
    """DDH: DD with the orthometric Shapiro parameterization (H3 +
    STIGMA, or H3 + H4 with sigma = H4/H3) of Freire & Wex 2010 in
    place of (M2, SINI), which are removed: the delay never reads them
    (reference: binary_dd.py::BinaryDDH / DDH_model.py)."""

    binary_model_name = "DDH"

    def __init__(self):
        super().__init__()
        self.remove_param("M2")
        self.remove_param("SINI")
        self.add_param(floatParameter(
            "H3", units="s", description="Orthometric amplitude h3"))
        self.add_param(floatParameter(
            "H4", units="s", description="Orthometric amplitude h4"))
        self.add_param(floatParameter(
            "STIGMA", units="", aliases=("VARSIGMA", "STIG"),
            description="Orthometric ratio"))

    def validate(self):
        super().validate()
        if self.H3.value is None:
            raise MissingParameter("BinaryDDH", "H3")
        if self.STIGMA.value is None and self.H4.value is None:
            raise MissingParameter(
                "BinaryDDH", "STIGMA",
                "DDH needs STIGMA (or H4, for sigma = H4/H3) with H3")

    def _stigma(self, params):
        if self.STIGMA.value is not None:
            return params.get("STIGMA", 0.0)
        h3 = params.get("H3", 0.0)
        return params.get("H4", 0.0) / torch.where(h3 == 0.0, 1.0, h3)

    def shapiro_rs(self, params):
        return orthometric_shapiro_rs(params.get("H3", 0.0),
                                      self._stigma(params))

    def sini(self, params):
        return self.shapiro_rs(params)[1]


class BinaryDDK(BinaryDD):
    """DDK: Kopeikin annual-orbital parallax + proper-motion terms
    (reference: DDK_model.py::DDKmodel; params KIN, KOM).

    x and omega acquire secular drifts from proper motion and annual
    terms from the observatory's SSB orbit projected on the sky basis
    (east, north); both need KIN/KOM and PX from astrometry."""

    binary_model_name = "DDK"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("KIN", units="deg", description="Inclination"))
        self.add_param(floatParameter("KOM", units="deg",
                                      description="Long. of ascending node"))
        self.add_param(floatParameter("K96", units="", description="Apply K96 PM terms"))

    def sini(self, params):
        return torch.sin(params["KIN"] * _DEG2RAD)

    def pack(self, model, toas, prep, params0, device=None):
        super().pack(model, toas, prep, params0, device)
        # sky basis for the Kopeikin terms: unit vectors east and north
        # at the reference position (host f64, as the JAX package)
        astrom = next(c for c in model.delay_components()
                      if c.category == "astrometry")
        n = astrom.psb_xyz_host(params0, prep)[0]
        zhat = np.array([0.0, 0.0, 1.0])
        east = np.cross(zhat, n)
        east /= np.linalg.norm(east)
        north = np.cross(n, east)
        prep["ddk_east"] = east
        prep["ddk_north"] = north
        # proper motion [rad/s] in (east, north)
        pm_e = (model.PMRA.value or 0.0) if "PMRA" in model.params else (
            model.PMELONG.value or 0.0)
        pm_n = (model.PMDEC.value or 0.0) if "PMDEC" in model.params else (
            model.PMELAT.value or 0.0)
        prep["ddk_pm_e"] = pm_e * MASYR_TO_RADS
        prep["ddk_pm_n"] = pm_n * MASYR_TO_RADS
        px = model.PX.value if "PX" in model.params and model.PX.value else 0.0
        prep["ddk_dist_ls"] = (1000.0 / px * PC_M / C_M_S) if px else np.inf
        # observatory SSB positions [ls], packed so the Kopeikin terms
        # need no TOA batch
        if toas.ssb_obs is None:
            toas.compute_posvels()
        prep["ddk_obs_ls"] = toas.ssb_obs.pos / C_M_S

    def _kopeikin_xom(self, params, prep, delay_accum):
        """(delta_x, delta_omega) from proper motion + annual parallax."""
        kin = params["KIN"] * _DEG2RAD
        kom = params["KOM"] * _DEG2RAD
        sk, ck = torch.sin(kom), torch.cos(kom)
        x = params["A1"]
        dt = prep["orb_dt_hi"] + prep["orb_dt_lo"] - delay_accum
        mu_e, mu_n = prep["ddk_pm_e"], prep["ddk_pm_n"]
        cot_i = torch.cos(kin) / torch.sin(kin)
        csc_i = 1.0 / torch.sin(kin)
        # K96 proper-motion secular terms (Kopeikin 1996 eq. 10-11)
        dx_pm = x * cot_i * (-mu_e * sk + mu_n * ck) * dt
        dom_pm = csc_i * (mu_e * ck + mu_n * sk) * dt
        # annual-orbital parallax (Kopeikin 1995 eq. 15-16)
        robs = prep["ddk_obs_ls"]  # [ls]
        d_ls = prep["ddk_dist_ls"]
        de = torch.sum(robs * prep["ddk_east"], dim=-1) / d_ls
        dn = torch.sum(robs * prep["ddk_north"], dim=-1) / d_ls
        dx_px = x * cot_i * (de * sk - dn * ck)
        dom_px = -csc_i * (de * ck + dn * sk)
        return dx_pm + dx_px, dom_pm + dom_px

    def x_ls(self, params, prep, delay_accum):
        dx, _ = self._kopeikin_xom(params, prep, delay_accum)
        return super().x_ls(params, prep, delay_accum) + dx

    def omega_rad(self, params, prep, delay_accum, nu=None):
        _, dom = self._kopeikin_xom(params, prep, delay_accum)
        return super().omega_rad(params, prep, delay_accum, nu=nu) + dom
