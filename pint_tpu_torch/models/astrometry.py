"""Astrometry delay components (Roemer + parallax), torch counterpart of
the JAX package's ``models/astrometry.py``.

(reference: src/pint/models/astrometry.py — AstrometryEquatorial
(RAJ/DECJ/PMRA/PMDEC/PX), AstrometryEcliptic (ELONG/ELAT/PMELONG/
PMELAT/OBL); solar_system_geometric_delay including the parallax
curvature term.)

The device code computes the pulsar unit vector from the *current*
params (so RAJ/DECJ/PM/PX are all differentiable for the design matrix)
and dots it with the packed observatory SSB position in light-seconds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import (ARCSEC_TO_RAD, C_M_S, MASYR_TO_RADS,
                         OBLIQUITY_ARCSEC, PC_M, SECS_PER_DAY)
from .parameter import (AngleParameter, MJDParameter, floatParameter,
                        strParameter)
from .timing_model import DelayComponent, MissingParameter

_LS_PER_PC = PC_M / C_M_S  # light-seconds per parsec


class Astrometry(DelayComponent):
    category = "astrometry"
    order = 10

    def pack(self, model, toas, prep, params0, device=None):
        # seconds since POSEPOCH for proper motion (f64 is ample)
        pe = getattr(self, "POSEPOCH", None)
        if pe is not None and pe.day is not None:
            day, sec = pe.day, pe.sec
        else:
            day, sec = prep["pepoch_day"], prep["pepoch_sec"]
        dt = ((toas.tdb.day - day).astype(np.float64) * SECS_PER_DAY
              + (toas.tdb.sec - sec))
        prep["posepoch_dt"] = dt
        for pname in self.params:
            par = getattr(self, pname)
            if par.kind in ("float", "angle", "prefix"):
                params0[pname] = par.value if par.value is not None else 0.0

    def device_slot(self, pname):
        return pname, None

    def ssb_to_psb_xyz(self, params, prep):
        """Unit vector SSB->pulsar (ICRS) at each TOA; differentiable."""
        raise NotImplementedError

    def psb_xyz_host(self, params0, prep):
        """:meth:`ssb_to_psb_xyz` at pack time, on the host: the
        numpy (n_toa, 3) directions from the packed params0/prep (for
        components whose pack needs the line of sight: DDK, PLSWNoise)."""
        params = {k: torch.as_tensor(np.asarray(v, np.float64))
                  for k, v in params0.items()}
        host = {"posepoch_dt": torch.as_tensor(prep["posepoch_dt"])}
        if "obliquity" in prep:
            host["obliquity"] = prep["obliquity"]
        return self.ssb_to_psb_xyz(params, host).numpy()

    def delay(self, params, batch, prep, delay_accum):
        n = self.ssb_to_psb_xyz(params, prep)  # (ntoa, 3)
        r = batch.obs_pos_ls
        rdotn = torch.sum(r * n, dim=-1)
        d = -rdotn
        px_mas = params.get("PX", 0.0)
        r2 = torch.sum(r * r, dim=-1)
        # parallax curvature: PX [mas] -> distance 1000/PX pc, so
        # 1/d_ls = PX/(1000*ls_per_pc); delay += |r_perp|^2/(2 d)
        inv_d_ls = px_mas / (1000.0 * _LS_PER_PC)
        return d + 0.5 * (r2 - rdotn**2) * inv_d_ls


class AstrometryEquatorial(Astrometry):
    """(reference: astrometry.py::AstrometryEquatorial)"""

    def __init__(self):
        super().__init__()
        self.add_param(AngleParameter("RAJ", units="rad", angle_unit="hourangle",
                                      description="Right ascension (J2000)"))
        self.add_param(AngleParameter("DECJ", units="rad", angle_unit="deg",
                                      description="Declination (J2000)",
                                      aliases=("DEC",)))
        self.add_param(floatParameter("PMRA", units="mas/yr", description="Proper motion in RA*cos(DEC)"))
        self.add_param(floatParameter("PMDEC", units="mas/yr", description="Proper motion in DEC"))
        self.add_param(floatParameter("PX", units="mas", description="Parallax"))
        self.add_param(MJDParameter("POSEPOCH", units="MJD", description="Position epoch"))

    def validate(self):
        if self.RAJ.value is None or self.DECJ.value is None:
            raise MissingParameter("AstrometryEquatorial", "RAJ/DECJ")

    def ssb_to_psb_xyz(self, params, prep):
        dt = prep["posepoch_dt"]
        ra0 = params["RAJ"]
        dec0 = params["DECJ"]
        pmra = params.get("PMRA", 0.0) * MASYR_TO_RADS
        pmdec = params.get("PMDEC", 0.0) * MASYR_TO_RADS
        dec = dec0 + pmdec * dt
        ra = ra0 + pmra * dt / torch.cos(dec0)
        cd = torch.cos(dec)
        return torch.stack([cd * torch.cos(ra), cd * torch.sin(ra),
                            torch.sin(dec)], dim=-1)


class AstrometryEcliptic(Astrometry):
    """(reference: astrometry.py::AstrometryEcliptic — ELONG/ELAT frame)."""

    def __init__(self):
        super().__init__()
        self.add_param(AngleParameter("ELONG", units="rad", angle_unit="deg",
                                      description="Ecliptic longitude",
                                      aliases=("LAMBDA",)))
        self.add_param(AngleParameter("ELAT", units="rad", angle_unit="deg",
                                      description="Ecliptic latitude", aliases=("BETA",)))
        self.add_param(floatParameter("PMELONG", units="mas/yr", aliases=("PMLAMBDA",),
                                      description="PM in ecliptic longitude"))
        self.add_param(floatParameter("PMELAT", units="mas/yr", aliases=("PMBETA",),
                                      description="PM in ecliptic latitude"))
        self.add_param(floatParameter("PX", units="mas", description="Parallax"))
        self.add_param(MJDParameter("POSEPOCH", units="MJD", description="Position epoch"))
        self.add_param(strParameter("ECL", description="Obliquity convention"))
        self.ECL.value = "IERS2010"

    def validate(self):
        if self.ELONG.value is None or self.ELAT.value is None:
            raise MissingParameter("AstrometryEcliptic", "ELONG/ELAT")

    def obliquity_rad(self):
        name = (self.ECL.value or "IERS2010").upper()
        return OBLIQUITY_ARCSEC.get(name, OBLIQUITY_ARCSEC["DEFAULT"]) * ARCSEC_TO_RAD

    def pack(self, model, toas, prep, params0, device=None):
        super().pack(model, toas, prep, params0, device)
        prep["obliquity"] = self.obliquity_rad()

    def ssb_to_psb_xyz(self, params, prep):
        dt = prep["posepoch_dt"]
        eps = prep["obliquity"]
        lon0 = params["ELONG"]
        lat0 = params["ELAT"]
        pml = params.get("PMELONG", 0.0) * MASYR_TO_RADS
        pmb = params.get("PMELAT", 0.0) * MASYR_TO_RADS
        lat = lat0 + pmb * dt
        lon = lon0 + pml * dt / torch.cos(lat0)
        cb = torch.cos(lat)
        x = cb * torch.cos(lon)
        y = cb * torch.sin(lon)
        z = torch.sin(lat)
        # rotate ecliptic -> equatorial ICRS
        ce, se = math.cos(eps), math.sin(eps)
        return torch.stack([x, ce * y - se * z, se * y + ce * z], dim=-1)
