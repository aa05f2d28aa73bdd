"""Binary component base: orbital phase with host-reference precision
(torch counterpart of the JAX package's ``models/binary/base.py``).

(reference: src/pint/models/pulsar_binary.py::PulsarBinary +
stand_alone_psr_binaries/binary_generic.py::PSR_BINARY and
binary_orbits.py::OrbitPB/OrbitFBX.)

The host packs the orbit count n_orb(t) at the reference parameters in
longdouble, as an exact (int, frac) pair like the spindown phi_ref; the
device adds only exact small deltas in f64 — the parameter shifts
(near-equal subtractions) and the accumulated delay shift — so the mean
anomaly keeps its precision for wide orbits over decade spans. Counting
the orbits in f64 instead would lose ~1e-6 orbits over ten years.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...constants import SECS_PER_DAY, SECS_PER_JULIAN_YEAR
from ...mjd import LD
from ..parameter import MJDParameter, floatParameter, prefixParameter
from ..timing_model import DelayComponent, MissingParameter

_DEG2RAD = math.pi / 180.0
_TWO_PI = 2.0 * math.pi


class PulsarBinary(DelayComponent):
    category = "pulsar_system"
    order = 40
    binary_model_name = "base"

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("PB", units="d", description="Orbital period"))
        self.add_param(floatParameter("PBDOT", units="s/s", description="Orbital period derivative"))
        self.add_param(floatParameter("A1", units="ls", description="Projected semi-major axis"))
        self.add_param(floatParameter("A1DOT", units="ls/s", aliases=("XDOT",),
                                      description="Rate of change of A1"))
        self.add_param(MJDParameter("T0", units="MJD", description="Epoch of periastron"))
        self.fb_ids: list[int] = []

    def add_prefix_members(self, keys):
        """Add FBn orbital-frequency terms found in the par file."""
        i = 0
        while f"FB{i}" in keys:
            p = prefixParameter(f"FB{i}", "FB", i, units=f"1/s^{i+1}")
            self.add_param(p)
            self.fb_ids.append(i)
            i += 1

    def device_slot(self, pname):
        if pname.startswith("FB") and pname[2:].isdigit():
            return "FB", self.fb_ids.index(int(pname[2:]))
        return pname, None

    def _epoch_param(self):
        """The orbital reference epoch parameter (T0 or TASC)."""
        return self.T0

    def validate(self):
        if self.A1.value is None:
            raise MissingParameter(type(self).__name__, "A1")
        if not self.fb_ids and self.PB.value is None:
            raise MissingParameter(type(self).__name__, "PB (or FB0)")
        if self._epoch_param().value is None:
            raise MissingParameter(type(self).__name__,
                                   self._epoch_param().name)

    # ---- host pack ----

    def pack(self, model, toas, prep, params0, device=None):
        ep = self._epoch_param()
        dt_hi = (toas.tdb.day - ep.day).astype(np.float64) * SECS_PER_DAY
        dt_lo = toas.tdb.sec - ep.sec
        prep["orb_dt_hi"] = dt_hi
        prep["orb_dt_lo"] = dt_lo
        dt_ld = LD(dt_hi) + LD(dt_lo)
        pbdot = self.PBDOT.value or 0.0
        if self.fb_ids:
            fb = np.array([getattr(self, f"FB{i}").value or 0.0
                           for i in self.fb_ids])
            params0["FB"] = fb
            prep["FB_ref"] = fb.copy()
            norb = np.zeros_like(dt_ld)
            fact = LD(1.0)
            for i, f in enumerate(fb):
                fact = fact * LD(i + 1)
                norb = norb + LD(f) * dt_ld ** (i + 1) / fact
            prep["orb_mode_fb"] = True
        else:
            pb_s = LD(self.PB.value) * LD(SECS_PER_DAY)
            phi = dt_ld / pb_s
            norb = phi - LD(0.5) * LD(pbdot) * phi * phi
            prep["orb_mode_fb"] = False
        n_int = np.floor(norb + LD(0.5))
        prep["norb_ref_frac"] = (norb - n_int).astype(np.float64)
        prep["norb_ref_int"] = n_int.astype(np.float64)
        prep["PB_ref"] = np.asarray(self.PB.value or 0.0, np.float64)
        prep["PBDOT_ref"] = np.asarray(pbdot, np.float64)
        prep["T0_ref"] = np.asarray(ep.value, np.float64)
        for pname in self.params:
            par = getattr(self, pname)
            if pname.startswith("FB"):
                continue
            params0[pname] = par.value if par.value is not None else 0.0

    # ---- device orbital phase ----

    def orbital_phase(self, params, prep, delay_accum):
        """Mean orbital phase [rad], exact modulo 2 pi
        (reference: binary_orbits.py::OrbitPB.orbit_phase / OrbitFBX)."""
        dt = prep["orb_dt_hi"] + prep["orb_dt_lo"]  # f64 collapse, ~8e-6 s err
        frac = prep["norb_ref_frac"]
        ep_name = self._epoch_param().name
        d_epoch_s = (params[ep_name] - prep["T0_ref"]) * SECS_PER_DAY
        teff_shift = -(delay_accum + d_epoch_s)  # binary time minus ref time
        if prep["orb_mode_fb"]:
            FB = params["FB"]
            FB_ref = prep["FB_ref"]
            dnorb = torch.zeros_like(dt)
            fact = 1.0
            tp = dt
            for i in range(FB.shape[-1]):
                fact *= i + 1
                dnorb = dnorb + (FB[..., i] - FB_ref[..., i]) * tp / fact
                tp = tp * dt
            # instantaneous orbital frequency for the time-shift term
            f_orb = torch.zeros_like(dt)
            fact = 1.0
            tp = torch.ones_like(dt)
            for i in range(FB.shape[-1]):
                if i > 0:
                    fact *= i
                f_orb = f_orb + FB[..., i] * tp / fact
                tp = tp * dt
            dnorb = dnorb + f_orb * teff_shift
        else:
            pb_ref_s = prep["PB_ref"] * SECS_PER_DAY
            pb_s = params["PB"] * SECS_PER_DAY
            # (1/PB - 1/PB_ref), exact for near-equal values
            dinv = ((prep["PB_ref"] - params["PB"])
                    / (params["PB"] * prep["PB_ref"] * SECS_PER_DAY))
            phi_ref = dt / pb_ref_s
            dnorb = dt * dinv + teff_shift / pb_s
            # PBDOT delta + cross terms (all small)
            dnorb = dnorb - 0.5 * (params["PBDOT"] - prep["PBDOT_ref"]) * phi_ref**2
            dnorb = dnorb - prep["PBDOT_ref"] * phi_ref * (dt * dinv + teff_shift / pb_s)
        total_frac = frac + dnorb
        return _TWO_PI * (total_frac - torch.floor(total_frac + 0.5))

    # ---- shared element helpers (device) ----

    def x_ls(self, params, prep, delay_accum):
        """Projected semimajor axis x(t) [ls] with A1DOT."""
        dt = prep["orb_dt_hi"] + prep["orb_dt_lo"] - delay_accum
        return params["A1"] + params.get("A1DOT", 0.0) * dt

    def omega_rad(self, params, prep, delay_accum, nu=None):
        """Longitude of periastron [rad]; OMDOT applied linearly in time
        (or via true anomaly when nu is given, DD-style)."""
        om = params.get("OM", 0.0) * _DEG2RAD
        omdot = params.get("OMDOT", 0.0) * _DEG2RAD / SECS_PER_JULIAN_YEAR
        if nu is not None:
            # mean orbital angular frequency, from FB0 in FBn mode
            # (PB is packed as 0.0 there) else from PB
            if prep["orb_mode_fb"]:
                n_orb = _TWO_PI * params["FB"][..., 0]
            else:
                n_orb = _TWO_PI / (params["PB"] * SECS_PER_DAY)
            return om + (omdot / n_orb) * nu
        dt = prep["orb_dt_hi"] + prep["orb_dt_lo"] - delay_accum
        return om + omdot * dt

    def ecc(self, params, prep, delay_accum):
        dt = prep["orb_dt_hi"] + prep["orb_dt_lo"] - delay_accum
        return params.get("ECC", 0.0) + params.get("EDOT", 0.0) * dt


def kepler_solve(M, e, iters=8):
    """Eccentric anomaly from mean anomaly, fixed-iteration Newton.

    A fixed count (no data-dependent stop) keeps the solve valid under
    ``torch.func.vmap``/``jacfwd`` and its last bits the JAX package's
    (reference: BT_model.py Newton loop)."""
    E = M + e * torch.sin(M)
    for _ in range(iters):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    return E


def orthometric_shapiro_rs(h3, sigma):
    """(range r [s], shape sini) from the orthometric Shapiro
    parameters (Freire & Wex 2010: sini = 2 sigma/(1+sigma^2),
    r = h3/sigma^3), shared by BinaryELL1H and BinaryDDH. sigma = 0
    (unset) degrades to r = h3, sini = 0; the guard sits on the
    divisor itself, so a forward-mode tangent never sees 1/0."""
    sini = 2.0 * sigma / (1.0 + sigma**2)
    r = h3 / torch.where(sigma == 0.0, 1.0, sigma**3)
    return r, sini
