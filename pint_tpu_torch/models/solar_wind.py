"""Solar-wind dispersion delay (torch counterpart of the JAX package's
``models/solar_wind.py``).

(reference: src/pint/models/solar_wind_dispersion.py::SolarWindDispersion
— NE_SW electron density at 1 AU, spherically-symmetric n ~ r^-2 wind,
delay = DMconst * DM_sw / freq^2 with the (pi - theta)/(r sin theta)
line-of-sight geometry factor; SWM 1 for an n ~ r^-SWP power law.)

Geometry: for n(d) = NE_SW (AU/d)^2 integrated from the observatory to
infinity along the line of sight,

    DM_sw = NE_SW * AU^2 * (pi - theta) / (r * sin(theta))

where r = |observatory -> Sun| and theta is the angle between the
observatory->Sun vector and the pulsar direction (elongation). All on
the device and differentiable in NE_SW, SWP and the pulsar position.
``SolarWindDispersionX`` adds the piecewise SWX windows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import AU_LS, DMconst, ONE_AU_PC
from .parameter import MJDParameter, floatParameter, prefixParameter
from .timing_model import DelayComponent


class SolarWindDispersion(DelayComponent):
    category = "solar_wind"
    order = 32

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter(
            "NE_SW", units="cm^-3", aliases=("NE1AU", "SOLARN0"),
            description="Solar wind electron density at 1 AU"))
        self.add_param(floatParameter(
            "SWM", units="",
            description="Solar wind model index (0: spherical r^-2; "
                        "1: r^-SWP power law)"))
        self.add_param(floatParameter(
            "SWP", units="",
            description="Solar wind density power-law index (SWM 1; "
                        "density ~ r^-SWP, SWP=2 recovers SWM 0)"))
        self.NE_SW.value = 0.0
        self.SWM.value = 0.0
        self.SWP.value = 2.0

    def validate(self):
        if self.SWM.value not in (None, 0, 0.0, 1, 1.0):
            raise ValueError(
                "only SWM 0 (spherical r^-2 wind) and SWM 1 (r^-SWP "
                "power-law wind) are supported")
        swm = int(self.SWM.value or 0)
        # no falsy-zero fallback: SWP 0.0 is a real (and invalid) value
        swp = 2.0 if self.SWP.value is None else float(self.SWP.value)
        if swm == 1 and not swp > 1.0:
            raise ValueError("SWM 1 needs SWP > 1 (the line-of-sight "
                             "integral diverges otherwise)")
        if swm != 1 and not self.SWP.frozen:
            raise ValueError(
                "SWP is only used with SWM 1; freeing it under SWM 0 "
                "would put an identically-zero column in the design "
                "matrix (rank-deficient fit)")

    def device_slot(self, pname):
        if pname in ("NE_SW", "SWP"):
            return pname, None
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        params0["NE_SW"] = self.NE_SW.value or 0.0
        params0["SWP"] = (2.0 if self.SWP.value is None
                          else float(self.SWP.value))

    def solar_wind_dm(self, params, batch, prep):
        """DM_sw per TOA [pc cm^-3]; differentiable (in SWP too under
        SWM 1 — the cos-power quadrature is smooth in p)."""
        astrom = next((c for c in self._parent.delay_components()
                       if c.category == "astrometry"), None)
        if astrom is None:
            return torch.zeros_like(batch.tdb_sec)
        n = astrom.ssb_to_psb_xyz(params, prep)
        sun = batch.obs_sun_ls
        if int(self.SWM.value or 0) == 1:
            return params["NE_SW"] * solar_wind_geometry_p(
                sun, n, params["SWP"])
        r_ls = torch.linalg.norm(sun, dim=-1)
        cos_t = torch.clip(torch.sum(sun * n, dim=-1) / r_ls, -1.0, 1.0)
        theta = torch.arccos(cos_t)
        sin_t = torch.clip(torch.sin(theta), min=1e-6)
        r_au = r_ls / AU_LS
        geom_pc = ONE_AU_PC * (math.pi - theta) / (r_au * sin_t)
        return params["NE_SW"] * geom_pc

    def delay(self, params, batch, prep, delay_accum):
        dm = self.solar_wind_dm(params, batch, prep)
        f2 = torch.square(batch.freq_mhz)
        return torch.where(torch.isfinite(f2), DMconst * dm / f2, 0.0)


# Fixed tanh-sinh (double-exponential) rule on [0, 1]: one static node
# set integrates t^(p-2) * smooth(t) to ~1e-12 for every p > ~1.1 —
# endpoint algebraic singularities (1 < p < 2) and non-integer-power
# endpoint derivatives (2 < p < 3) alike. The same nodes and weights as
# the JAX package.
_TS_A = np.linspace(-4.5, 4.5, 81)
_TS_U = 0.5 * np.pi * np.sinh(_TS_A)
# t = 0.5*(1+tanh u) as a stable sigmoid: a naive tanh saturates to -1
# for u < ~-19 in f64, and t^(p-2) for p < 2 would be inf there
_TS_T = np.where(_TS_U < 0,
                 np.exp(2 * np.minimum(_TS_U, 0))
                 / (1.0 + np.exp(2 * np.minimum(_TS_U, 0))),
                 1.0 / (1.0 + np.exp(-2 * np.maximum(_TS_U, 0))))
_TS_W = (_TS_A[1] - _TS_A[0]) * 0.25 * np.pi * np.cosh(_TS_A) \
    / np.cosh(_TS_U) ** 2


def _cospow_half(p):
    """Closed form F(pi/2; p) = integral_0^(pi/2) cos^(p-2) =
    sqrt(pi)/2 * Gamma((p-1)/2) / Gamma(p/2), differentiable in p."""
    p = torch.as_tensor(p, dtype=torch.float64)
    return (0.5 * math.sqrt(math.pi)
            * torch.exp(torch.lgamma((p - 1.0) / 2.0)
                        - torch.lgamma(p / 2.0)))


def _cospow_integral(phi_hi, p):
    """F(phi_hi; p) = integral_0^phi_hi cos^(p-2)(psi) dpsi for
    phi_hi <= pi/2 (either sign), vectorized with matching-shape p:
    F_half(p) - G(eps; p) with eps = pi/2 - phi_hi and
    G(eps; p) = eps^(p-1) * integral_0^1 t^(p-2) (sin(eps t)/(eps t))^(p-2) dt
    on the fixed tanh-sinh rule above (the JAX package's
    ``_cospow_integral``, whose docstring gives the measured accuracy).
    Exact for p = 2; differentiable in p."""
    p = torch.as_tensor(p, dtype=torch.float64, device=phi_hi.device)
    eps = 0.5 * math.pi - phi_hi  # in (0, pi); callers clip theta
    t = torch.as_tensor(_TS_T, device=phi_hi.device)
    w = torch.as_tensor(_TS_W, device=phi_hi.device)
    x = eps[..., None] * t
    # (sin x / x)^(p-2) without 0/0 at x = 0
    big = torch.abs(x) > 1e-300
    sinc = torch.where(big, torch.sin(x) / torch.where(big, x, 1.0), 1.0)
    f = t ** (p[..., None] - 2.0) * sinc ** (p[..., None] - 2.0)
    G = eps ** (p - 1.0) * torch.sum(w * f, dim=-1)
    return _cospow_half(p) - G


def solar_wind_geometry_p(sun_ls, n_hat, p):
    """DM per unit electron density at 1 AU [pc cm^-3 per cm^-3] for an
    n ~ r^-p wind, along the observatory->pulsar line of sight:
    I = AU^p/b^(p-1) * [F(pi/2;p) + F(atan(z0/b);p)] with b = r sin(theta)
    the impact parameter and z0 = r cos(theta); p = 2 reduces exactly
    to the classic (pi - theta)/(r sin theta) factor (reference:
    solar_wind_dispersion.py::_dm_p_int / _solar_wind_geometry)."""
    r_ls = torch.linalg.norm(sun_ls, dim=-1)
    cos_t = torch.clip(torch.sum(sun_ls * n_hat, dim=-1) / r_ls, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.clip(torch.sin(theta), min=1e-6)
    b_ls = r_ls * sin_t
    z0_ls = r_ls * cos_t
    # p and b_ls broadcast (per-window p (k,1) against per-TOA (1,n))
    p = torch.as_tensor(p, dtype=torch.float64, device=b_ls.device)
    ones = torch.ones(torch.broadcast_shapes(p.shape, b_ls.shape),
                      dtype=torch.float64, device=b_ls.device)
    # closed form for the half-range piece: the quadrature at pi/2
    # would hit eps = 0, where eps^(p-1) has a NaN p-gradient
    F_inf = _cospow_half(p)
    F_z = _cospow_integral(torch.arctan(z0_ls / b_ls) * ones, p * ones)
    I_ls = AU_LS**p / b_ls ** (p - 1.0) * (F_inf + F_z)
    return I_ls * (ONE_AU_PC / AU_LS)  # ls -> pc


class SolarWindDispersionX(SolarWindDispersion):
    """Piecewise solar wind (reference: solar_wind_dispersion.py::
    SolarWindDispersionX *(version-dependent)*).

    SWXDM_#### is the window's maximum solar-wind DM [pc cm^-3] over
    [SWXR1_####, SWXR2_####); the per-TOA contribution is
    SWXDM * g_p(t) / max_window(g_p) with g_p the r^-p geometry factor
    and p = SWXP_#### (default 2). Outside all windows the base NE_SW
    density applies."""

    category = "solar_windx"

    def __init__(self):
        super().__init__()
        self.swx_ids: list[int] = []

    def add_swx_range(self, index, mjd_lo, mjd_hi, dm=0.0, p=2.0):
        pdm = prefixParameter(f"SWXDM_{index:04d}", "SWXDM_", index,
                              units="pc cm^-3",
                              aliases=(f"SWX_{index:04d}",))
        pdm.value = dm
        self.add_param(pdm)
        pp = prefixParameter(f"SWXP_{index:04d}", "SWXP_", index, units="")
        pp.value = p
        self.add_param(pp)
        r1 = MJDParameter(f"SWXR1_{index:04d}", units="MJD")
        r1.value = mjd_lo
        self.add_param(r1)
        r2 = MJDParameter(f"SWXR2_{index:04d}", units="MJD")
        r2.value = mjd_hi
        self.add_param(r2)
        self.swx_ids.append(index)

    def validate(self):
        super().validate()
        for i in self.swx_ids:
            pp = getattr(self, f"SWXP_{i:04d}")
            if not pp.frozen:
                raise ValueError(
                    f"SWXP_{i:04d}: fitting the solar-wind power index is "
                    "not supported (static per-window quadrature)")
            # the base SWP's divergence guard (no falsy-zero fallback)
            pv = 2.0 if pp.value is None else float(pp.value)
            if not pv > 1.0:
                raise ValueError(
                    f"SWXP_{i:04d} must be > 1 (the line-of-sight "
                    f"integral diverges otherwise), got {pv}")

    def device_slot(self, pname):
        if pname.startswith("SWXDM_"):
            return "SWXDM", self.swx_ids.index(int(pname[6:]))
        return super().device_slot(pname)

    def pack(self, model, toas, prep, params0, device=None):
        super().pack(model, toas, prep, params0, device)
        params0["SWXDM"] = np.array(
            [getattr(self, f"SWXDM_{i:04d}").value or 0.0
             for i in self.swx_ids], dtype=np.float64)
        mjd = toas.get_mjds()
        prep["swx_masks"] = np.stack([
            ((mjd >= getattr(self, f"SWXR1_{i:04d}").value)
             & (mjd < getattr(self, f"SWXR2_{i:04d}").value)).astype(np.float64)
            for i in self.swx_ids]) if self.swx_ids else np.zeros((0, len(toas)))
        prep["swx_p"] = np.array(
            [2.0 if getattr(self, f"SWXP_{i:04d}").value is None
             else float(getattr(self, f"SWXP_{i:04d}").value)
             for i in self.swx_ids], dtype=np.float64)

    def delay(self, params, batch, prep, delay_accum):
        dm = self.swx_dm(params, batch, prep)
        f2 = torch.square(batch.freq_mhz)
        return torch.where(torch.isfinite(f2), DMconst * dm / f2, 0.0)

    def swx_dm(self, params, batch, prep):
        """Per-TOA solar-wind DM [pc cm^-3]: SWX windows (max-DM
        convention) + NE_SW base outside every window. Shared by
        delay() and TimingModel.total_dm."""
        astrom = next((c for c in self._parent.delay_components()
                       if c.category == "astrometry"), None)
        masks = prep["swx_masks"]
        base_dm = self.solar_wind_dm(params, batch, prep)
        if masks.shape[-2] == 0 or astrom is None:
            return base_dm
        n_hat = astrom.ssb_to_psb_xyz(params, prep)
        # per-window geometry (k, n): window j uses its own power index
        G = solar_wind_geometry_p(batch.obs_sun_ls[..., None, :, :],
                                  n_hat[..., None, :, :],
                                  prep["swx_p"][..., :, None])
        # normalize each window by its in-window maximum
        gmax = torch.amax(G * masks, dim=-1)
        gmax = torch.where(gmax > 0, gmax, 1.0)
        dm_x = torch.sum((params["SWXDM"] / gmax)[..., :, None] * G * masks,
                         dim=-2)
        in_any = torch.clip(torch.sum(masks, dim=-2), 0.0, 1.0)
        return dm_x + base_dm * (1.0 - in_any)
