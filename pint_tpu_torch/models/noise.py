"""White/correlated noise components (torch counterpart of the JAX
package's ``models/noise.py``: ScaleToaError, EcorrNoise, PLRedNoise,
PLDMNoise, PLChromNoise and PLSWNoise).

(reference: src/pint/models/noise_model.py — ScaleToaError (EFAC/EQUAD
maskParameters), EcorrNoise (epoch-correlated, quantization basis),
PLRedNoise (power-law Fourier basis).)

Masks are resolved at pack time; EFAC/EQUAD scale sigma on the device;
ECORR and red noise export (basis, weight) pairs the GLS fit consumes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import C_M_S, DMconst, SECS_PER_DAY
from .parameter import floatParameter, maskParameter
from .timing_model import Component


class NoiseComponent(Component):
    kind = "noise"

    def delay(self, params, batch, prep, delay_accum):
        return torch.zeros_like(batch.tdb_sec)


class ScaleToaError(NoiseComponent):
    """EFAC/EQUAD sigma scaling (reference: noise_model.py::ScaleToaError).

    scaled_sigma = sqrt((EFAC * sigma)^2 + EQUAD^2) [EQUAD in us].
    """

    category = "scale_toa_error"
    order = 90

    def __init__(self):
        super().__init__()
        self.efac_ids: list[int] = []
        self.equad_ids: list[int] = []
        self.dmefac_ids: list[int] = []
        self.dmequad_ids: list[int] = []

    def add_mask_param(self, kind: str, fields):
        ids = getattr(self, f"{kind.lower()}_ids")
        index = len(ids) + 1
        p = maskParameter(f"{kind}{index}", kind, index,
                          units="" if "FAC" in kind else "us")
        p.from_parfile_fields(fields)
        self.add_param(p)
        ids.append(index)
        return p

    def device_slot(self, pname):
        for kind in ("EFAC", "EQUAD", "DMEFAC", "DMEQUAD"):
            if pname.startswith(kind) and pname[len(kind):].isdigit():
                ids = getattr(self, f"{kind.lower()}_ids")
                return kind, ids.index(int(pname[len(kind):]))
        raise KeyError(pname)

    def pack(self, model, toas, prep, params0, device=None):
        for kind in ("EFAC", "EQUAD", "DMEFAC", "DMEQUAD"):
            ids = getattr(self, f"{kind.lower()}_ids")
            default = 1.0 if "FAC" in kind else 0.0
            params0[kind] = np.array([getattr(self, f"{kind}{i}").value or default
                                      for i in ids])
            prep[f"{kind.lower()}_masks"] = (
                np.stack([getattr(self, f"{kind}{i}").resolve_mask(toas)
                          for i in ids]).astype(np.float64)
                if ids else np.zeros((0, len(toas))))

    def scale_sigma(self, params, batch, prep, sigma_us):
        efac = 1.0 + (params["EFAC"] - 1.0) @ prep["efac_masks"]
        equad = params["EQUAD"] @ prep["equad_masks"]
        return torch.sqrt(torch.square(efac * sigma_us) + torch.square(equad))

    def scale_dm_sigma(self, params, prep, sigma_dm):
        """Scaled wideband DM uncertainties [pc cm^-3]:
        sqrt((DMEFAC * sigma)^2 + DMEQUAD^2) per mask (reference:
        noise_model.py::ScaleDmError.scale_dm_sigma — the DM-domain
        twin of scale_sigma, consumed by WidebandDMResiduals)."""
        dmefac = 1.0 + (params["DMEFAC"] - 1.0) @ prep["dmefac_masks"]
        dmequad = params["DMEQUAD"] @ prep["dmequad_masks"]
        return torch.sqrt(torch.square(dmefac * sigma_dm)
                          + torch.square(dmequad))


def quantize_epochs(mjds, idx, window_days=2.0 / SECS_PER_DAY):
    """Epoch groups of the TOAs ``idx``: sorted by MJD, a new epoch at
    every gap above ``window_days``; singleton epochs dropped.

    Returns (members, group) — the member TOA indices and, for each, its
    group number 0..n_groups-1 in time order — plus n_groups. The JAX
    package's EcorrNoise.pack builds the same groups with one full-
    length boolean mask per epoch (quadratic per pulsar); this is one
    sort and one bincount, with identical groups and numbering.
    """
    order = idx[np.argsort(mjds[idx])]
    t = mjds[order]
    bucket = np.concatenate([[0], np.cumsum(np.diff(t) > window_days)])
    sizes = np.bincount(bucket)
    keep = sizes >= 2  # singleton epochs carry no correlated info
    gid = np.full(len(sizes), -1, dtype=np.int64)
    gid[keep] = np.arange(int(keep.sum()))
    g = gid[bucket]
    sel = g >= 0
    return order[sel], g[sel], int(keep.sum())


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise (reference: noise_model.py::EcorrNoise).

    Host pack quantizes TOAs of each ECORR mask into epochs (2 s window)
    producing basis U (n_toa x n_epoch) with weights w = ECORR^2 us^2 —
    stored as the O(n) epoch index when the epochs are disjoint.
    """

    category = "ecorr_noise"
    order = 91

    def __init__(self):
        super().__init__()
        self.ecorr_ids: list[int] = []

    def add_mask_param(self, fields):
        index = len(self.ecorr_ids) + 1
        p = maskParameter(f"ECORR{index}", "ECORR", index, units="us")
        p.from_parfile_fields(fields)
        self.add_param(p)
        self.ecorr_ids.append(index)
        return p

    def device_slot(self, pname):
        return "ECORR", self.ecorr_ids.index(int(pname[5:]))

    def pack(self, model, toas, prep, params0, device=None):
        params0["ECORR"] = np.array([getattr(self, f"ECORR{i}").value or 0.0
                                     for i in self.ecorr_ids])
        mjds = toas.get_mjds()
        n = len(toas)
        members, groups, owner = [], [], []
        n_groups = 0
        for k, i in enumerate(self.ecorr_ids):
            idx = np.flatnonzero(getattr(self, f"ECORR{i}").resolve_mask(toas))
            if len(idx) == 0:
                continue
            m, g, ng = quantize_epochs(mjds, idx)
            members.append(m)
            groups.append(g + n_groups)
            owner.extend([k] * ng)
            n_groups += ng
        prep["ecorr_owner"] = np.array(owner, dtype=np.int64)
        members = (np.concatenate(members) if members
                   else np.zeros(0, np.int64))
        groups = (np.concatenate(groups) if groups
                  else np.zeros(0, np.int64))
        if n_groups and np.bincount(members, minlength=n).max() > 1:
            # overlapping ECORR masks (a TOA in two epochs): only the
            # dense basis can represent this
            U = np.zeros((n, n_groups))
            U[members, groups] = 1.0
            prep["ecorr_U"] = U
        else:
            # disjoint epochs: the O(n) epoch index instead of the
            # O(n*k) dense basis
            eidx = np.full(n, -1, dtype=np.int32)
            eidx[members] = groups
            prep["ecorr_eidx"] = eidx

    @staticmethod
    def dense_U(prep):
        """The (n_toa, k) 0/1 quantization basis, reconstructed from
        the epoch index when only the sparse form is packed."""
        if "ecorr_U" in prep:
            return prep["ecorr_U"]
        k = prep["ecorr_owner"].shape[-1]
        eidx = torch.as_tensor(prep["ecorr_eidx"])
        return (eidx[:, None] == torch.arange(k, device=eidx.device)
                ).to(torch.float64)

    def basis_weight(self, params, prep):
        """(U, w): covariance contribution U diag(w) U^T, w in us^2
        (dense form; owner < 0 marks padding columns, weight 0)."""
        U = self.dense_U(prep)
        if not U.shape[1]:
            return U, U.new_zeros(0)
        owner = prep["ecorr_owner"]
        w = torch.square(params["ECORR"])[torch.clamp(owner, min=0)]
        return U, torch.where(owner >= 0, w, 0.0)

    def basis_columns(self, prep):
        """Columns of :meth:`basis_weight`'s basis: one per epoch."""
        return int(prep["ecorr_owner"].shape[-1])

    def epoch_index_weight(self, params, prep):
        """Sparse form for the analytically-marginalized GLS path:
        (eidx (n_toa,) int, w_us2 (k,)) with eidx in [0,k) or any
        out-of-range value (-1 / padded) meaning 'not in an epoch'.
        None when only the overlapping dense form exists."""
        if "ecorr_eidx" not in prep:
            return None
        owner = prep["ecorr_owner"]
        w = torch.square(params["ECORR"])[torch.clamp(owner, min=0)]
        return prep["ecorr_eidx"], torch.where(owner >= 0, w, 0.0)


def fourier_basis(toas, n_harm):
    """(F (n_toa, 2*n_harm), freqs_Hz repeated sin/cos, tspan_s) —
    host numpy, as in the JAX package."""
    mjds = toas.get_mjds()
    tspan_s = (mjds.max() - mjds.min() + 1.0) * SECS_PER_DAY
    t_s = (mjds - mjds.min()) * SECS_PER_DAY
    k = np.arange(1, n_harm + 1)
    freqs = k / tspan_s
    arg = 2 * np.pi * np.outer(t_s, freqs)
    F = np.empty((len(toas), 2 * n_harm))
    F[:, 0::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    return F, np.repeat(freqs, 2), tspan_s


def powerlaw_phi(A, gamma, f, tspan_s):
    """Per-column prior variances [us^2] of the enterprise-convention
    power law P(f) = A^2/(12 pi^2) (f/f_yr)^(-gamma) yr^3."""
    fyr = 1.0 / (365.25 * SECS_PER_DAY)
    psd = (A**2 / (12.0 * math.pi**2) * (f / fyr) ** (-gamma)) / fyr**3
    return psd / tspan_s * 1e12  # s^2 -> us^2


class PLRedNoise(NoiseComponent):
    """Power-law red noise Fourier basis (reference: noise_model.py::PLRedNoise)."""

    category = "pl_red_noise"
    order = 92

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter("RNAMP", units="us*yr^0.5",
                                      description="Red noise amplitude"))
        self.add_param(floatParameter("RNIDX", units="",
                                      description="Red noise spectral index (negative)"))
        self.add_param(floatParameter("TNREDAMP", units="log10",
                                      description="log10 TN red amplitude"))
        self.add_param(floatParameter("TNREDGAM", units="",
                                      description="TN red spectral index (positive)"))
        p = floatParameter("TNREDC", units="", description="Number of harmonics")
        p.value = 30
        self.add_param(p)

    def device_slot(self, pname):
        return pname, None

    def n_harmonics(self):
        return int(self.TNREDC.value or 30)

    def pack(self, model, toas, prep, params0, device=None):
        F, freqs, tspan_s = fourier_basis(toas, self.n_harmonics())
        prep["rn_F"] = F
        prep["rn_freqs"] = freqs
        prep["rn_tspan_s"] = np.asarray(tspan_s, np.float64)
        for pname in ("RNAMP", "RNIDX", "TNREDAMP", "TNREDGAM"):
            params0[pname] = getattr(self, pname).value or 0.0

    def basis_columns(self, prep):
        """Columns of :meth:`basis_weight`'s basis: 2 per harmonic."""
        return int(prep["rn_freqs"].shape[-1])

    def basis_weight(self, params, prep):
        """(F, phi): weights [us^2] of the power-law PSD per basis column
        (TN amplitude, or tempo RNAMP/RNIDX converted equivalently)."""
        if self.TNREDAMP.value is not None:
            A = 10.0 ** params["TNREDAMP"]
            gamma = params["TNREDGAM"]
        else:
            A = params["RNAMP"] * (2.0 * math.pi * math.sqrt(3.0)) / (1e6 * 365.25 * 86400.0)
            gamma = -params["RNIDX"]
        return prep["rn_F"], powerlaw_phi(A, gamma, prep["rn_freqs"],
                                          prep["rn_tspan_s"])


class _PLScaledNoise(NoiseComponent):
    """Power-law noise whose Fourier basis is row-scaled per TOA:
    PLDMNoise and PLChromNoise by (f_ref/nu)^alpha, PLSWNoise by the
    solar-wind delay per unit NE_SW. The basis/weight math has one
    home, as in the JAX package."""

    F_REF_MHZ = 1400.0
    AMP = GAM = NHARM = PREP = None  # subclass config
    PHI_SCALE = 1.0  # basis-weight unit conversion (see PLSWNoise)

    def __init__(self):
        super().__init__()
        self.add_param(floatParameter(self.AMP, units="log10",
                                      description="log10 noise amplitude"))
        self.add_param(floatParameter(self.GAM, units="",
                                      description="Noise spectral index"))
        p = floatParameter(self.NHARM, units="",
                           description="Number of harmonics")
        p.value = 30
        self.add_param(p)

    def device_slot(self, pname):
        return pname, None

    def _alpha(self, model):
        raise NotImplementedError

    def _row_scale(self, model, toas, prep, params0):
        """Per-TOA multiplier on the Fourier basis rows: the chromatic
        factor (f_ref/nu)^alpha; infinite-frequency TOAs see none of
        this noise."""
        alpha = self._alpha(model)
        with np.errstate(divide="ignore"):
            return np.where(np.isfinite(toas.freq_mhz),
                            (self.F_REF_MHZ / toas.freq_mhz) ** alpha, 0.0)

    def pack(self, model, toas, prep, params0, device=None):
        F, freqs, tspan_s = fourier_basis(
            toas, int(getattr(self, self.NHARM).value or 30))
        scale = self._row_scale(model, toas, prep, params0)
        prep[f"{self.PREP}_F"] = F * scale[:, None]
        prep[f"{self.PREP}_freqs"] = freqs
        prep[f"{self.PREP}_tspan_s"] = np.asarray(tspan_s, np.float64)
        for pname in (self.AMP, self.GAM):
            params0[pname] = getattr(self, pname).value or 0.0

    def basis_columns(self, prep):
        """Columns of :meth:`basis_weight`'s basis: 2 per harmonic."""
        return int(prep[f"{self.PREP}_freqs"].shape[-1])

    def basis_weight(self, params, prep):
        A = 10.0 ** params[self.AMP]
        gamma = params[self.GAM]
        return prep[f"{self.PREP}_F"], self.PHI_SCALE * powerlaw_phi(
            A, gamma, prep[f"{self.PREP}_freqs"],
            prep[f"{self.PREP}_tspan_s"])


class PLDMNoise(_PLScaledNoise):
    """Power-law DM noise (reference: noise_model.py::PLDMNoise): the
    PLRedNoise Fourier machinery with the basis scaled per TOA by
    (f_ref/nu)^2, f_ref = 1400 MHz. Params TNDMAMP (log10), TNDMGAM,
    TNDMC."""

    category = "pl_dm_noise"
    order = 93
    AMP, GAM, NHARM, PREP = "TNDMAMP", "TNDMGAM", "TNDMC", "dmrn"

    def _alpha(self, model):
        return 2.0


class PLChromNoise(_PLScaledNoise):
    """Power-law chromatic noise (reference: noise_model.py::
    PLChromNoise): the basis scaled by (f_ref/nu)^alpha with alpha the
    model's TNCHROMIDX (owned by ChromaticCM, default 4). Params
    TNCHROMAMP (log10), TNCHROMGAM, TNCHROMC."""

    category = "pl_chrom_noise"
    order = 94
    AMP, GAM, NHARM, PREP = "TNCHROMAMP", "TNCHROMGAM", "TNCHROMC", "chromrn"

    def _alpha(self, model):
        # static at pack time, like the basis span
        cm = model.components.get("ChromaticCM")
        if cm is not None and cm.TNCHROMIDX.value is not None:
            return float(cm.TNCHROMIDX.value)
        return 4.0


class PLSWNoise(_PLScaledNoise):
    """Power-law solar-wind (NE_SW) noise (reference:
    noise_model.py::PLSWNoise *(version-dependent; Susarla et al.
    2024)*): a Gaussian process on NE_SW(t) whose basis rows carry the
    delay of a unit NE_SW change, DMconst * geom_pc(t) / nu^2 [us per
    cm^-3] (the geometry of SolarWindDispersion, at the wind's own
    power index). PHI_SCALE takes out powerlaw_phi's s^2 -> us^2
    factor: the basis already carries the us. Params TNSWAMP (log10),
    TNSWGAM, TNSWC."""

    category = "pl_sw_noise"
    order = 95
    AMP, GAM, NHARM, PREP = "TNSWAMP", "TNSWGAM", "TNSWC", "swrn"
    PHI_SCALE = 1e-12

    def _row_scale(self, model, toas, prep, params0):
        from .solar_wind import solar_wind_geometry_p

        astrom = next((c for c in model.delay_components()
                       if c.category == "astrometry"), None)
        has_sw = ("SolarWindDispersion" in model.components
                  or "SolarWindDispersionX" in model.components)
        if not has_sw or astrom is None:
            raise ValueError(
                "PLSWNoise needs a solar-wind component (NE_SW or SWX) "
                "and an astrometry component to evaluate the "
                "line-of-sight geometry")
        # geometry per unit NE_SW at the start-of-fit position (static
        # during a fit, like the basis span)
        n_hat = astrom.psb_xyz_host(params0, prep)
        sun_ls = toas.obs_sun.pos / C_M_S
        # the effective wind index: under SWM 1 the deterministic
        # d(delay)/d(NE_SW) is the r^-SWP geometry, and the basis must
        # match it
        sw = model.components.get("SolarWindDispersionX",
                                  model.components.get(
                                      "SolarWindDispersion"))
        p_base = 2.0
        if int(sw.SWM.value or 0) == 1 and sw.SWP.value is not None:
            p_base = float(sw.SWP.value)
        swx_ids = getattr(sw, "swx_ids", ())
        if swx_ids:
            # under SWX each window has its own index (SWXP_####)
            mjd = toas.get_mjds()
            p_eff = np.full(len(toas), p_base, dtype=np.float64)
            for i in swx_ids:
                lo = getattr(sw, f"SWXR1_{i:04d}").value
                hi = getattr(sw, f"SWXR2_{i:04d}").value
                pv = getattr(sw, f"SWXP_{i:04d}").value
                m = (mjd >= lo) & (mjd < hi)
                p_eff[m] = 2.0 if pv is None else float(pv)
            p_eff = torch.as_tensor(p_eff)
        else:
            p_eff = p_base
        geom_pc = solar_wind_geometry_p(torch.as_tensor(sun_ls),
                                        torch.as_tensor(n_hat), p_eff).numpy()
        with np.errstate(divide="ignore"):
            per_f2 = np.where(np.isfinite(toas.freq_mhz),
                              1.0 / np.square(toas.freq_mhz), 0.0)
        return 1e6 * DMconst * geom_pc * per_f2
