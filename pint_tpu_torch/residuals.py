"""Residuals: model phase vs observed TOAs, and wideband DM residuals.

Counterpart of the JAX package's ``residuals.py`` (reference:
src/pint/residuals.py — Residuals: calc_phase_resids with
nearest-integer or pulse-number tracking, optional weighted-mean
subtraction; calc_time_resids = phase/F0; chi2/dof/rms.
WidebandDMResiduals / WidebandTOAResiduals: the -pp_dm/-pp_dme
measurements against the model DM. CombinedResiduals). The phase, the
model DM and the sums run on ``device`` (torch f64); the numpy-facing
properties bring results back to the host.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .utils import weighted_mean


class Residuals:
    """(reference: residuals.py::Residuals — same public surface, plus
    ``device``)."""

    def __init__(self, toas, model, subtract_mean=True, use_weighted_mean=True,
                 track_mode=None, prepared=None, device="cuda"):
        self.toas = toas
        self.model = model
        self.subtract_mean = subtract_mean
        self.use_weighted_mean = use_weighted_mean
        if track_mode is None:
            tm = model.TRACK if "TRACK" in model.params else None
            track_mode = ("use_pulse_numbers"
                          if tm is not None and tm.value == "-2" else "nearest")
        self.track_mode = track_mode
        self.prepared = (prepared if prepared is not None
                         else model.prepare(toas, device=device))
        self._phase_resids = None
        self._time_resids = None
        # per-component noise realizations a GLS-family fit attaches
        self.noise_resids = None

    # ---- core ----

    def calc_phase_resids(self, params=None):
        frac, pulse_int = self.prepared.phase_frac_and_int(params)
        if self.track_mode == "use_pulse_numbers":
            pn = self.prepared.batch.pulse_number
            resid = torch.where(torch.isnan(pn), frac, (pulse_int - pn) + frac)
        else:
            resid = frac
        if self.subtract_mean:
            if self.use_weighted_mean:
                sigma = self.prepared.scaled_sigma_us(params)
                resid = resid - weighted_mean(resid, sigma)
            else:
                resid = resid - torch.mean(resid)
        return resid

    def calc_time_resids(self, params=None):
        """Seconds (reference: residuals.py::calc_time_resids)."""
        f0 = (self.prepared.params0 if params is None else params)["F"][0]
        return self.calc_phase_resids(params) / f0

    # ---- numpy-facing conveniences ----

    @property
    def phase_resids(self):
        if self._phase_resids is None:
            self._phase_resids = self.calc_phase_resids().cpu().numpy()
        return self._phase_resids

    @property
    def time_resids(self):
        if self._time_resids is None:
            self._time_resids = self.calc_time_resids().cpu().numpy()
        return self._time_resids

    def _sigma_us(self, params=None):
        return self.prepared.scaled_sigma_us(params).cpu().numpy()

    def rms_weighted(self):
        """Weighted RMS [s]."""
        r = self.time_resids
        w = 1.0 / (self._sigma_us() * 1e-6) ** 2
        mean = np.sum(r * w) / np.sum(w)
        return float(np.sqrt(np.sum(w * (r - mean) ** 2) / np.sum(w)))

    def calc_whitened_resids(self, params=None):
        """Residuals divided by the scaled uncertainties — dimensionless,
        unit variance when the noise model is right (reference:
        residuals.py::Residuals.calc_whitened_resids). When a GLS fit
        attached ``noise_resids`` (per-component correlated-noise
        realizations [s], host arrays), they are subtracted first, so
        the result is whitened against the full noise model.
        ``calc_chi2``/``lnlikelihood`` deliberately do not subtract
        them: the realization-conditioned sum of squares lacks the
        amplitude-prior term and would read biased-low; the marginalized
        statistic is the GLS fitter's ``chi2_whitened``."""
        r = self.calc_time_resids(params)
        for v in (self.noise_resids or {}).values():
            r = r - torch.as_tensor(v, dtype=r.dtype, device=r.device)
        sigma_s = self.prepared.scaled_sigma_us(params) * 1e-6
        return r / sigma_s

    def calc_chi2(self, params=None):
        r = self.calc_time_resids(params)
        sigma_s = self.prepared.scaled_sigma_us(params) * 1e-6
        return torch.sum(torch.square(r / sigma_s))

    def lnlikelihood(self, params=None):
        """Gaussian white-noise log-likelihood
        -(chi2 + sum log(2 pi sigma^2)) / 2 (reference:
        residuals.py::Residuals.lnlikelihood)."""
        r = self.calc_time_resids(params).cpu().numpy()
        sigma_s = self._sigma_us(params) * 1e-6
        w = r / sigma_s
        return -0.5 * float(np.sum(w**2)
                            + np.sum(np.log(2.0 * np.pi * sigma_s**2)))

    @property
    def chi2(self):
        return float(self.calc_chi2())

    @property
    def dof(self):
        n_free = len(self.model.free_params)
        return len(self.toas) - n_free - 1  # -1 for the implicit offset

    @property
    def reduced_chi2(self):
        return self.chi2 / self.dof

    def ecorr_average(self, use_noise_model=True):
        """Epoch-averaged residuals (reference:
        residuals.py::Residuals.ecorr_average).

        TOAs are grouped by the EcorrNoise quantization epochs; TOAs
        outside every epoch are their own groups. Within a group the
        residual is the 1/sigma^2-weighted mean and the error
        sqrt(1/sum(1/sigma^2) + ECORR^2). With use_noise_model=False the
        raw TOA uncertainties replace the scaled ones and the ECORR term
        is dropped.

        Returns a dict with 'mjds', 'freqs', 'time_resids' [s],
        'errors' [us], 'indices' (list of member-index arrays).
        """
        n = len(self.toas)
        sigma_us = (self._sigma_us() if use_noise_model
                    else np.asarray(self.toas.error_us))
        r = np.asarray(self.time_resids)
        mjd = self.toas.get_mjds()
        freq = self.toas.freq_mhz
        prep = self.prepared.prep
        if "ecorr_eidx" in prep:  # sparse quantization (disjoint epochs)
            eidx = prep["ecorr_eidx"].cpu().numpy()
            n_ep = int(prep["ecorr_owner"].shape[0])
            groups = [np.flatnonzero(eidx == j) for j in range(n_ep)]
            in_epoch = eidx >= 0
        elif "ecorr_U" in prep:
            U = prep["ecorr_U"].cpu().numpy()
            groups = [np.flatnonzero(U[:, j]) for j in range(U.shape[1])]
            in_epoch = U.sum(axis=1) > 0
        else:
            groups, in_epoch = [], np.zeros(n, bool)
        w_us2 = np.zeros(len(groups))
        if groups and use_noise_model:
            comp = self.model.components.get("EcorrNoise")
            if comp is not None:
                if "ecorr_eidx" in prep:
                    _, w = comp.epoch_index_weight(self.prepared.params0, prep)
                else:
                    _, w = comp.basis_weight(self.prepared.params0, prep)
                w_us2 = w.cpu().numpy()
        groups += [np.array([i]) for i in np.flatnonzero(~in_epoch)]
        w_us2 = np.concatenate([w_us2, np.zeros(n - int(in_epoch.sum()))])
        order = np.argsort([mjd[g].mean() for g in groups])
        out = {"mjds": [], "freqs": [], "time_resids": [], "errors": [],
               "indices": []}
        for k in order:
            g = groups[k]
            w = 1.0 / sigma_us[g] ** 2
            out["mjds"].append(mjd[g].mean())
            out["freqs"].append(freq[g].mean())
            out["time_resids"].append(np.sum(r[g] * w) / np.sum(w))
            out["errors"].append(np.sqrt(1.0 / np.sum(w) + w_us2[k]))
            out["indices"].append(g)
        for key in ("mjds", "freqs", "time_resids", "errors"):
            out[key] = np.asarray(out[key])
        return out


def wideband_dm_model(model, params, prep, batch=None, include_jumps=True):
    """Effective per-TOA model DM [pc cm^-3], a tensor: DM(t) Taylor
    series + DMX windows + DMWaveX Fourier terms (+ solar wind when
    ``batch`` is given; its geometry needs the Sun vectors) + DMJUMP
    mask offsets. The one assembly point shared by WidebandDMResiduals,
    the wideband fitters' DM design block (``torch.func.jacfwd`` traces
    it) and TimingModel.total_dm, so derivatives, residuals and the
    reported model DM cannot disagree (the JAX package's
    ``residuals.wideband_dm_model``)."""
    comp = model.components.get("DispersionDM")
    # a model can carry DMX/DMWaveX/solar-wind dispersion without a
    # Taylor DM line (the builder adds the components independently)
    dm = (comp.dm_value(params, prep) if comp is not None
          else torch.zeros_like(prep["T_hi"]))
    if "DispersionDMX" in model.components:
        dm = dm + params["DMX"] @ prep["dmx_masks"]
    if "DMWaveX" in model.components:
        dm = dm + model.components["DMWaveX"].dm_value(params, prep)
    sw = (model.components.get("SolarWindDispersionX")
          or model.components.get("SolarWindDispersion"))
    if sw is not None:
        if batch is None:
            # dropping the solar-wind term silently would let the
            # derivatives and the residuals disagree
            raise ValueError(
                "model has a solar-wind component; wideband_dm_model "
                "needs the TOA batch (Sun vectors) — pass batch=")
        dm = dm + (sw.swx_dm(params, batch, prep)
                   if hasattr(sw, "swx_dm")
                   else sw.solar_wind_dm(params, batch, prep))
    if (include_jumps and "DispersionJump" in model.components
            and len(params.get("DMJUMP", ()))):
        # upstream sign convention (dispersion_model.py::DispersionJump
        # jump_dm): the jump enters the MODEL DM with a minus sign, so
        # d(DM_resid)/d(DMJUMP) = +1 and par files interchange with the
        # reference without negating
        dm = dm - params["DMJUMP"] @ prep["dmjump_masks"]
    return dm


def free_dm_noise_params(model):
    """Names of user-freed DMEFAC/DMEQUAD parameters. The wideband DM
    uncertainty scaling (WidebandDMResiduals) is evaluated once at the
    start-of-fit values, so the wideband fitters refuse these as fit
    parameters (fitter._reject_free_dm_noise)."""
    comp = model.components.get("ScaleToaError")
    if comp is None:
        return []
    return [p for p in comp.params
            if p.startswith(("DMEFAC", "DMEQUAD"))
            and not getattr(comp, p).frozen]


def _flag_floats(values):
    return np.array([float(v) if v not in ("", "nan") else np.nan
                     for v in values])


class WidebandDMResiduals:
    """DM residuals from wideband TOA flags (reference:
    residuals.py::WidebandDMResiduals): the observed DM of each TOA is
    its -pp_dm flag with error -pp_dme (host numpy), the model DM is
    wideband_dm_model on ``device``."""

    def __init__(self, toas, model, prepared=None, device="cuda"):
        self.toas = toas
        self.model = model
        self.prepared = (prepared if prepared is not None
                         else model.prepare(toas, device=device))
        self.dm_observed = _flag_floats(toas.get_flag_value("pp_dm",
                                                            fill="nan"))
        raw_err = _flag_floats(toas.get_flag_value("pp_dme", fill="nan"))
        # a zero/negative pp_dme would give that TOA infinite weight in
        # every wideband chi2 and fit, and a missing one leaves the
        # weight undefined: both count as no DM measurement, named
        # apart so the warning points at the actual problem
        has_dm = ~np.isnan(self.dm_observed)
        bad_err = ~(raw_err > 0)
        n_missing = int((np.isnan(raw_err) & has_dm).sum())
        n_nonpos = int((bad_err & ~np.isnan(raw_err) & has_dm).sum())
        if n_missing or n_nonpos:
            parts = []
            if n_nonpos:
                parts.append(f"{n_nonpos} with non-positive -pp_dme")
            if n_missing:
                parts.append(f"{n_missing} with -pp_dm but no -pp_dme")
            warnings.warn("wideband TOA(s) excluded from the DM "
                          "residuals: " + "; ".join(parts))
        self.valid = has_dm & ~bad_err
        # DMEFAC/DMEQUAD scaling (reference: ScaleDmError), applied at
        # the start-of-fit values; so the wideband fitters refuse FREE
        # DMEFAC/DMEQUAD (free_dm_noise_params above)
        scale = model.components.get("ScaleToaError")
        if scale is not None and (scale.dmefac_ids or scale.dmequad_ids):
            safe = np.where(np.isnan(raw_err), 0.0, raw_err)
            p = self.prepared
            scaled = scale.scale_dm_sigma(
                p.params0, p.prep,
                torch.as_tensor(safe, device=p.device)).cpu().numpy()
            self.dm_error = np.where(np.isnan(raw_err), np.nan, scaled)
        else:
            self.dm_error = raw_err

    def calc_dm_resids(self, params=None):
        """Observed minus model DM [pc cm^-3] of every TOA, host numpy
        (NaN where a TOA has no DM measurement)."""
        p = self.prepared.params0 if params is None else params
        dm_model = wideband_dm_model(self.model, p, self.prepared.prep,
                                     batch=self.prepared.batch)
        return self.dm_observed - dm_model.cpu().numpy()

    @property
    def resids(self):
        return self.calc_dm_resids()[self.valid]

    @property
    def chi2(self):
        r = self.calc_dm_resids()
        return float(np.nansum((r[self.valid] / self.dm_error[self.valid])
                               ** 2))


class WidebandTOAResiduals:
    """Joint (time, DM) residuals (reference:
    residuals.py::WidebandTOAResiduals), on one ``prepared``."""

    def __init__(self, toas, model, prepared=None, device="cuda"):
        self.prepared = (prepared if prepared is not None
                         else model.prepare(toas, device=device))
        self.toa = Residuals(toas, model, prepared=self.prepared)
        self.dm = WidebandDMResiduals(toas, model, prepared=self.prepared)
        self.model = model
        self.toas = toas
        # per-component noise realizations a GLS-family fit attaches
        self.noise_resids = None

    @property
    def chi2(self):
        return self.toa.chi2 + self.dm.chi2

    @property
    def dof(self):
        return self.toa.dof + int(self.dm.valid.sum())

    @property
    def reduced_chi2(self):
        return self.chi2 / self.dof

    def rms_weighted(self):
        """Weighted RMS of the TIME residuals [s] (what summaries quote;
        the DM residuals carry other units)."""
        return self.toa.rms_weighted()

    def calc_time_resids(self, params=None):
        return self.toa.calc_time_resids(params)

    @property
    def time_resids(self):
        return self.toa.time_resids


class CombinedResiduals:
    """Concatenation of independent residual objects (reference:
    residuals.py::CombinedResiduals, which sums chi2/dof over
    datasets)."""

    def __init__(self, residual_list):
        self.residual_list = list(residual_list)

    @property
    def chi2(self):
        return float(sum(r.chi2 for r in self.residual_list))

    @property
    def dof(self):
        return int(sum(r.dof for r in self.residual_list))

    @property
    def reduced_chi2(self):
        d = self.dof
        return self.chi2 / d if d else float("nan")

    def calc_time_resids(self):
        """Every dataset's time residuals [s], concatenated on the host."""
        return np.concatenate([r.calc_time_resids().cpu().numpy()
                               for r in self.residual_list])
