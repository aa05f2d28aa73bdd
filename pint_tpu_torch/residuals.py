"""Residuals: model phase vs observed TOAs (narrowband).

Counterpart of the JAX package's ``residuals.py::Residuals``
(reference: src/pint/residuals.py::Residuals — calc_phase_resids with
nearest-integer or pulse-number tracking, optional weighted-mean
subtraction; calc_time_resids = phase/F0; chi2/dof/rms). The phase and
the sums run on ``device`` (torch f64); the numpy-facing properties
bring results back to the host. The wideband classes are not ported
(ROADMAP §1 item 5).
"""

from __future__ import annotations

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
