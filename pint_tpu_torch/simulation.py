"""Simulation: zero-residual fake TOAs (host ingest numpy; the phase on
``device``).

Counterpart of the JAX package's ``simulation.py`` (reference:
src/pint/simulation.py — make_fake_toas_uniform /
make_fake_toas_fromMJDs / make_fake_toas_fromtim: iterate the
phase->time inversion until residuals vanish, then optionally add
Gaussian measurement noise and correlated noise realizations). Each
pass runs the host chain — clock corrections, UTC->TDB, posvels at the
observatory (``obs="gbt"`` by default) — then the phase on ``device``.
Tables are built with ``TOAs.from_arrays`` (no per-TOA objects).
``wideband=True`` attaches -pp_dm/-pp_dme measurements at the model DM,
drawn from the same generator in the JAX package's order.
:func:`calculate_random_models` draws parameter vectors from a fit's
covariance on the host (in the normalized space, as the reference
does) and evaluates their residuals on the fit's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import DTYPE, resolve_device
from .residuals import Residuals
from .toa import TOAs

def _refresh(toas: TOAs):
    toas.apply_clock_corrections()
    toas.compute_TDBs()
    toas.compute_posvels()
    return toas


def _iterate_zero_residuals(toas: TOAs, model, iterations=4, device="cuda"):
    """Shift TOA times until model residuals are ~0 (sub-ns): each pass
    runs clock -> TDB -> posvels on the host and the phase on
    ``device`` (reference: simulation.py's zero-residual iteration)."""
    for _ in range(iterations):
        _refresh(toas)
        r = Residuals(toas, model, subtract_mean=False, track_mode="nearest",
                      device=device)
        shift = r.calc_time_resids().cpu().numpy()
        toas.adjust_times(-shift)
    return _refresh(toas)


def _apply_noise(toas: TOAs, model, rng, white=True, correlated=False,
                 device="cuda"):
    """Add measurement-noise draws to the TOA times in place and refresh
    the derived columns. White draws are at the model-scaled
    uncertainty (EFAC/EQUAD applied), so simulated data matches what
    the fitter whitens with; correlated draws realize each noise
    component's (basis, weights) pair — ECORR per-epoch offsets and
    power-law red-noise Fourier amplitudes — as the GLS fit models them
    (reference: simulation.py add_correlated_noise)."""
    prepared = model.prepare(toas, device=device)
    delta_s = np.zeros(len(toas))
    if white:
        sigma_us = prepared.scaled_sigma_us().cpu().numpy()
        delta_s += rng.standard_normal(len(toas)) * sigma_us * 1e-6
    if correlated:
        for comp in model.components.values():
            bw = getattr(comp, "basis_weight", None)
            if bw is None:
                continue
            B, w_us2 = bw(prepared.params0, prepared.prep)
            B = B.cpu().numpy()
            w = w_us2.cpu().numpy()
            if B.size == 0:
                continue
            amps_us = rng.standard_normal(B.shape[1]) * np.sqrt(w)
            delta_s += (B @ amps_us) * 1e-6
    toas.adjust_times(delta_s)
    _refresh(toas)


def _check_wideband_args(model, dm_error_pccm3):
    """Fail fast (before the zero-residual iteration) on wideband
    requests the model or the arguments cannot satisfy."""
    if "DispersionDM" not in model.components:
        raise ValueError(
            "wideband=True needs a dispersion model (DM in the par "
            "file) to predict per-TOA DM values")
    if not (dm_error_pccm3 > 0):
        raise ValueError(
            f"dm_error_pccm3 must be > 0 (got {dm_error_pccm3}); the "
            "wideband fit whitens DM residuals by this uncertainty")


def _add_wideband_dm(toas: TOAs, model, rng, dm_error_pccm3, add_noise,
                     device="cuda"):
    """Attach wideband DM measurements (-pp_dm/-pp_dme flags) equal to
    the model's DM prediction (DMJUMPs included) on ``device``,
    scattered by ``dm_error_pccm3`` when ``add_noise`` (reference:
    simulation.py wideband=True)."""
    from .residuals import wideband_dm_model

    prepared = model.prepare(toas, device=device)
    dm_obs = wideband_dm_model(model, prepared.params0, prepared.prep,
                               batch=prepared.batch).cpu().numpy()
    if add_noise:
        dm_obs = dm_obs + rng.standard_normal(len(toas)) * dm_error_pccm3
    for fl, dv in zip(toas.flags, dm_obs):
        fl["pp_dm"] = repr(float(dv))
        fl["pp_dme"] = repr(float(dm_error_pccm3))


def _model_settings(model):
    ephem = "de440s"
    if "EPHEM" in model.params and model.EPHEM.value:
        ephem = model.EPHEM.value.lower()
    planets = ("PLANET_SHAPIRO" in model.params
               and bool(model.PLANET_SHAPIRO.value))
    return ephem, planets


def make_fake_toas_uniform(startMJD, endMJD, ntoas, model, error_us=1.0,
                           freq_mhz=1400.0, obs="gbt", add_noise=False,
                           add_correlated_noise=False, seed=None,
                           iterations=4, flags=None, wideband=False,
                           dm_error_pccm3=1e-4, fuzz_days=0.0,
                           device="cuda") -> TOAs:
    """(reference: simulation.py::make_fake_toas_uniform — ``fuzz_days``
    jitters the nominally uniform epochs by up to +/-fuzz_days/2 so
    simulated cadences don't alias)."""
    mjds = np.linspace(startMJD, endMJD, ntoas)
    if fuzz_days:
        fuzz_rng = np.random.default_rng(None if seed is None else seed + 1)
        mjds = np.sort(mjds + fuzz_rng.uniform(-fuzz_days / 2, fuzz_days / 2,
                                               ntoas))
    return make_fake_toas_fromMJDs(mjds, model, error_us=error_us,
                                   freq_mhz=freq_mhz, obs=obs,
                                   add_noise=add_noise,
                                   add_correlated_noise=add_correlated_noise,
                                   seed=seed, iterations=iterations,
                                   flags=flags, wideband=wideband,
                                   dm_error_pccm3=dm_error_pccm3,
                                   device=device)


def make_fake_toas(*args, **kw) -> TOAs:
    """Alias for :func:`make_fake_toas_uniform`
    (reference: simulation.py historical make_fake_toas name)."""
    return make_fake_toas_uniform(*args, **kw)


def make_fake_toas_fromMJDs(mjds, model, error_us=1.0, freq_mhz=1400.0,
                            obs="gbt", add_noise=False,
                            add_correlated_noise=False, seed=None,
                            iterations=4, flags=None, wideband=False,
                            dm_error_pccm3=1e-4, device="cuda") -> TOAs:
    """(reference: simulation.py::make_fake_toas_fromMJDs)

    Zero-residual TOAs at the UTC epochs ``mjds`` seen from ``obs``;
    ``flags`` (dict) is applied to every TOA before any noise draw.
    ``add_noise`` adds white noise at the model-scaled uncertainty and
    ``add_correlated_noise`` a realization of the model's correlated
    noise, drawn from ``numpy.random.default_rng(seed)``.
    ``wideband=True`` attaches per-TOA DM measurements as -pp_dm/-pp_dme
    flags at the model's DM (scattered by ``dm_error_pccm3`` when
    ``add_noise``). The phase and DM evaluations run on ``device``.
    """
    if wideband:
        _check_wideband_args(model, dm_error_pccm3)
    resolve_device(device)
    mjds = np.asarray(mjds, dtype=np.float64)
    # the JAX package's TOA(int(m), (m - int(m)) * 86400.0, ...) per row
    day = mjds.astype(np.int64)
    sec = (mjds - day) * 86400.0
    base_flags = {"simulated": "1",
                  **{k: str(v) for k, v in (flags or {}).items()}}
    ephem, planets = _model_settings(model)
    toas = TOAs.from_arrays(day, sec, error_us=error_us, freq_mhz=freq_mhz,
                            obs=obs, ephem=ephem, planets=planets,
                            flags=[dict(base_flags) for _ in range(len(day))])
    _iterate_zero_residuals(toas, model, iterations=iterations, device=device)
    rng = np.random.default_rng(seed)
    if add_noise or add_correlated_noise:
        _apply_noise(toas, model, rng, white=add_noise,
                     correlated=add_correlated_noise, device=device)
    if wideband:
        _add_wideband_dm(toas, model, rng, dm_error_pccm3, add_noise,
                         device=device)
    return toas


def make_fake_toas_fromtim(timfile, model, add_noise=False,
                           add_correlated_noise=False, seed=None,
                           wideband=False, dm_error_pccm3=1e-4,
                           device="cuda") -> TOAs:
    """(reference: simulation.py::make_fake_toas_fromtim)"""
    from .toa import read_tim_file

    if wideband:
        _check_wideband_args(model, dm_error_pccm3)
    resolve_device(device)
    toalist, _ = read_tim_file(str(timfile))
    ephem, planets = _model_settings(model)
    toas = TOAs(toalist, ephem=ephem, planets=planets)
    _iterate_zero_residuals(toas, model, device=device)
    rng = np.random.default_rng(seed)
    if add_noise or add_correlated_noise:
        _apply_noise(toas, model, rng, white=add_noise,
                     correlated=add_correlated_noise, device=device)
    if wideband:
        _add_wideband_dm(toas, model, rng, dm_error_pccm3, add_noise,
                         device=device)
    return toas


def calculate_random_models(fitter, toas, n_models=100, seed=None):
    """Sample models from the fit covariance; return residual spread [s]
    as a host array (n_models, n_toas).

    (reference: simulation.py::calculate_random_models) The draws are
    made on the host from ``np.random.default_rng(seed)`` in the
    column-normalized parameter space, as the reference does (its
    ``fac`` scaling): a covariance whose diagonal spans ~1e30 (F0, F1,
    DM) loses its small-variance directions to the SVD that
    ``multivariate_normal`` factors it with, so drawing from it
    directly, as the JAX package does, realizes the wrong covariance
    (ROADMAP §3). Each draw's residuals are evaluated on the fitter's
    device and the stack comes back in one copy."""
    rng = np.random.default_rng(seed)
    prepared = fitter.model.prepare(toas, device=fitter.device)
    x0 = prepared.vector_from_params().cpu().numpy()
    cov = np.asarray(fitter.parameter_covariance_matrix, dtype=np.float64)
    sd = np.sqrt(np.diag(cov))
    fac = np.where(sd > 0, sd, 1.0)
    covn = cov / np.outer(fac, fac)
    draws = x0 + rng.multivariate_normal(np.zeros(len(x0)), covn,
                                         size=n_models) * fac
    r = Residuals(toas, fitter.model, prepared=prepared)
    xs = torch.as_tensor(draws, dtype=DTYPE, device=prepared.device)
    out = [r.calc_time_resids(prepared.params_with_vector(x)) for x in xs]
    return torch.stack(out).cpu().numpy()
