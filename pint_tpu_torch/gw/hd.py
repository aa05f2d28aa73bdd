"""Hellings–Downs overlap reduction + the frequentist optimal statistic
(counterpart of the JAX package's ``gw/hd.py``; host numpy around the
pair sweep of gw/correlate.py).

An isotropic GW background imprints on every pulsar pair (a, b) an
expected correlation E[rho_ab] = A^2 * Gamma(xi_ab), where Gamma is
the Hellings–Downs curve of the pair's angular separation xi. With the
pair products from gw/correlate.py (num = rho * den, den = 1/sigma^2
per pair) the standard frequentist optimal statistic is the
inverse-variance-weighted template fit

    A^2_hat = sum_ab Gamma * num / sum_ab Gamma^2 * den
    sigma(A^2_hat) = (sum_ab Gamma^2 * den)^(-1/2)
    S/N = sum_ab Gamma * num / sqrt(sum_ab Gamma^2 * den)

accumulated as scalars inside the streaming pair-block sweep — no
(P, P) matrix. "monopole" (Gamma = 1, clock-like errors) and "dipole"
(Gamma = cos xi, ephemeris-like errors) alternatives use the same
machinery, so an HD detection can be checked against the boring
explanations on identical data.

Significance is calibrated empirically with seeded null draws
(:func:`scramble_null`): sky scrambles redraw every pulsar's position
isotropically, phase shifts circularly slide each pulsar's lattice row.
Draw d uses ``np.random.default_rng([seed, d])``, the fixtures
``[seed, 0, 1]`` and ``[seed, 0, 2]``, exactly as the JAX package does,
so nulls and fixtures come out bit-identical to the reference's.

The statistic is one ``gw.os`` span and a scramble calibration one
``gw.scramble`` span; the registry counts ``gw.os_runs`` and
``gw.scramble_draws``, and with the fit-quality probes on the sweep's
pair coherence joins their ledger, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..obs import fitquality as obs_fitq
from ..obs import metricsreg
from ..obs import trace as obs_trace
from .correlate import correlation_sweep


def hd_curve(cos_xi):
    """Hellings–Downs Gamma(xi) from cos(xi) (any shape):
    Gamma = 1.5 x ln x - x/4 + 1/2 with x = (1 - cos xi)/2.
    Coincident distinct pulsars (x -> 0) take the limit 1/2; 90 deg
    gives about -0.1449 and 180 deg gives 1/4."""
    c = np.clip(np.asarray(cos_xi, np.float64), -1.0, 1.0)
    x = 0.5 * (1.0 - c)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = 1.5 * x * np.log(x) - 0.25 * x + 0.5
    return np.where(x > 0.0, out, 0.5)


_ORFS = {
    "hd": hd_curve,
    "monopole": lambda c: np.ones_like(np.asarray(c, np.float64)),
    "dipole": lambda c: np.clip(np.asarray(c, np.float64), -1.0, 1.0),
}


def _orf_fn(orf):
    try:
        return _ORFS[orf]
    except KeyError:
        raise ValueError(f"unknown orf {orf!r}; expected one of "
                         f"{sorted(_ORFS)}") from None


def optimal_statistic(lat, orf="hd", precision="f64", block=256,
                      z_limit=4.0, device="cuda"):
    """Frequentist optimal statistic over a
    :class:`~pint_tpu_torch.gw.residuals.GWLattice`: amplitude-squared
    estimate ``amp2`` (+ its ``sigma_amp2``), detection ``snr``, and
    per-pair coherence accounting (pairs whose normalized correlation
    ``num/sqrt(den)`` exceeds ``z_limit`` are counted incoherent). All
    accumulation happens inside the streaming pair sweep, which runs its
    products on ``device`` — scalars only."""
    pos = np.asarray(lat.pos, np.float64)
    fn = _orf_fn(orf)
    acc = {"s1": 0.0, "s2": 0.0, "n_eff": 0, "n_incoh": 0,
           "max_z": 0.0}

    def fold(a0, b0, num, den):
        ga = pos[a0:a0 + num.shape[0]]
        gb = pos[b0:b0 + num.shape[1]]
        G = fn(ga @ gb.T)
        acc["s1"] += float(np.sum(G * num))
        acc["s2"] += float(np.sum(G * G * den))
        ok = den > 0
        acc["n_eff"] += int(np.count_nonzero(ok))
        with np.errstate(invalid="ignore", divide="ignore"):
            zp = np.where(ok, num / np.sqrt(np.where(ok, den, 1.0)), 0.0)
        az = np.abs(zp)
        acc["max_z"] = max(acc["max_z"], float(az.max(initial=0.0)))
        acc["n_incoh"] += int(np.count_nonzero(az > z_limit))

    with obs_trace.span("gw.os", orf=orf, n_psr=lat.n_pulsars,
                        n_cells=lat.n_cells) as sp:
        stats = correlation_sweep(lat.z, lat.w, fold, block=block,
                                  precision=precision, device=device)
        s1, s2 = acc["s1"], acc["s2"]
        amp2 = s1 / s2 if s2 > 0 else None
        sigma_amp2 = float(1.0 / np.sqrt(s2)) if s2 > 0 else None
        snr = float(s1 / np.sqrt(s2)) if s2 > 0 else None
        metricsreg.REGISTRY.counter("gw.os_runs").inc()
        if obs_fitq.enabled():
            obs_fitq.FITQ.note_pair_coherence(
                acc["n_eff"], acc["n_incoh"], acc["max_z"])
        if obs_trace.enabled():
            sp.set(amp2=amp2, snr=snr, n_pairs=acc["n_eff"],
                   n_incoherent=acc["n_incoh"])
    return {"orf": orf, "amp2": amp2, "sigma_amp2": sigma_amp2,
            "snr": snr, "n_pairs": acc["n_eff"],
            "n_incoherent": acc["n_incoh"],
            "max_pair_snr": acc["max_z"], "sweep": stats}


def scramble_null(lat, n_draws=100, seed=0, mode="sky", orf="hd",
                  precision="f64", block=256, snr_obs=None, device="cuda"):
    """Empirical null distribution of the optimal-statistic S/N from
    ``n_draws`` seeded scrambles. mode="sky": redraw every pulsar
    position isotropically per draw — one pass over the (position-
    independent) pair products folds ALL draws at once, so the sweep
    cost does not scale with n_draws. mode="phase": circularly shift
    each pulsar's lattice row per draw (one sweep per draw).
    Draw d's generator is ``np.random.default_rng([seed, d])``; the
    returned ``snr_null`` array is bit-reproducible. p_value uses the
    standard (1 + exceedances) / (n_draws + 1) estimator against
    ``snr_obs`` (computed from the unscrambled lattice when not
    supplied)."""
    if mode not in ("sky", "phase"):
        raise ValueError(f"unknown scramble mode {mode!r}")
    if snr_obs is None:
        snr_obs = optimal_statistic(lat, orf=orf, precision=precision,
                                    block=block, device=device)["snr"]
    fn = _orf_fn(orf)
    P, M = lat.n_pulsars, lat.n_cells
    D = int(n_draws)
    s1 = np.zeros(D)
    s2 = np.zeros(D)
    with obs_trace.span("gw.scramble", mode=mode, n_draws=D, seed=seed,
                        orf=orf) as sp:
        if mode == "sky":
            vs = np.empty((D, P, 3))
            for d in range(D):
                rng = np.random.default_rng([seed, d])
                v = rng.standard_normal((P, 3))
                vs[d] = v / np.linalg.norm(v, axis=1, keepdims=True)

            def fold(a0, b0, num, den):
                va = vs[:, a0:a0 + num.shape[0]]
                vb = vs[:, b0:b0 + num.shape[1]]
                c = np.einsum("dak,dbk->dab", va, vb)
                G = fn(c)
                s1[...] += np.einsum("dab,ab->d", G, num)
                s2[...] += np.einsum("dab,ab->d", G * G, den)

            correlation_sweep(lat.z, lat.w, fold, block=block,
                              precision=precision, device=device)
        else:
            pos = np.asarray(lat.pos, np.float64)
            z0 = np.asarray(lat.z, np.float64)
            w0 = np.asarray(lat.w, np.float64)
            for d in range(D):
                rng = np.random.default_rng([seed, d])
                shifts = (rng.integers(1, M, size=P) if M > 1
                          else np.zeros(P, np.int64))
                zd = np.empty_like(z0)
                wd = np.empty_like(w0)
                for p in range(P):
                    zd[p] = np.roll(z0[p], shifts[p])
                    wd[p] = np.roll(w0[p], shifts[p])

                def fold(a0, b0, num, den, d=d):
                    ga = pos[a0:a0 + num.shape[0]]
                    gb = pos[b0:b0 + num.shape[1]]
                    G = fn(ga @ gb.T)
                    s1[d] += float(np.sum(G * num))
                    s2[d] += float(np.sum(G * G * den))

                correlation_sweep(zd, wd, fold, block=block,
                                  precision=precision, device=device)
        with np.errstate(invalid="ignore", divide="ignore"):
            snr_null = np.where(s2 > 0, s1 / np.sqrt(np.where(s2 > 0, s2, 1.0)),
                                0.0)
        if snr_obs is None:
            p_value = None
        else:
            exceed = int(np.count_nonzero(np.abs(snr_null) >= abs(snr_obs)))
            p_value = (1.0 + exceed) / (D + 1.0)
        metricsreg.REGISTRY.counter("gw.scramble_draws").inc(D)
        if obs_trace.enabled():
            sp.set(p_value=p_value, snr_obs=snr_obs)
    return {"mode": mode, "orf": orf, "n_draws": D, "seed": int(seed),
            "snr_null": snr_null, "snr_obs": snr_obs, "p_value": p_value}


def isotropic_positions(n, seed=0):
    """(n, 3) isotropic unit vectors — synthetic sky for benches and
    the injected fixture. The seed key [seed, 0, 1] is a distinct
    sub-stream from scramble_null's [seed, draw] draws: with a shared
    key, sky-scramble draw 0 would regenerate the TRUE sky and the
    null would contain the observed statistic by construction."""
    rng = np.random.default_rng([seed, 0, 1])
    v = rng.standard_normal((int(n), 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def inject_gwb(pos, n_cells, amplitude, seed=0, noise_sigma=1.0,
               n_modes=8):
    """Synthetic lattice with an HD-correlated signal of RMS
    ``amplitude`` injected over white noise — the amplitude-recovery
    fixture: ``optimal_statistic(...)["amp2"]`` estimates
    ``amplitude**2``.

    The inter-pulsar covariance is the HD matrix (unit diagonal plus
    a tiny jitter for the Cholesky); per-pulsar time series share
    ``n_modes`` random-phase unit-RMS sinusoids with HD-correlated
    mode amplitudes, so E[rho_ab] = amplitude^2 * Gamma_ab exactly as
    the OS assumes. Weights are the true inverse noise variance."""
    from .residuals import GWLattice

    pos = np.asarray(pos, np.float64)
    P = pos.shape[0]
    M = int(n_cells)
    # [seed, 0, 2]: decorrelated from both the scramble draws
    # ([seed, d]) and the synthetic sky ([seed, 0, 1])
    rng = np.random.default_rng([seed, 0, 2])
    C = hd_curve(pos @ pos.T)
    np.fill_diagonal(C, 1.0)
    C = C + 1e-6 * np.eye(P)
    L = np.linalg.cholesky(C)
    K = int(n_modes)
    t = (np.arange(M) + 0.5) / M
    phase = rng.uniform(0.0, 2.0 * np.pi, K)
    phi = np.sqrt(2.0) * np.cos(
        2.0 * np.pi * np.arange(1, K + 1)[:, None] * t[None, :]
        + phase[:, None])
    coef = (L @ rng.standard_normal((P, K))) / np.sqrt(K)
    signal = float(amplitude) * coef @ phi
    noise = float(noise_sigma) * rng.standard_normal((P, M))
    z = signal + noise
    w = np.full((P, M), 1.0 / float(noise_sigma) ** 2)
    labels = [f"SYN-{i:04d}" for i in range(P)]
    return GWLattice(labels, pos, z, w,
                     t_cells=np.arange(M, dtype=np.float64) + 0.5)
