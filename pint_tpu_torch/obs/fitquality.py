"""Fit-quality probes: numerical-health telemetry for every fit (the
JAX package's ``obs/fitquality.py``).

This module watches *how well* the stack fits. Every GLS/WLS finalize
already pulls chi2, the normalized covariance and the mixed
refinement residual to the host for its own branch decisions (the
fleet's ``PTABatch._finalize_gls`` makes one device->host copy of
them); the probes here are pure-numpy reductions over those same
host arrays, so they cost no extra device round-trip and cannot
perturb the fit (bitwise preservation is pinned by
tests/test_torch_fitquality.py and by ``chip_smoke.py``'s ``[fitq]``).

Per-fit probes:

- whitened reduced chi2 with a Wilson–Hilferty z-score against the
  chi2(dof) distribution (``> ~5`` means the noise model is lying);
- a condition-number estimate of the normalized Gram parameter block
  from the eigenvalue spread of the normalized covariance;
- the mixed-precision refinement residual + fallback flags (the
  ``relres_failed`` verdict that triggers the f64 refit);
- solver divergence flags (lanes ``_isolate_diverged`` restored) —
  each one also triggers a ``reason="fit_anomaly"`` flight dump naming
  the pulsar, the failing probe, and its baseline value;
- normalized-residual moments/outlier counts where whitened
  residuals are host-side (the single-pulsar fitter path).

Everything lands per pulsar in the process :data:`FITQ`
:class:`FitQualityLedger`, off by default: call sites guard on
:func:`enabled` so the disabled cost is one attribute check. The
ledger snapshot feeds the ``fit_quality`` SLO pack
(:func:`fit_quality_slos`), Prometheus exposition via
:func:`export_metrics`, and the point-in-time gate
:func:`check_report`.
"""

from __future__ import annotations

import math
import threading

import numpy as np

from . import clock as obs_clock
from . import metricsreg
from . import recorder as obs_recorder
from .slo import SLOSpec

_ENABLED = False


def enable():
    """Turn fit-quality probing on (process-wide, like obs.enable)."""
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def enabled():
    return _ENABLED


# -- probe math --------------------------------------------------------


def chi2_zscore(chi2, dof):
    """Wilson–Hilferty z-score of ``chi2`` against a chi2(dof)
    distribution: the cube root of a chi2/dof draw is ~normal with
    mean ``1 - 2/(9 dof)`` and sigma ``sqrt(2/(9 dof))``, accurate to
    a few percent for dof >= ~5. Vectorized; NaN where dof <= 0 or
    chi2 is non-finite (a diverged lane stays visibly NaN rather than
    masquerading as a huge-but-finite z)."""
    chi2 = np.asarray(chi2, dtype=np.float64)
    dof = np.asarray(dof, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        safe = np.where(dof > 0, dof, np.nan)
        mu = 1.0 - 2.0 / (9.0 * safe)
        sigma = np.sqrt(2.0 / (9.0 * safe))
        z = (np.cbrt(chi2 / safe) - mu) / sigma
    return z


def condition_from_covn(covn):
    """Condition-number estimate of the normalized Gram parameter
    block from the eigenvalue spread of the *normalized* covariance
    ``covn`` (shape ``(k, k)`` or ``(P, k, k)``). covn is the inverse
    of the column-normalized Gram, so its eigenvalue ratio equals the
    Gram's own condition number — without re-pulling or re-forming
    the Gram. Returns inf for a semidefinite block and NaN where the
    input is non-finite (diverged lanes)."""
    covn = np.asarray(covn, dtype=np.float64)
    single = covn.ndim == 2
    if single:
        covn = covn[None]
    out = np.full(covn.shape[0], np.nan)
    finite = np.all(np.isfinite(covn), axis=(1, 2))
    if np.any(finite):
        try:
            w = np.linalg.eigvalsh(covn[finite])  # ascending per row
        except np.linalg.LinAlgError:
            w = None
        if w is not None:
            tiny = np.finfo(np.float64).tiny
            with np.errstate(divide="ignore", invalid="ignore"):
                cond = np.where(w[:, 0] > 0,
                                w[:, -1] / np.maximum(w[:, 0], tiny),
                                np.inf)
            out[finite] = cond
    return out[0] if single else out


def residual_moments(rw, outlier_z=3.5):
    """Moments of a whitened (unit-variance-expected) residual
    vector: mean, std, skew, excess kurtosis, and the count of
    ``|r| > outlier_z`` outliers. Host-side only — used where the
    whitened residuals already exist on the host (the single-pulsar
    fitter path), never worth a device pull of its own."""
    rw = np.asarray(rw, dtype=np.float64).ravel()
    rw = rw[np.isfinite(rw)]
    n = rw.size
    if n == 0:
        return {"n": 0, "mean": None, "std": None, "skew": None,
                "kurtosis": None, "n_outliers": 0}
    mean = float(np.mean(rw))
    std = float(np.std(rw))
    if std > 0:
        zc = (rw - mean) / std
        skew = float(np.mean(zc ** 3))
        kurt = float(np.mean(zc ** 4) - 3.0)
    else:
        skew = kurt = 0.0
    return {"n": int(n), "mean": mean, "std": std, "skew": skew,
            "kurtosis": kurt,
            "n_outliers": int(np.count_nonzero(np.abs(rw) > outlier_z))}


# -- ledger ------------------------------------------------------------


class FitQualityLedger:
    """Per-pulsar record of the latest fit-quality probes plus
    cumulative health counters (fits / fallbacks / divergences /
    drift alarms) and running worst-case aggregates — the snapshot
    shape the SLO five-pack and the Prometheus gauges read.
    Thread-safe: fleet buckets finalize from the pipeline thread
    while other threads may record too."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pulsars = {}
        self.fits = 0
        self.fallbacks = 0
        self.diverged = 0
        self.drift_alarms = 0
        self.pairs_probed = 0
        self.pairs_incoherent = 0
        self.probe_wall_s = 0.0
        self.max_abs_chi2_z = None
        self.max_condition = None
        self.max_relres = None
        self.max_pair_snr = None

    def _fold_max(self, attr, value):
        if value is None or not math.isfinite(value):
            return
        cur = getattr(self, attr)
        if cur is None or value > cur:
            setattr(self, attr, float(value))

    def record(self, label, probes):
        """Fold one pulsar's probe dict in (latest wins per pulsar;
        counters and worst-case aggregates accumulate)."""
        self.record_many([str(label)], [dict(probes)])

    def record_many(self, labels, probes_list):
        """Batched :meth:`record`: one lock acquisition for a whole
        bucket — the per-pulsar Python loop is the probe path's hot
        spot, and the <1% overhead contract is won or lost here."""
        with self._lock:
            for label, probes in zip(labels, probes_list):
                self._pulsars[label] = probes
                self.fits += 1
                if probes.get("diverged"):
                    self.diverged += 1
                # fallbacks are counted at the fallback DECISION via
                # note_fallback (the f64 re-run re-records these
                # pulsars; counting the flag here would double-book)
                z = probes.get("chi2_z")
                if z is not None:
                    self._fold_max("max_abs_chi2_z", abs(z))
                self._fold_max("max_condition", probes.get("condition"))
                self._fold_max("max_relres", probes.get("relres"))

    def annotate(self, label, **extra):
        """Merge extra probe fields into a pulsar's latest record
        without touching any counter — e.g. residual moments, which
        only the single-pulsar path can compute host-side."""
        with self._lock:
            self._pulsars.setdefault(str(label), {}).update(extra)

    def note_fallback(self, labels):
        """Count a mixed-precision f64 fallback for each label —
        called at the fallback decision, before the f64 re-run
        re-records the affected pulsars."""
        with self._lock:
            self.fallbacks += len(list(labels))

    def note_drift_alarm(self, label, probe):
        with self._lock:
            self.drift_alarms += 1

    def note_pair_coherence(self, n_pairs, n_incoherent,
                            max_abs_snr=None):
        """Fold one GW pair-correlation sweep's coherence census in:
        ``n_pairs`` probed cross-pairs, of which ``n_incoherent``
        exceeded the per-pair |num/sqrt(den)| z-limit (an incoherent
        pair means one of the two pulsars' noise models is lying —
        the pair analog of the chi2 z probe). Feeds the
        ``gw_coherence`` SLO in :func:`fit_quality_slos`."""
        with self._lock:
            self.pairs_probed += int(n_pairs)
            self.pairs_incoherent += int(n_incoherent)
            if max_abs_snr is not None:
                self._fold_max("max_pair_snr", float(max_abs_snr))

    def note_probe_wall(self, wall_s):
        with self._lock:
            self.probe_wall_s += float(wall_s)

    def get(self, label):
        with self._lock:
            rec = self._pulsars.get(str(label))
            return dict(rec) if rec is not None else None

    def snapshot(self):
        """JSON-safe ledger state: cumulative counters, worst-case
        aggregates, and the latest per-pulsar probe dicts."""
        with self._lock:
            return {
                "counters": {"fits": self.fits,
                             "fallbacks": self.fallbacks,
                             "diverged": self.diverged,
                             "drift_alarms": self.drift_alarms,
                             "pairs_probed": self.pairs_probed,
                             "pairs_incoherent":
                                 self.pairs_incoherent},
                "max_abs_chi2_z": self.max_abs_chi2_z,
                "max_condition": self.max_condition,
                "max_relres": self.max_relres,
                "max_pair_snr": self.max_pair_snr,
                "probe_wall_s": self.probe_wall_s,
                "n_pulsars": len(self._pulsars),
                "pulsars": {k: dict(v)
                            for k, v in self._pulsars.items()},
            }

    def reset(self):
        with self._lock:
            self._pulsars.clear()
            self.fits = self.fallbacks = self.diverged = 0
            self.drift_alarms = 0
            self.pairs_probed = self.pairs_incoherent = 0
            self.probe_wall_s = 0.0
            self.max_abs_chi2_z = None
            self.max_condition = None
            self.max_relres = None
            self.max_pair_snr = None

    # -- checkpointable state -----------------------------------------

    STATE_KIND = "FitQualityLedger"
    STATE_VERSION = 1

    def state_dict(self):
        """Versioned JSON-safe restartable state: the cumulative
        counters, worst-case aggregates, and latest per-pulsar probes
        — everything a recovered serving process needs so its quality
        SLOs and dashboards resume instead of forgetting history."""
        with self._lock:
            return {"kind": self.STATE_KIND,
                    "version": self.STATE_VERSION,
                    "counters": {"fits": self.fits,
                                 "fallbacks": self.fallbacks,
                                 "diverged": self.diverged,
                                 "drift_alarms": self.drift_alarms,
                                 "pairs_probed": self.pairs_probed,
                                 "pairs_incoherent":
                                     self.pairs_incoherent},
                    "probe_wall_s": self.probe_wall_s,
                    "max_abs_chi2_z": self.max_abs_chi2_z,
                    "max_condition": self.max_condition,
                    "max_relres": self.max_relres,
                    "max_pair_snr": self.max_pair_snr,
                    "pulsars": {k: dict(v)
                                for k, v in self._pulsars.items()}}

    def load_state_dict(self, state):
        if (state.get("kind") != self.STATE_KIND
                or state.get("version") != self.STATE_VERSION):
            raise ValueError(
                "not a %s v%d state: %r" % (
                    self.STATE_KIND, self.STATE_VERSION,
                    {k: state.get(k) for k in ("kind", "version")}))
        counters = state.get("counters", {})
        with self._lock:
            self._pulsars = {str(k): dict(v)
                             for k, v in state.get("pulsars", {}).items()}
            self.fits = int(counters.get("fits", 0))
            self.fallbacks = int(counters.get("fallbacks", 0))
            self.diverged = int(counters.get("diverged", 0))
            self.drift_alarms = int(counters.get("drift_alarms", 0))
            # pair-coherence fields postdate v1 states on disk: .get
            # defaults keep old journals loadable without a version
            # bump (additive-only change)
            self.pairs_probed = int(counters.get("pairs_probed", 0))
            self.pairs_incoherent = int(
                counters.get("pairs_incoherent", 0))
            self.probe_wall_s = float(state.get("probe_wall_s", 0.0))
            self.max_abs_chi2_z = state.get("max_abs_chi2_z")
            self.max_condition = state.get("max_condition")
            self.max_relres = state.get("max_relres")
            self.max_pair_snr = state.get("max_pair_snr")


FITQ = FitQualityLedger()


def _finite_list(arr, n):
    """Host floats with NaN/inf replaced by None, length n: one C
    tolist() pass instead of n numpy scalar conversions."""
    a = np.asarray(arr, dtype=np.float64).reshape(-1)
    if a.size == 1 and n > 1:
        a = np.broadcast_to(a, (n,))
    return [v if math.isfinite(v) else None for v in a[:n].tolist()]


def record_fit_batch(labels, chi2, dof, covn=None, relres=None,
                     method=None, precision=None, maxiter=None,
                     fell_back=False, diverged=(), ledger=None,
                     source=None, recorder=None):
    """Probe one batched fit from its already-pulled host arrays and
    record every pulsar in the ledger. Returns the bucket-level
    summary dict (worst |chi2 z|, worst condition, counts) that
    ``PTAFleet.fit_quality`` keeps per bucket.

    ``fell_back`` is one flag for the batch or one per lane (the lanes
    a mixed fit refit in f64). ``diverged`` lanes additionally dump a
    ``reason="fit_anomaly"`` flight record naming the pulsar, the
    failing probe (``chi2_whitened``), and the baseline the observation
    violated (the dof — the expectation of a healthy whitened chi2).

    Pure host numpy over arrays the finalize already materialized:
    no device interaction, so the fit stays bitwise identical. Its
    own wall cost is self-timed into ``ledger.probe_wall_s`` (the
    <1% overhead contract's measured numerator)."""
    t0 = obs_clock.now()
    ledger = FITQ if ledger is None else ledger
    rec = obs_recorder.RECORDER if recorder is None else recorder
    labels = [str(x) for x in labels]
    n = len(labels)
    chi2 = np.asarray(chi2, dtype=np.float64).reshape(-1)[:n]
    dof = np.broadcast_to(
        np.asarray(dof, dtype=np.float64).reshape(-1), (n,)) \
        if np.ndim(dof) else np.full(n, float(dof))
    z = chi2_zscore(chi2, dof)
    cond = (condition_from_covn(covn) if covn is not None
            else np.full(n, np.nan))
    cond = np.asarray(cond, dtype=np.float64).reshape(-1)[:n]
    with np.errstate(invalid="ignore", divide="ignore"):
        red = np.where(dof > 0, chi2 / np.where(dof > 0, dof, 1.0),
                       np.nan)
    div = set(int(i) for i in diverged)
    chi2_l = _finite_list(chi2, n)
    dof_l = _finite_list(dof, n)
    red_l = _finite_list(red, n)
    z_l = _finite_list(z, n)
    cond_l = _finite_list(cond, n)
    rel_l = (_finite_list(relres, n) if relres is not None
             else [None] * n)
    # one flag for the batch, or one per lane (the lanes a mixed fit
    # refit in f64)
    fell = np.broadcast_to(np.asarray(fell_back, dtype=bool).reshape(-1),
                           (n,))
    records = []
    for i in range(n):
        records.append({
            "chi2": chi2_l[i],
            "dof": dof_l[i],
            "reduced_chi2": red_l[i],
            "chi2_z": z_l[i],
            "condition": cond_l[i],
            "relres": rel_l[i],
            "fell_back": bool(fell[i]),
            "diverged": i in div,
            "method": method,
            "precision": precision,
            "maxiter": maxiter,
        })
    ledger.record_many(labels, records)
    for i in sorted(div):
        if i < n:
            rec.dump("fit_anomaly", source=source or "fitquality",
                     pulsar=labels[i], probe="chi2_whitened",
                     baseline=float(dof[i]),
                     observed=float(chi2[i]), method=method,
                     detail="solver divergence isolated")
    finite_z = z[np.isfinite(z)]
    finite_c = cond[np.isfinite(cond)]
    summary = {
        "fitq_n": n,
        "fitq_max_abs_chi2_z": (round(float(np.max(np.abs(finite_z))), 3)
                                if finite_z.size else None),
        "fitq_max_condition": (float(np.max(finite_c))
                               if finite_c.size else None),
        "fitq_diverged": len(div),
        "fitq_fell_back": bool(np.any(fell_back)),
    }
    ledger.note_probe_wall(obs_clock.now() - t0)
    return summary


# -- SLOs / report gate ------------------------------------------------


def _fq(snapshot):
    """The fit_quality section of an engine snapshot, or the dict
    itself when handed a bare ledger snapshot."""
    if not isinstance(snapshot, dict):
        return {}
    sect = snapshot.get("fit_quality")
    return sect if isinstance(sect, dict) else snapshot


def fit_quality_slos(chi2_z_limit=6.0, condition_limit=1e12,
                     chi2_budget=0.05, fallback_budget=0.05,
                     divergence_budget=0.02, condition_budget=0.05,
                     drift_budget=0.05, coherence_budget=0.05,
                     **window_kw):
    """The fit_quality SLO pack over ledger/engine snapshots: chi2
    z-score ceiling, mixed-fallback rate, divergence rate,
    condition-number ceiling, drift-alarm rate, and the GW pair
    incoherence rate (pairs whose normalized cross-correlation blew
    past the z-limit in the last optimal-statistic sweep — see
    :meth:`FitQualityLedger.note_pair_coherence`). Budgets keep
    ``1/budget > fast_burn`` (default 14.4x) so every alert is
    reachable by a burn-rate monitor's fast window."""

    def counter(name):
        return lambda s: (_fq(s).get("counters") or {}).get(name, 0)

    return [
        SLOSpec("fitq_chi2_z", chi2_budget,
                value=lambda s: _fq(s).get("max_abs_chi2_z"),
                limit=chi2_z_limit, **window_kw),
        SLOSpec("fitq_fallback", fallback_budget,
                bad=counter("fallbacks"), total=counter("fits"),
                **window_kw),
        SLOSpec("fitq_divergence", divergence_budget,
                bad=counter("diverged"), total=counter("fits"),
                **window_kw),
        SLOSpec("fitq_condition", condition_budget,
                value=lambda s: _fq(s).get("max_condition"),
                limit=condition_limit, **window_kw),
        SLOSpec("fitq_drift", drift_budget,
                bad=counter("drift_alarms"), total=counter("fits"),
                **window_kw),
        SLOSpec("gw_coherence", coherence_budget,
                bad=counter("pairs_incoherent"),
                total=counter("pairs_probed"), **window_kw),
    ]


def check_report(snapshot, chi2_z_limit=6.0, condition_limit=1e12,
                 fallback_budget=0.05, divergence_budget=0.02,
                 drift_limit=0):
    """Point-in-time fit-quality verdict over a ledger (or engine)
    snapshot (the JAX package's ``obs fitq`` / ``obs doctor`` gate).
    Returns
    ``{"ok": bool, "violations": [...], "checked": {...}}``; a
    snapshot with no recorded fits passes vacuously (nothing ran,
    nothing degraded)."""
    fq = _fq(snapshot)
    counters = fq.get("counters") or {}
    fits = counters.get("fits") or 0
    violations = []

    def check(name, value, limit, kind="max"):
        if value is None or limit is None:
            return
        if value > limit:
            violations.append({"probe": name, "observed": value,
                               "limit": limit, "kind": kind})

    check("chi2_z", fq.get("max_abs_chi2_z"), chi2_z_limit)
    check("condition", fq.get("max_condition"), condition_limit)
    if fits:
        check("fallback_rate",
              (counters.get("fallbacks") or 0) / fits,
              fallback_budget, kind="rate")
        check("divergence_rate",
              (counters.get("diverged") or 0) / fits,
              divergence_budget, kind="rate")
    check("drift_alarms", counters.get("drift_alarms") or 0,
          drift_limit, kind="count")
    return {
        "ok": not violations,
        "violations": violations,
        "checked": {"fits": fits,
                    "max_abs_chi2_z": fq.get("max_abs_chi2_z"),
                    "max_condition": fq.get("max_condition"),
                    "max_relres": fq.get("max_relres"),
                    "drift_alarms": counters.get("drift_alarms") or 0},
    }


def export_metrics(registry=None, ledger=None, prefix="fitq."):
    """Absorb the ledger aggregates (not the per-pulsar dicts — the
    gauge surface stays O(1) in fleet size) into a metrics registry
    for Prometheus exposition. Returns the absorbed snapshot."""
    reg = metricsreg.REGISTRY if registry is None else registry
    ledger = FITQ if ledger is None else ledger
    snap = ledger.snapshot()
    snap.pop("pulsars", None)
    reg.absorb(snap, prefix=prefix)
    return snap


def reset():
    """Reset the process ledger (between measured runs and tests)."""
    FITQ.reset()
