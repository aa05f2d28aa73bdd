"""Numerically integrated ephemeris: fit, validation, artifact build.

The precision story (closing SURVEY.md section 2.1 "solar-system
ephemeris" as far as an offline environment allows):

- The analytic provider's Earth error is dominated by series
  truncation: the Meeus truncation of VSOP87D drops every term below
  ~1e-7 rad, a few hundred km of *real planetary perturbations*.
- Those dropped terms are dynamics, not free functions. A point-mass
  (+ solar 1PN) N-body integration (ephemeris/nbody.py) contains all
  of them automatically.
- So: fit the integration's per-body initial conditions (60
  parameters) to the truncated analytic series sampled over the pulsar
  timing span. A 6-parameter-per-body IC adjustment spans only
  secular + orbital-frequency modes over a ~66-year arc; the dropped
  terms live at planetary synodic frequencies, nearly orthogonal to
  that manifold. The fit therefore converges toward the true
  trajectory, and the fit residual *is* (mostly) the target's
  truncation error, left behind.

This is the same construction JPL uses for DE kernels — numerical
integration fit to (real) observations — with the analytic series
standing in for observations, because nothing better is reachable
offline. (reference: src/pint/solar_system_ephemerides.py simply loads
the JPL product of that pipeline.)

``injection_experiment()`` validates the mechanism with fully known
truth: inject synthetic longitude terms of known amplitude into the
Earth target and measure how much leaks into the fitted trajectory vs
a control fit. Measured (numeph_v1.json): short-period (synodic-band)
injections are 98.5% rejected — the regime of the production target's
truncation error — while a 628-yr term leaks ~50%, so the error budget
carries the long-period truncation tail at face value.

``build()`` writes the production artifact as a real little-endian
DAF/SPK type-2 kernel (io/spk_write.py) so the existing kernel path
(io/spk.py, including its native C++ Chebyshev evaluator) serves it
with zero new evaluation code, plus a JSON sidecar with fit residuals,
Chebyshev compression errors, and the injection evidence.

The port runs all of it on the host in numpy and scipy, as the JAX
package does (``nbody.py``); the validation reads the written kernel
through the port's own ``io/spk.py`` and ``_kernel_posvel`` chain.
``python -m pint_tpu_torch.ephemeris.numeph`` rebuilds the artifact in
``pint_tpu_torch/data/`` (about 10 minutes of one CPU core).
"""

from __future__ import annotations

import json
import time

import numpy as np

from . import analytic, nbody

SPAN_MJD = (40000.0, 64000.0)  # 1968-09 .. 2034-06
CENTER_MJD = 52000.0
_MJD_J2000 = 51544.5

# per-body target 1-sigma weights [m]: roughly the documented accuracy
# class of each body's analytic target (weights only matter through the
# weak inter-body coupling of the fit; the block structure is per-body)
SIGMA_M = {
    "sun": 1e6, "mercury": 5e6, "venus": 5e6, "earth": 3e5, "moon": 3e5,
    "mars": 1e7, "jupiter": 1e9, "saturn": 1e9, "uranus": 5e8,
    "neptune": 5e8,
}

# Finite-difference IC steps [m], [m/s]. The Earth-Moon pair needs
# far smaller steps than the heliocentric bodies: a 1e6 m change of
# either body's position perturbs the LUNAR semi-major axis at the
# 2.6e-3 level, whose mean-motion response wraps ~10 radians of lunar
# phase over the +-33 yr arc — a secant, not a derivative. 1e4 m /
# 1e-5 m/s keeps the end-of-arc lunar phase response < ~0.1 rad while
# staying ~1e6 x the shared-step integration noise.
_FD_STEP = {b: (1e6, 1e-3) for b in nbody.BODIES}
_FD_STEP["earth"] = _FD_STEP["moon"] = (1e4, 1e-5)


def sample_targets(mjd: np.ndarray, earth_min_amp: float = 0.0) -> np.ndarray:
    """(n_bodies, n_epochs, 3) analytic target positions [m] wrt SSB."""
    T = (np.asarray(mjd, dtype=np.float64) - _MJD_J2000) / 36525.0
    pos = analytic._all_positions_icrs(T, earth_min_amp=earth_min_amp)
    return np.stack([pos[b] for b in nbody.BODIES], axis=0)


def initial_state(center_mjd: float = CENTER_MJD):
    """Barycentric (pos0, vel0) initial guess from the analytic provider."""
    pos0 = np.zeros((len(nbody.BODIES), 3))
    vel0 = np.zeros((len(nbody.BODIES), 3))
    for i, b in enumerate(nbody.BODIES):
        p, v = analytic.body_posvel_ssb(b, np.array([center_mjd]))
        pos0[i], vel0[i] = p[0], v[0]
    return nbody.to_barycentric(pos0, vel0)


def _unpack(x: np.ndarray):
    n = len(nbody.BODIES)
    return x[: 3 * n].reshape(n, 3), x[3 * n:].reshape(n, 3)


def fit_ics(center_mjd: float = CENTER_MJD, span=SPAN_MJD,
            n_epochs: int = 1500, earth_min_amp: float = 0.0,
            iters: int = 4, rtol_jac: float = 1e-11,
            rtol_res: float = 1e-12, earth_target_extra=None,
            log=lambda s: None):
    """Gauss-Newton fit of all 60 initial-condition parameters.

    The Jacobian is built ONCE by finite differences — all 60 perturbed
    systems plus the base ride a single batched integration
    (nbody.integrate_batch), sharing step control so the FD noise is
    strongly correlated and cancels in the differences. It is then
    frozen across iterations (the problem is near-linear in ICs).

    Returns (pos0, vel0, info) with per-body weighted residual history.
    """
    bodies = nbody.BODIES
    n = len(bodies)
    epochs = np.linspace(span[0] + 0.5, span[1] - 0.5, n_epochs)
    targ = sample_targets(epochs, earth_min_amp)          # (n, E, 3)
    if earth_target_extra is not None:
        targ = targ.copy()
        targ[bodies.index("earth")] += earth_target_extra
    sig = np.array([SIGMA_M[b] for b in bodies])
    t_eval = (epochs - center_mjd) * 86400.0

    pos0, vel0 = initial_state(center_mjd)
    x = np.concatenate([pos0.ravel(), vel0.ravel()])
    deltas = np.concatenate(
        [np.repeat([_FD_STEP[b][0] for b in bodies], 3),
         np.repeat([_FD_STEP[b][1] for b in bodies], 3)])

    log(f"numeph fit: building 60-column FD Jacobian "
        f"({n_epochs} epochs x {n} bodies, rtol={rtol_jac})")
    t0 = time.time()
    B = 6 * n + 1
    pb = np.empty((B, n, 3))
    vb = np.empty((B, n, 3))
    pb[0], vb[0] = _unpack(x)
    for j in range(6 * n):
        xj = x.copy()
        xj[j] += deltas[j]
        pb[1 + j], vb[1 + j] = _unpack(xj)
    states = nbody.integrate_batch(pb, vb, 0.0, t_eval, rtol=rtol_jac)
    # residual vector ordering: (body, epoch, axis) / sigma_body
    base = states[0, 0]                                    # (n, 3, E)
    J = np.empty((n * len(epochs) * 3, 6 * n))
    w = np.repeat(1.0 / sig, len(epochs) * 3)
    for j in range(6 * n):
        dcol = (states[1 + j, 0] - base) / deltas[j]       # (n, 3, E)
        J[:, j] = dcol.transpose(0, 2, 1).ravel() * w
    log(f"numeph fit: Jacobian done in {time.time() - t0:.0f}s; iterating")

    def residual(xc):
        p, v = _unpack(xc)
        st = nbody.integrate_batch(p[None], v[None], 0.0, t_eval,
                                   rtol=rtol_res)
        model = st[0, 0].transpose(0, 2, 1)                # (n, E, 3)
        return (model - targ), model

    history = []
    model = None
    for it in range(iters):
        t0 = time.time()
        r, model = residual(x)
        rms = {b: float(np.sqrt(np.mean(r[i] ** 2)))
               for i, b in enumerate(bodies)}
        history.append(rms)
        log(f"numeph fit iter {it}: earth rms {rms['earth']:.0f} m, "
            f"moon {rms['moon']:.0f} m, jupiter {rms['jupiter']:.3g} m "
            f"({time.time() - t0:.0f}s)")
        rw = (r / sig[:, None, None]).ravel()
        dx, *_ = np.linalg.lstsq(J, -rw, rcond=None)
        x = x + dx
        if np.max(np.abs(dx)) < 1.0:  # < 1 m / 1 m/s: converged
            break
    r, model = residual(x)
    rms = {b: float(np.sqrt(np.mean(r[i] ** 2)))
           for i, b in enumerate(bodies)}
    history.append(rms)
    log(f"numeph fit final: earth rms {rms['earth']:.0f} m vs target")
    pos0, vel0 = _unpack(x)
    # re-barycenter (uniform Galilean shift: dynamics-invariant)
    pos0, vel0 = nbody.to_barycentric(pos0, vel0)
    info = {"rms_history_m": history, "final_rms_m": rms,
            "n_epochs": n_epochs, "span_mjd": list(span),
            "center_mjd": center_mjd, "earth_min_amp": earth_min_amp}
    return pos0, vel0, info


# SPK segments of the artifact: (target, center, record days, degree).
# Record lengths are set by each path's fastest angular content: the
# lunar month for the Earth/Moon-vs-EMB pair, the orbit for Mercury,
# and — easy to miss — the HALF-month solar-tide term on the EMB
# itself (the GM-weighted point oscillates at 13.6 d with ~16 m
# amplitude; a 32-day record cannot resolve it, which is why DE
# kernels also use 16-day EMB records). Degrees chosen so Chebyshev
# compression error is << the fit floor (validated at build time,
# recorded in the JSON sidecar).
_SEGMENTS = (
    (1, 0, 8.0, 13), (2, 0, 16.0, 13), (3, 0, 16.0, 13),
    (399, 3, 8.0, 13), (301, 3, 8.0, 13), (10, 0, 32.0, 11),
    (4, 0, 32.0, 13), (5, 0, 64.0, 13), (6, 0, 64.0, 13),
    (7, 0, 128.0, 11), (8, 0, 128.0, 11),
)
_BODY_IDX = {b: i for i, b in enumerate(nbody.BODIES)}


def _segment_states(target: int, center: int, y: np.ndarray):
    """(3, T) position [m] of an SPK (target, center) pair from full
    integrator states y of shape (6N, T)."""
    n = len(nbody.BODIES)
    pos = y[: 3 * n].reshape(n, 3, -1)
    gm_e = nbody.GM[_BODY_IDX["earth"]]
    gm_m = nbody.GM[_BODY_IDX["moon"]]
    emb = ((gm_e * pos[_BODY_IDX["earth"]]
            + gm_m * pos[_BODY_IDX["moon"]]) / (gm_e + gm_m))
    naif_to_body = {1: "mercury", 2: "venus", 4: "mars", 5: "jupiter",
                    6: "saturn", 7: "uranus", 8: "neptune", 10: "sun"}
    if (target, center) == (3, 0):
        return emb
    if (target, center) == (399, 3):
        return pos[_BODY_IDX["earth"]] - emb
    if (target, center) == (301, 3):
        return pos[_BODY_IDX["moon"]] - emb
    if center == 0 and target in naif_to_body:
        return pos[_BODY_IDX[naif_to_body[target]]]
    raise KeyError(f"no mapping for SPK pair ({target}, {center})")


def build(out_dir: str | None = None, span=SPAN_MJD, log=lambda s: None,
          with_injection: bool = True, fit_kwargs: dict | None = None,
          reuse_ics: bool = False):
    """Fit, validate, and write the numeph artifact.

    Produces ``numeph_v1.bsp`` (real DAF/SPK type 2, km units — served
    by io/spk.py like any JPL kernel) and ``numeph_v1.json`` (fit
    residuals, injection evidence, Chebyshev compression validation)
    in ``out_dir`` (default: pint_tpu_torch/data/).

    ``reuse_ics``: take the fitted initial conditions (and fit /
    injection metadata) from an existing sidecar instead of re-running
    the ~10-minute fit — for iterating on the compression/packaging
    stages only.
    """
    import os

    from ..io.spk import SPKKernel
    from ..io.spk_write import write_spk_type2

    if out_dir is None:
        out_dir = os.path.join(os.path.dirname(__file__), "..", "data")
    json_path = os.path.join(out_dir, "numeph_v1.json")
    meta: dict = {"version": 1, "span_mjd": list(span),
                  "bodies": list(nbody.BODIES)}
    pos0 = vel0 = None
    if reuse_ics and os.path.exists(json_path):
        with open(json_path) as fh:
            old = json.load(fh)
        if old.get("span_mjd") == list(span) and "ic_pos0_m" in old:
            pos0 = np.array(old["ic_pos0_m"])
            vel0 = np.array(old["ic_vel0_m_s"])
            for k in ("fit", "injection"):
                if k in old:
                    meta[k] = old[k]
            log("numeph build: reusing fitted ICs from existing sidecar")
    if pos0 is None:
        if with_injection:
            meta["injection"] = injection_experiment(span=span, log=log)
        pos0, vel0, info = fit_ics(span=span, log=log, **(fit_kwargs or {}))
        meta["fit"] = info
    # fitted barycentric ICs at CENTER_MJD: full provenance — the
    # artifact is reproducible from these + nbody.py alone
    meta["ic_pos0_m"] = pos0.tolist()
    meta["ic_vel0_m_s"] = vel0.tolist()
    log("numeph build: dense final integration (both directions)")
    t0 = time.time()
    # pad by the largest record length: ceil() record counts mean the
    # last record of a coarse segment (128-day Uranus/Neptune) extends
    # past span[1], and scipy's dense output would silently EXTRAPOLATE
    # there (a 1e8-m-discontinuous final
    # record before this pad)
    pad_s = max(days for _, _, days, _ in _SEGMENTS) * 86400.0
    back_s = (span[0] - CENTER_MJD) * 86400.0 - pad_s
    fwd_s = (span[1] - CENTER_MJD) * 86400.0 + pad_s
    traj = nbody.Trajectory(pos0, vel0, back_s, fwd_s, rtol=1e-13)
    log(f"numeph build: dense integration done ({time.time() - t0:.0f}s); "
        "Chebyshev compression")

    center_et = (CENTER_MJD - _MJD_J2000) * 86400.0
    init_et_all = (span[0] - _MJD_J2000) * 86400.0
    segments = []
    for target, center, days, deg in _SEGMENTS:
        intlen = days * 86400.0
        n_rec = int(np.ceil((span[1] - span[0]) / days))
        K = 2 * (deg + 1)
        s_nodes = np.cos(np.pi * (np.arange(K) + 0.5) / K)[::-1]
        P = np.linalg.pinv(np.polynomial.chebyshev.chebvander(s_nodes, deg))
        mids = init_et_all + (np.arange(n_rec) + 0.5) * intlen
        times_et = (mids[:, None] + (intlen / 2.0) * s_nodes[None, :])
        y = traj.state(times_et.ravel() - center_et)
        vals = _segment_states(target, center, y) / 1e3       # km
        Y = vals.reshape(3, n_rec, K).transpose(1, 2, 0)      # (rec, K, 3)
        coeffs = np.einsum("ck,rkx->rcx", P, Y).transpose(0, 2, 1)
        segments.append({"target": target, "center": center,
                         "init_et": init_et_all, "intlen_s": intlen,
                         "coeffs": coeffs})
    bsp_path = os.path.join(out_dir, "numeph_v1.bsp")
    write_spk_type2(bsp_path, segments)
    log(f"numeph build: wrote {bsp_path} "
        f"({os.path.getsize(bsp_path) / 1e6:.1f} MB); validating")

    # validation: kernel chain evaluation vs the integrator, off-node,
    # through the SAME chain table + summation the production path
    # uses (_CHAIN_TO_SSB/_kernel_posvel) so build-time validation and
    # runtime evaluation cannot drift apart
    from ..mjd import Epochs
    from . import _CHAIN_TO_SSB, _kernel_posvel

    kern = SPKKernel(bsp_path)
    rng = np.random.default_rng(3)
    mjd = rng.uniform(span[0] + 1, span[1] - 1, 500)
    et = (mjd - _MJD_J2000) * 86400.0
    y = traj.state(et - center_et)
    day = np.floor(mjd).astype(np.int64)
    epochs = Epochs(day, (mjd - day) * 86400.0, "tdb")
    val = {}
    nb = len(nbody.BODIES)
    for body in nbody.BODIES:
        if body not in _CHAIN_TO_SSB:
            continue
        pv = _kernel_posvel(kern, body, epochs)
        i = _BODY_IDX[body]
        direct_p = y[3 * i: 3 * i + 3].T
        direct_v = y[3 * nb + 3 * i: 3 * nb + 3 * i + 3].T
        val[body] = {
            "max_pos_err_m": float(np.abs(pv.pos - direct_p).max()),
            "max_vel_err_m_s": float(np.abs(pv.vel - direct_v).max()),
        }
        log(f"numeph validate {body}: cheb pos err "
            f"{val[body]['max_pos_err_m']:.2e} m, vel err "
            f"{val[body]['max_vel_err_m_s']:.2e} m/s")
    meta["cheb_validation"] = val
    with open(json_path, "w") as fh:
        json.dump(meta, fh, indent=1)
    log(f"numeph build: done -> {bsp_path}, {json_path}")
    return meta


def _injection_signal(epochs_mjd, terms, targ):
    """Synthetic along-track Earth-target error: sum of A*cos(phi+C*tau)
    longitude terms (VSOP-style units: A in 1e-8 rad, C in rad/Julian
    millennium), mapped to 3-D via the heliocentric tangential
    direction. (E, 3) metres."""
    tau = (epochs_mjd - _MJD_J2000) / 365250.0
    earth = targ[nbody.BODIES.index("earth")]
    sun = targ[nbody.BODIES.index("sun")]
    helio = earth - sun
    r = np.linalg.norm(helio, axis=1)
    tan = np.gradient(helio, axis=0)
    tan /= np.linalg.norm(tan, axis=1)[:, None]
    amp = np.zeros(len(epochs_mjd))
    for a_1e8, phase, c in terms:
        amp += (a_1e8 * 1e-8) * np.cos(phase + c * tau)
    return (amp * r)[:, None] * tan


# Injected test signals, deliberately OFF every VSOP87 line frequency.
# Short-period lane: synodic-style periods (0.8-1.6 yr) — the regime
# that dominates the production series' dropped tail. Long-period lane:
# a 628-yr term — the regime a 66-yr IC fit is expected to swallow.
_INJ_SP = ((300.0, 0.7, 5150.0), (300.0, 2.1, 7391.0), (300.0, 4.4, 3977.0))
_INJ_LP = ((300.0, 1.0, 10.0),)


def injection_experiment(span=SPAN_MJD, n_epochs: int = 900,
                         log=lambda s: None):
    """Measure how much of a KNOWN injected Earth-target error leaks
    into the fitted trajectory.

    Three fits on identical settings: control (unmodified targets), a
    short-period injection (~450 km rms of fake synodic-frequency
    longitude terms), and a long-period injection (~320 km rms of a
    fake 628-yr term). Leakage = rms(fit_injected - fit_control) /
    rms(injected signal), evaluated on an off-grid epoch set.

    This is the direct, fully-known-truth version of the 'fitting
    restores truncated dynamics' claim: the production target's
    truncation error is dominated by short-period terms, so its
    leakage matches the SP lane (expected ~5-15%); the LP lane
    documents the aliasing limitation honestly (expected ~100%, which
    is why the error budget carries the <37-km-per-term long-period
    tail in full).
    """
    eval_epochs = np.linspace(span[0] + 2.0, span[1] - 2.0, 777)
    fit_epochs = np.linspace(span[0] + 0.5, span[1] - 0.5, n_epochs)
    targ_fit = sample_targets(fit_epochs)
    targ_eval = sample_targets(eval_epochs)
    t_eval = (eval_epochs - CENTER_MJD) * 86400.0
    i_e = nbody.BODIES.index("earth")

    def earth_traj(pos0, vel0):
        st = nbody.integrate_batch(pos0[None], vel0[None], 0.0, t_eval,
                                   rtol=1e-12)
        return st[0, 0, i_e].T                      # (E, 3)

    log("injection experiment: control fit")
    p_c, v_c, info_c = fit_ics(span=span, n_epochs=n_epochs, log=log)
    ctrl = earth_traj(p_c, v_c)
    out = {"control_fit_rms_m": info_c["final_rms_m"],
           "n_epochs": n_epochs, "eval_epochs": len(eval_epochs)}
    for lane, terms in (("short_period", _INJ_SP), ("long_period", _INJ_LP)):
        inj_fit = _injection_signal(fit_epochs, terms, targ_fit)
        inj_eval = _injection_signal(eval_epochs, terms, targ_eval)
        inj_rms = float(np.sqrt(np.mean(np.sum(inj_eval**2, -1))))
        log(f"injection experiment: {lane} lane "
            f"({inj_rms:.0f} m rms injected)")
        p_i, v_i, _ = fit_ics(span=span, n_epochs=n_epochs,
                              earth_target_extra=inj_fit, log=log)
        leak = earth_traj(p_i, v_i) - ctrl
        leak_rms = float(np.sqrt(np.mean(np.sum(leak**2, -1))))
        out[lane] = {"terms": [list(t) for t in terms],
                     "injected_rms_m": inj_rms,
                     "leaked_rms_m": leak_rms,
                     "leakage_fraction": leak_rms / inj_rms}
        log(f"injection {lane}: {inj_rms:.0f} m in -> {leak_rms:.0f} m "
            f"leaked (fraction {leak_rms / inj_rms:.3f})")
    return out


if __name__ == "__main__":
    import sys

    t_start = time.time()
    build(log=lambda s: print(f"[numeph +{time.time() - t_start:6.0f}s] {s}",
                              file=sys.stderr, flush=True))
