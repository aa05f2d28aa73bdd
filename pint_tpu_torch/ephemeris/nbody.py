"""Newtonian + 1PN solar-system N-body integration (host-side, scipy).

Role: the dynamics engine behind the *numerically integrated ephemeris
tier* (ephemeris/numeph.py). The analytic fallback's dominant error is
series truncation — the Meeus truncation of VSOP87D drops every Earth
term below ~1e-7 rad, which costs a few hundred km (~1 ms Roemer
worst-case). Those dropped terms are real planetary perturbations, i.e.
*dynamics*: a direct numerical integration of the point-mass problem
contains all of them automatically. Fitting the integration's initial
conditions to the truncated analytic series (numeph.py) therefore
recovers physics the series dropped, because a 6-parameter-per-body
initial-condition adjustment cannot reproduce arbitrary periodic error
terms at planetary synodic frequencies — the fit converges toward the
true trajectory, not toward the truncated target.
(reference role: src/pint/solar_system_ephemerides.py evaluates JPL DE
kernels, which are themselves numerically integrated ephemerides fit to
observations; with no kernel obtainable offline, this module rebuilds
the same construction with the analytic series standing in for the
observations.)

Force model:
- Newtonian point masses: Sun, Mercury..Neptune, Earth and Moon as
  separate bodies (the Earth-Moon mutual term is what carries the
  4700 km monthly barycenter wobble).
- 1PN Schwarzschild acceleration from the Sun on every other body
  (harmonic gauge), with a mass-weighted recoil on the Sun so total
  momentum stays conserved. This is the part of the EIH equations that
  matters above the metre level for the inner system (Earth's GR
  perihelion drift alone is ~1800 km over a 66-yr arc if dropped).
- Omitted, with scale: asteroids (oscillatory forcing on Earth at the
  ~40 m level), planet-planet 1PN cross terms (<~m), Earth J2 on the
  Moon (~1e-5 deg/yr node drift), lunar tidal secular acceleration
  (~2.5 m over the span).

Integrator: scipy DOP853 (8th order, dense output), rtol ~1e-12; the
~24000-day span costs ~1 minute per direction on one CPU core and is
only ever run by the offline artifact build (numeph.py) and by short
invariant tests.
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp

from ..constants import C_M_S, GM_C3_S

BODIES = ("sun", "mercury", "venus", "earth", "moon", "mars",
          "jupiter", "saturn", "uranus", "neptune")
GM = np.array([GM_C3_S[b] * C_M_S**3 for b in BODIES])  # [m^3/s^2]
_SUN = 0
_C2 = C_M_S**2


def accel(pos: np.ndarray, vel: np.ndarray,
          gm: np.ndarray = GM) -> np.ndarray:
    """Barycentric accelerations [m/s^2] for (..., N, 3) states.

    Newtonian pairwise + Sun-Schwarzschild 1PN on each body with
    momentum-conserving solar recoil. Leading batch dimensions are
    supported (used to propagate all finite-difference Jacobian
    perturbations of the ephemeris fit in ONE integration).
    """
    n = pos.shape[-2]
    ii = np.arange(n)
    dr = pos[..., None, :, :] - pos[..., :, None, :]  # dr[i,j] = r_j - r_i
    d2 = np.sum(dr * dr, axis=-1)
    d2[..., ii, ii] = 1.0
    inv_d3 = d2 ** -1.5
    inv_d3[..., ii, ii] = 0.0
    a = np.einsum("j,...ijk,...ij->...ik", gm, dr, inv_d3)

    # 1PN Schwarzschild term from the Sun, heliocentric coordinates
    r = pos - pos[..., _SUN: _SUN + 1, :]
    v = vel - vel[..., _SUN: _SUN + 1, :]
    rn2 = np.sum(r * r, axis=-1)
    rn2[..., _SUN] = 1.0
    rn = np.sqrt(rn2)
    rv = np.sum(r * v, axis=-1)
    v2 = np.sum(v * v, axis=-1)
    gms = gm[_SUN]
    coef = gms / (_C2 * rn2 * rn)
    a_pn = coef[..., None] * ((4.0 * gms / rn - v2)[..., None] * r
                              + 4.0 * rv[..., None] * v)
    a_pn[..., _SUN, :] = 0.0
    a += a_pn
    # momentum-conserving recoil of the Sun
    a[..., _SUN, :] -= np.einsum("i,...ik->...k", gm, a_pn) / gms
    return a


def _rhs(t, y, gm, nbatch=1):
    n = len(gm)
    s = y.reshape(nbatch, 2, n, 3)
    return np.concatenate(
        [s[:, 1], accel(s[:, 0], s[:, 1], gm)], axis=1).ravel()


def energy_momentum(pos, vel, gm: np.ndarray = GM):
    """(Newtonian specific energy [m^2/s^2 * kg-equivalent], momentum,
    angular momentum) — conserved diagnostics for the Newtonian part.

    'Mass' here is GM/G-equivalent: quantities are G * the physical
    values, which is what is conserved to the same relative accuracy.
    """
    ke = 0.5 * np.sum(gm * np.sum(vel * vel, axis=-1))
    dr = pos[None, :, :] - pos[:, None, :]
    d = np.sqrt(np.sum(dr * dr, axis=-1))
    np.fill_diagonal(d, np.inf)
    pe = -0.5 * np.sum(gm[:, None] * gm[None, :] / d)
    mom = np.sum(gm[:, None] * vel, axis=0)
    ang = np.sum(gm[:, None] * np.cross(pos, vel), axis=0)
    return ke + pe, mom, ang


def to_barycentric(pos, vel, gm: np.ndarray = GM):
    """Shift states so the (Newtonian) center of mass is at rest at 0."""
    w = gm / gm.sum()
    return (pos - np.einsum("i,ik->k", w, pos),
            vel - np.einsum("i,ik->k", w, vel))


def integrate(pos0: np.ndarray, vel0: np.ndarray, t0_s: float,
              t1_s: float, gm: np.ndarray = GM, rtol: float = 1e-12,
              dense: bool = True):
    """Integrate from t0_s to t1_s (seconds, either direction).

    Returns the solve_ivp result; ``sol`` carries dense output when
    ``dense`` (positions in y[:3N], velocities in y[3N:]).
    """
    y0 = np.concatenate([pos0.ravel(), vel0.ravel()])
    n = len(gm)
    atol = np.concatenate([np.full(3 * n, 1e-2), np.full(3 * n, 1e-9)])
    out = solve_ivp(_rhs, (t0_s, t1_s), y0, method="DOP853", rtol=rtol,
                    atol=atol, dense_output=dense, args=(gm,))
    if not out.success:
        raise RuntimeError(f"N-body integration failed: {out.message}")
    return out


def integrate_batch(pos0: np.ndarray, vel0: np.ndarray, t0_s: float,
                    t_eval_s: np.ndarray, gm: np.ndarray = GM,
                    rtol: float = 1e-11) -> np.ndarray:
    """Integrate B independent copies of the system in one solve.

    pos0/vel0: (B, N, 3). Returns states (B, 2, N, 3, T) at the sorted
    ``t_eval_s`` epochs (seconds from t0_s; may span both directions —
    each direction is one solve). All copies share step-size control,
    so B perturbed systems cost barely more than one: this is what
    makes the 60-column finite-difference Jacobian of the ephemeris
    initial-condition fit affordable.
    """
    B, n = pos0.shape[0], len(gm)
    y0 = np.concatenate([pos0[:, None], vel0[:, None]], axis=1).ravel()
    atol = np.tile(np.concatenate([np.full((1, 3 * n), 1e-2),
                                   np.full((1, 3 * n), 1e-9)],
                                  axis=1).reshape(1, -1), (B, 1)).ravel()
    t_eval_s = np.asarray(t_eval_s, dtype=np.float64)
    out = np.empty((B, 2, n, 3, len(t_eval_s)))
    for sign in (-1.0, 1.0):
        mask = (t_eval_s < t0_s) if sign < 0 else (t_eval_s >= t0_s)
        if not np.any(mask):
            continue
        te = np.sort(t_eval_s[mask])[:: -1 if sign < 0 else 1]
        r = solve_ivp(_rhs, (t0_s, te[-1]), y0, method="DOP853",
                      rtol=rtol, atol=atol, t_eval=te,
                      args=(gm, B))
        if not r.success:
            raise RuntimeError(f"batch integration failed: {r.message}")
        ys = r.y.reshape(B, 2, n, 3, len(te))
        order = np.argsort(te)
        out[..., np.flatnonzero(mask)] = ys[..., order][
            ..., np.argsort(np.argsort(t_eval_s[mask]))]
    return out


class Trajectory:
    """Dense two-sided integration from a center epoch.

    ``posvel(body_index, t_s)`` evaluates position [m] / velocity [m/s]
    at seconds-from-center-epoch, vectorized.
    """

    def __init__(self, pos0, vel0, t_back_s, t_fwd_s,
                 gm: np.ndarray = GM, rtol: float = 1e-12):
        self.gm = gm
        self.n = len(gm)
        self._back = (integrate(pos0, vel0, 0.0, t_back_s, gm, rtol).sol
                      if t_back_s < 0 else None)
        self._fwd = (integrate(pos0, vel0, 0.0, t_fwd_s, gm, rtol).sol
                     if t_fwd_s > 0 else None)

    def state(self, t_s: np.ndarray) -> np.ndarray:
        """Full (6N, len(t)) state at seconds-from-center."""
        t = np.atleast_1d(np.asarray(t_s, dtype=np.float64))
        out = np.empty((6 * self.n, len(t)))
        neg = t < 0
        if np.any(neg):
            out[:, neg] = self._back(t[neg])
        if np.any(~neg):
            out[:, ~neg] = self._fwd(t[~neg])
        return out

    def posvel(self, i: int, t_s: np.ndarray):
        y = self.state(t_s)
        pos = y[3 * i: 3 * i + 3].T
        vel = y[3 * self.n + 3 * i: 3 * self.n + 3 * i + 3].T
        return pos, vel
