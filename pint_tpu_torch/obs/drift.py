"""Drift sentinels: EWMA/CUSUM change detection (the JAX package's
``obs/drift.py``: EWMA, CUSUM and DriftSentinel).

A series that should be *boring* — here the standardized mean whitened
residual of each batch a streaming lane appends — is watched by an
:class:`EWMA`, which tracks its running baseline (mean + variance), and
a :class:`CUSUM`, which accumulates standardized deviations, so that
both sudden steps (one big z) and slow simmer (many small same-signed
z's) trip an alarm.
"""

from __future__ import annotations

import math


class EWMA:
    """Exponentially-weighted running mean/variance of one series.

    ``update(x)`` returns ``(z, ready)``: the standardized deviation
    of ``x`` against the *pre-update* baseline (None until ``min_n``
    warmup observations), then folds ``x`` in. The sigma carries a
    relative floor so a bitwise-constant series doesn't collapse to
    zero variance and alarm on the first ulp of float noise."""

    def __init__(self, alpha=0.2, min_n=8, rel_floor=1e-9):
        self.alpha = float(alpha)
        self.min_n = int(min_n)
        self.rel_floor = float(rel_floor)
        self.mean = None
        self.var = 0.0
        self.n = 0

    def sigma(self):
        if self.mean is None:
            return None
        return (math.sqrt(max(self.var, 0.0))
                + self.rel_floor * (abs(self.mean) + 1e-300))

    def update(self, x):
        x = float(x)
        z = None
        if self.n >= self.min_n:
            z = (x - self.mean) / self.sigma()
        if self.mean is None:
            self.mean = x
        else:
            delta = x - self.mean
            # West-style EW moments: variance first (it uses the old
            # mean's delta), then the mean
            self.var = (1.0 - self.alpha) * (self.var
                                             + self.alpha * delta * delta)
            self.mean += self.alpha * delta
        self.n += 1
        return z, z is not None


class CUSUM:
    """Two-sided standardized CUSUM: ``S+ = max(0, S+ + z - k)``,
    ``S- = max(0, S- - z - k)``; fires when either exceeds ``h``.
    ``k`` is the per-step drift allowance (in sigmas), ``h`` the
    accumulated-evidence threshold."""

    def __init__(self, k=0.5, h=6.0):
        self.k = float(k)
        self.h = float(h)
        self.pos = 0.0
        self.neg = 0.0

    def update(self, z):
        self.pos = max(0.0, self.pos + z - self.k)
        self.neg = max(0.0, self.neg - z - self.k)
        return self.pos > self.h or self.neg > self.h

    def reset(self):
        self.pos = 0.0
        self.neg = 0.0


class DriftSentinel:
    """One watched series: EWMA baseline + CUSUM accumulator + an
    immediate trip on a single huge step (``|z| >= z_trip``). On
    alarm the CUSUM resets (one alarm per episode, not one per
    round) while the EWMA keeps adapting toward the new level."""

    KIND = "DriftSentinel"
    VERSION = 1

    def __init__(self, alpha=0.2, min_n=8, k=0.5, h=6.0, z_trip=8.0):
        self.ewma = EWMA(alpha=alpha, min_n=min_n)
        self.cusum = CUSUM(k=k, h=h)
        self.z_trip = float(z_trip)
        self.alarms = 0

    def observe(self, x):
        """Feed one observation; returns an alarm dict or None."""
        baseline = self.ewma.mean
        z, ready = self.ewma.update(x)
        if not ready:
            return None
        fired = self.cusum.update(z) or abs(z) >= self.z_trip
        if not fired:
            return None
        self.alarms += 1
        alarm = {"baseline": baseline, "observed": float(x),
                 "z": round(z, 3), "cusum_pos": round(self.cusum.pos, 3),
                 "cusum_neg": round(self.cusum.neg, 3),
                 "n": self.ewma.n}
        self.cusum.reset()
        return alarm

    def state_dict(self):
        """Versioned state. The CUSUM accumulators are deliberately
        absent: restore re-anchors at the learned baseline with zero
        accumulated evidence (no post-restart alarm storm)."""
        return {"kind": self.KIND, "version": self.VERSION,
                "alpha": self.ewma.alpha, "min_n": self.ewma.min_n,
                "rel_floor": self.ewma.rel_floor,
                "mean": self.ewma.mean, "var": self.ewma.var,
                "n": self.ewma.n, "k": self.cusum.k, "h": self.cusum.h,
                "z_trip": self.z_trip, "alarms": self.alarms}

    def load_state_dict(self, state):
        if (state.get("kind") != self.KIND
                or state.get("version") != self.VERSION):
            raise ValueError(
                "not a %s v%d state: %r" % (
                    self.KIND, self.VERSION,
                    {k: state.get(k) for k in ("kind", "version")}))
        self.ewma = EWMA(alpha=state["alpha"], min_n=state["min_n"],
                         rel_floor=state.get("rel_floor", 1e-9))
        self.ewma.mean = state["mean"]
        self.ewma.var = float(state["var"])
        self.ewma.n = int(state["n"])
        self.cusum = CUSUM(k=state["k"], h=state["h"])
        self.z_trip = float(state["z_trip"])
        self.alarms = int(state.get("alarms", 0))
