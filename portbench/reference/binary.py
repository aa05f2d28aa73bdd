"""Binary delays from the published models, in plain PyTorch f64.

The delay is evaluated at the pulsar's emission-frame time t, which is
the barycentric time t_b less the delays before it (``accum``) less the
binary delay itself: D = D(t_b - D), solved by fixed-point iteration to
convergence (each pass gains a factor ~ n x, 1e-4 here).

- ELL1 (Lange et al. 2001): with Phi = 2 pi (t - TASC) / PB,
  Roemer x [sin Phi - (EPS1 cos 2Phi - EPS2 sin 2Phi) / 2],
  Shapiro -2 r ln(1 - s sin Phi), r = T_sun M2, s = SINI.
- ELL1H (Freire & Wex 2010): ELL1 with s = 2 sigma / (1 + sigma^2),
  r = H3 / sigma^3, sigma = STIGMA.
- DD (Damour & Deruelle 1986, eqs. 26, 46-52): mean anomaly
  2 pi (t - T0) / PB, Kepler's equation for u, true anomaly nu,
  omega = OM; Roemer x sin(omega) (cos u - e) + x cos(omega)
  sqrt(1 - e^2) sin u, Einstein GAMMA sin u, Shapiro
  -2 r ln(1 - e cos u - s [sin omega (cos u - e) + sqrt(1 - e^2)
  cos omega sin u]), aberration A0 (sin(omega + nu) + e sin omega) +
  B0 (cos(omega + nu) + e cos omega).

Times are seconds from the model's epoch parameter (TASC or T0, an MJD
in TDB), from the TDB day and f64 seconds; see ``Binary`` for how the
mean anomaly keeps its precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TSUN_S = 4.925490947000518e-06
SECS_PER_DAY = 86400.0
ITERATIONS = 6
KEPLER_ITERATIONS = 12


class Binary:
    """The mean anomaly 2 pi (t - epoch) / PB is split as the phase is
    (``timing.Model.residual_s``): the orbit count at the par file's
    epoch and PB in longdouble, reduced to its fraction; the change of
    PB and of the epoch, and the delays before the binary, in f64.
    (These fleets have no PBDOT.)"""

    epoch = "T0"

    def __init__(self, par, psr, device="cpu"):
        self.par = par
        self.device = device
        self.ep_ref = par.values[self.epoch]
        self.pb_ref = par.values["PB"]
        day = math.floor(self.ep_ref)
        hi = (psr.tdb_day - day).astype(np.float64) * SECS_PER_DAY
        lo = psr.tdb_sec - (self.ep_ref - day) * SECS_PER_DAY
        dt = np.longdouble(1) * hi + lo.astype(np.longdouble)
        norb = dt / (np.longdouble(self.pb_ref) * np.longdouble(SECS_PER_DAY))
        self.frac = torch.as_tensor((norb - np.floor(
            norb + np.longdouble(0.5))).astype(np.float64), device=device)
        self.t = torch.as_tensor(hi + lo, device=device)

    def anomaly(self, v, accum):
        """Mean anomaly [rad] at t - accum."""
        pb = v("PB")
        dinv = (self.pb_ref - pb) / (pb * self.pb_ref * SECS_PER_DAY)
        shift = accum + (v(self.epoch) - self.ep_ref) * SECS_PER_DAY
        n = (self.frac + self.t * dinv
             - shift / (pb * SECS_PER_DAY))
        return 2.0 * math.pi * (n - torch.floor(n + 0.5))

    def delay(self, p, value, accum):
        def v(name):
            x = value(p, name)
            return x if torch.is_tensor(x) else torch.tensor(
                float(x), dtype=torch.float64, device=self.device)

        d = self.at(v, accum)
        for _ in range(ITERATIONS):
            d = self.at(v, accum + d)
        return d


class ELL1(Binary):
    epoch = "TASC"

    def shapiro_rs(self, v):
        return TSUN_S * v("M2"), v("SINI")

    def at(self, v, accum):
        phi = self.anomaly(v, accum)
        e1, e2 = v("EPS1"), v("EPS2")
        roemer = v("A1") * (torch.sin(phi) - 0.5 * (
            e1 * torch.cos(2 * phi) - e2 * torch.sin(2 * phi)))
        r, s = self.shapiro_rs(v)
        return roemer - 2.0 * r * torch.log(1.0 - s * torch.sin(phi))


class ELL1H(ELL1):
    def shapiro_rs(self, v):
        sigma = v("STIGMA")
        return v("H3") / sigma ** 3, 2.0 * sigma / (1.0 + sigma ** 2)


class DD(Binary):
    epoch = "T0"

    def at(self, v, accum):
        M = self.anomaly(v, accum)
        e = v("ECC")
        u = M + e * torch.sin(M)
        for _ in range(KEPLER_ITERATIONS):
            u = u - (u - e * torch.sin(u) - M) / (1.0 - e * torch.cos(u))
        su, cu = torch.sin(u), torch.cos(u)
        nu = 2.0 * torch.atan2(torch.sqrt(1.0 + e) * torch.sin(u / 2),
                               torch.sqrt(1.0 - e) * torch.cos(u / 2))
        om = v("OM") * (math.pi / 180.0)
        so, co = torch.sin(om), torch.cos(om)
        x = v("A1")
        root = torch.sqrt(1.0 - e ** 2)
        roemer = x * so * (cu - e) + x * co * root * su
        einstein = v("GAMMA") * su
        r, s = TSUN_S * v("M2"), v("SINI")
        shapiro = -2.0 * r * torch.log(1.0 - e * cu - s * (
            so * (cu - e) + root * co * su))
        aberr = (v("A0") * (torch.sin(om + nu) + e * so)
                 + v("B0") * (torch.cos(om + nu) + e * co))
        return roemer + einstein + shapiro + aberr


MODELS = {"ELL1": ELL1, "ELL1H": ELL1H, "DD": DD}


def make(par, psr, device="cpu"):
    return MODELS[par.values["BINARY"]](par, psr, device)
