"""The plain timing model: delays, phase, residuals and design matrix.

Written from the published formulas (PINT's and tempo2's conventions,
as the port states them), in plain PyTorch f64 for the delays and the
design matrix (forward-mode derivatives of the phase), and numpy
longdouble for the par file's spin phase (see ``Model.residual_s``).

Delays in the order they accumulate (each later one sees the sum of
the earlier ones, as the binary delay does):

- astrometry: n the pulsar's ICRS direction at each TOA, its RAJ and
  DECJ moved by the proper motion over the TDB seconds since POSEPOCH
  (DECJ + PMDEC dt, RAJ + PMRA dt / cos DECJ, mas per Julian year);
  Roemer -r . n / c, and the parallax term |r|^2 - (r . n)^2 over
  2 c d, d = 1000 / PX parsecs, r the observatory's SSB position;
- Solar Shapiro: -2 T_sun ln((r - r . n) / AU), r the observatory->Sun
  vector;
- DM and DMX: K DM / f^2, K = 1 / 2.41e-4 s MHz^2 pc^-1 cm^3, f the
  topocentric frequency in MHz, DMX_k on the TOAs whose UTC MJD lies in
  [DMXR1_k, DMXR2_k];
- FD: sum_i FD_i ln(f / 1 GHz)^i;
- the binary delay (``binary.py``) at the time less those delays.

Phase: sum_i F_i dt^(i+1) / (i+1)!, dt = (TDB - PEPOCH) - delay, less
F0 JUMP_k on the TOAs of each JUMP's flag. Residual: the phase's
offset from its nearest integer, over F0, in seconds. Design matrix:
a column of ones (the offset), then d(phase)/d(x_j) / F0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import binary

C_M_S = 299792458.0
AU_LS = 149597870700.0 / C_M_S
TSUN_S = 4.925490947000518e-06
DM_K = 1.0 / 2.41e-4
SECS_PER_DAY = 86400.0
LS_PER_PC = 3.0856775814913673e16 / C_M_S
MAS_PER_YEAR = math.pi / (180.0 * 3600.0 * 1000.0) / (365.25 * SECS_PER_DAY)
LD = np.longdouble


@dataclass
class Pulsar:
    """One pulsar as both sides get it: the par text and the TOA table
    (TDB day and f64 seconds, the observatory's SSB position and the
    observatory->Sun vector in metres, frequency, error, flags, UTC
    MJD)."""

    par: object
    tdb_day: np.ndarray
    tdb_sec: np.ndarray
    obs_pos_m: np.ndarray
    obs_sun_m: np.ndarray
    freq_mhz: np.ndarray
    error_us: np.ndarray
    flags: dict  # flag -> (n,) values, "" where a TOA lacks it
    mjd_utc: np.ndarray
    site: str = "gbt"  # as the tim file names it

    def flag_mask(self, flag, value):
        col = self.flags.get(flag)
        if col is None:
            return np.zeros(len(self.mjd_utc), dtype=bool)
        return col == value


def epoch_seconds(psr, mjd):
    """(TDB - epoch) in seconds as longdouble, the epoch an MJD
    (integer day plus fraction), from the TDB day and f64 seconds."""
    day = math.floor(mjd)
    frac_s = (mjd - day) * SECS_PER_DAY
    return (LD(1) * (psr.tdb_day - day).astype(np.float64) * SECS_PER_DAY
            + (psr.tdb_sec.astype(LD) - LD(frac_s)))


class Model:
    """The delays and phase of one pulsar, as functions of its free
    parameters (a dict name -> 0-d f64 tensor) over its fixed ones, its
    per-TOA columns on ``device`` (torch's own ops on either)."""

    def __init__(self, psr, device="cpu"):
        self.psr = psr
        par = psr.par
        self.par = par
        self.device = device

        def t(a):
            return torch.as_tensor(a, device=device)

        self.obs_ls = t(psr.obs_pos_m / C_M_S)
        self.sun_ls = t(psr.obs_sun_m / C_M_S)
        self.f = t(psr.freq_mhz.astype(np.float64))
        self.T = epoch_seconds(psr, par.values["PEPOCH"])
        self.T_f64 = t(self.T.astype(np.float64))
        self.dt_pos = t(epoch_seconds(psr, par.values.get(
            "POSEPOCH", par.values["PEPOCH"])).astype(np.float64))
        dmx, window = [], np.full(len(psr.mjd_utc), -1)
        k = 1
        while f"DMX_{k:04d}" in par.values:
            lo, hi = par.values[f"DMXR1_{k:04d}"], par.values[f"DMXR2_{k:04d}"]
            window[(psr.mjd_utc >= lo) & (psr.mjd_utc <= hi)] = len(dmx)
            dmx.append(f"DMX_{k:04d}")
            k += 1
        self.dmx = dmx
        # each TOA's window (windows do not overlap), the last slot a
        # zero offset for the TOAs outside every window
        self.dmx_window = t(np.where(window < 0, len(dmx), window))
        self.fd = []
        k = 1
        while f"FD{k}" in par.values:
            self.fd.append(f"FD{k}")
            k += 1
        self.jumps = [(f"JUMP{i + 1}", t(psr.flag_mask(
            m.flag, m.flag_value).astype(np.float64)))
                      for i, m in enumerate(par.mask_params("JUMP"))]
        self.jump_values = {f"JUMP{i + 1}": m.value
                            for i, m in enumerate(par.mask_params("JUMP"))}
        self.binary = (binary.make(par, psr, device)
                       if "BINARY" in par.values else None)

    def value(self, p, name):
        """A parameter: free (in ``p``) or fixed."""
        if name in p:
            return p[name]
        if name in self.jump_values:
            return self.jump_values[name]
        return self.par.values.get(name, 0.0)

    def scalar(self, p, name):
        v = self.value(p, name)
        return v if torch.is_tensor(v) else torch.tensor(
            float(v), dtype=torch.float64, device=self.device)

    def direction(self, p):
        """(n, 3) unit vectors to the pulsar at each TOA."""
        dec0 = self.scalar(p, "DECJ")
        dec = dec0 + self.scalar(p, "PMDEC") * MAS_PER_YEAR * self.dt_pos
        ra = (self.scalar(p, "RAJ") + self.scalar(p, "PMRA") * MAS_PER_YEAR
              * self.dt_pos / torch.cos(dec0))
        return torch.stack([torch.cos(dec) * torch.cos(ra),
                            torch.cos(dec) * torch.sin(ra),
                            torch.sin(dec)], dim=-1)

    def delay(self, p):
        n = self.direction(p)
        r = self.obs_ls
        rn = torch.sum(r * n, dim=-1)
        d = -rn + 0.5 * (torch.sum(r * r, dim=-1) - rn ** 2) * (
            self.scalar(p, "PX") / (1000.0 * LS_PER_PC))
        sun = self.sun_ls
        d = d - 2.0 * TSUN_S * torch.log(
            (torch.linalg.norm(sun, dim=-1) - torch.sum(sun * n, dim=-1))
            / AU_LS)
        f2 = self.f ** 2
        dm = self.scalar(p, "DM") + torch.cat(
            [torch.stack([self.scalar(p, k) for k in self.dmx]),
             torch.zeros(1, dtype=torch.float64, device=self.device)])[
                 self.dmx_window] if self.dmx else self.scalar(p, "DM")
        d = d + DM_K * dm / f2
        logf = torch.log(self.f / 1000.0)
        for i, name in enumerate(self.fd):
            d = d + self.value(p, name) * logf ** (i + 1)
        if self.binary is not None:
            d = d + self.binary.delay(p, self.value, d)
        return d

    def spin_terms(self, p):
        terms, i = [], 0
        while f"F{i}" in self.par.values:
            terms.append(self.value(p, f"F{i}"))
            i += 1
        return terms

    def jump_phase(self, p, F0):
        out = 0.0
        for name, mask in self.jumps:
            out = out - F0 * self.value(p, name) * mask
        return out

    def phase_f64(self, p):
        """The phase in f64: its value is too coarse for a residual, its
        derivatives are exact to rounding."""
        dt = self.T_f64 - self.delay(p)
        F = self.spin_terms(p)
        ph, fact, dtp = 0.0, 1.0, dt
        for i, Fi in enumerate(F):
            fact *= i + 1
            ph = ph + Fi * dtp / fact
            dtp = dtp * dt
        return ph + self.jump_phase(p, F[0])

    def residual_s(self, values):
        """Residual seconds at the parameter values ``values`` (a dict
        of floats for the free parameters).

        The phase is split as tempo and PINT split it: the spin phase at
        the par file's F_i, phi_ref(T) = sum_i F_i T^(i+1) / (i+1)!, in
        longdouble, reduced to its fractional part; then in f64 the
        change of the spin terms, sum_i (F_i - F_ref,i) T^(i+1) / (i+1)!,
        and the delay's term phi(T - d) - phi(T) = -d B with
        B = sum_i F_i / (i+1)! sum_{j<=i} T^(i-j) (T - d)^j. So the
        longdouble rounding of phi_ref (~2e-9 cycles at 1e10 cycles) is
        the port's own, and the comparison reads what the fit does with
        it, not how two roundings differ."""
        p = {k: torch.tensor(float(v), dtype=torch.float64,
                             device=self.device) for k, v in values.items()}
        with torch.no_grad():
            d = self.delay(p).cpu().numpy()
            jump = self.jump_phase(p, 1.0)
            jump = (np.zeros(len(d)) if isinstance(jump, float)
                    else jump.cpu().numpy())
        F = [float(f) for f in self.spin_terms(p)]
        F_ref = self.spin_terms({})
        ph_ref, fact = LD(0), LD(1)
        for i, f in enumerate(F_ref):
            fact = fact * LD(i + 1)
            ph_ref = ph_ref + LD(f) * self.T ** (i + 1) / fact
        ph = (ph_ref - np.floor(ph_ref + LD(0.5))).astype(np.float64)
        T = self.T.astype(np.float64)
        fact, Tp = 1.0, T
        for i in range(len(F)):
            fact *= i + 1
            ph = ph + (F[i] - F_ref[i]) * Tp / fact
            Tp = Tp * T
        Tm, fact, B = T - d, 1.0, np.zeros_like(T)
        for i in range(len(F)):
            fact *= i + 1
            s, Tmj = np.zeros_like(T), np.ones_like(T)
            for j in range(i + 1):
                s = s + T ** (i - j) * Tmj
                Tmj = Tmj * Tm
            B = B + F[i] / fact * s
        ph = ph - d * B + F[0] * jump
        return (ph - np.floor(ph + 0.5)) / F[0]

    def design(self, values, names):
        """(n, 1 + len(names)) on the model's device: the offset column,
        then d(phase)/dx / F0 at ``values``."""
        x = torch.tensor([float(values[k]) for k in names],
                         dtype=torch.float64, device=self.device)

        def phase_of(xv):
            return self.phase_f64(dict(zip(names, xv.unbind())))

        J = torch.func.jacfwd(phase_of)(x).detach()
        F0 = float(values["F0"]) if "F0" in values else self.par.values["F0"]
        return torch.cat([torch.ones((J.shape[0], 1), dtype=J.dtype,
                                     device=J.device), J / F0], dim=1)
