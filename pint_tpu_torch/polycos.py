"""Polycos: piecewise-polynomial phase predictors, TEMPO format
(counterpart of the JAX package's ``polycos.py``).

(reference: src/pint/polycos.py — Polycos.generate_polycos,
read_polyco_file, eval_abs_phase, eval_spin_freq, write_polyco_file.)

TEMPO polyco.dat convention (per segment)::

    phase(t) = RPHASE + 60 * F0 * DT + sum_k COEFF[k] * DT^k
    freq(t)  = F0 + (1/60) * sum_k k * COEFF[k] * DT^(k-1)

with DT = (t - TMID) [minutes]. Generation evaluates the timing
model's phase at Chebyshev nodes inside every segment in one pass on
``device``, then fits each segment's coefficients on the host with the
JAX package's numpy (a Chebyshev-Vandermonde least squares). Evaluation
is host numpy as well: the segment of each MJD is found by binary
search when the segments are ordered (the JAX package's first-covering
rule, kept exactly) and the polynomials are evaluated per segment
group with the same operations as ``np.polynomial.polynomial.polyval``,
so both packages give bitwise-equal phases from equal coefficients.
"""

from __future__ import annotations

import math

import numpy as np

from .toa import TOAs


class PolycoEntry:
    """One polyco segment (reference: polycos.py::PolycoEntry)."""

    def __init__(self, tmid_mjd, mjdspan_min, rphase_int, rphase_frac,
                 f0, ncoeff, coeffs, obs="gbt", obsfreq=1400.0, psrname="PSR"):
        self.tmid = float(tmid_mjd)
        self.mjdspan = float(mjdspan_min)
        self.rphase_int = int(rphase_int)
        self.rphase_frac = float(rphase_frac)
        self.f0 = float(f0)
        self.ncoeff = int(ncoeff)
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.obs = obs
        self.obsfreq = float(obsfreq)
        self.psrname = psrname

    @property
    def start(self):
        return self.tmid - self.mjdspan / 2880.0

    @property
    def stop(self):
        return self.tmid + self.mjdspan / 2880.0

    def covers(self, mjd):
        return (mjd >= self.start) & (mjd <= self.stop)

    def abs_phase(self, mjd):
        """Absolute phase (int, frac) at topocentric MJD(s)."""
        dt_min = (np.asarray(mjd, np.float64) - self.tmid) * 1440.0
        poly = np.polynomial.polynomial.polyval(dt_min, self.coeffs)
        ph = self.rphase_frac + 60.0 * self.f0 * dt_min + poly
        n = np.floor(ph)
        return self.rphase_int + n.astype(np.int64), ph - n

    def spin_freq(self, mjd):
        """Apparent spin frequency [Hz] (reference: evalfreq)."""
        dt_min = (np.asarray(mjd, np.float64) - self.tmid) * 1440.0
        k = np.arange(1, self.ncoeff)
        dpoly = np.polynomial.polynomial.polyval(dt_min, k * self.coeffs[1:])
        return self.f0 + dpoly / 60.0


def _polyval_rows(x, coeffs, rows):
    """``np.polynomial.polynomial.polyval(x[i], coeffs[rows[i]])`` for
    every i, by the same Horner steps (``c[-1] + x*0``, then
    ``c[-i] + c0*x``), so each value is bitwise polyval's."""
    n = coeffs.shape[1]
    c0 = coeffs[rows, n - 1] + x * 0
    for i in range(2, n + 1):
        c0 = coeffs[rows, n - i] + c0 * x
    return c0


class Polycos:
    """Set of polyco segments (reference: polycos.py::Polycos)."""

    def __init__(self, entries=()):
        self.entries: list[PolycoEntry] = list(entries)

    # ---------------- generation ----------------

    @classmethod
    def generate_polycos(cls, model, mjd_start, mjd_end, obs="gbt",
                         segLength=60, ncoeff=12, obsFreq=1400.0,
                         nodes_per_seg=None, device="cuda"):
        """Fit polyco segments to the model phase.

        segLength in minutes (reference: generate_polycos signature).
        The model phase is evaluated through the full topocentric
        pipeline at Chebyshev nodes, on ``device``, then each segment's
        coefficients come from one well-conditioned Chebyshev-Vandermonde
        lstsq on the host.
        """
        nodes = nodes_per_seg or max(2 * ncoeff, 24)
        seg_days = segLength / 1440.0
        n_seg = max(1, int(math.ceil((mjd_end - mjd_start) / seg_days - 1e-9)))
        psrname = model.PSR.value if "PSR" in model.params else "PSR"
        entries = []
        # Chebyshev nodes in [-1, 1] shared by all segments
        xk = np.cos(np.pi * (2 * np.arange(nodes) + 1) / (2.0 * nodes))[::-1]
        # tmids quantized to their file representation, so a written
        # polyco reproduces the generation-time phases exactly
        tmids = np.array([
            float(f"{mjd_start + (i + 0.5) * seg_days:.15f}")
            for i in range(n_seg)])
        # one pipeline pass over every segment's nodes
        all_mjds = (tmids[:, None] + xk[None, :] * seg_days / 2.0).ravel()
        all_int, all_frac = _model_abs_phase(model, all_mjds, obs, obsFreq,
                                             device=device)
        all_int = all_int.reshape(n_seg, nodes)
        all_frac = all_frac.reshape(n_seg, nodes)
        T = np.polynomial.chebyshev.chebvander(xk, ncoeff - 1)
        half_min = seg_days / 2.0 * 1440.0
        f0 = float(model.F0.value)
        for i in range(n_seg):
            tmid = tmids[i]
            ph_int, ph_frac = all_int[i], all_frac[i]
            # the middle node's integer anchors the segment; the fit
            # works on (int - int0) + frac
            mid_idx = nodes // 2
            rph_int = int(ph_int[mid_idx])
            dphi = (ph_int - rph_int).astype(np.float64) + ph_frac
            # dt from the f64 node MJDs actually evaluated, consistent
            # with the evaluation's (mjd - tmid)
            dt_min = (all_mjds.reshape(n_seg, nodes)[i] - tmid) * 1440.0
            resid_ph = dphi - 60.0 * f0 * dt_min
            # Chebyshev-basis lstsq, then the power basis of the TEMPO
            # file, rescaled from x in [-1, 1] to dt_min
            c_cheb, *_ = np.linalg.lstsq(T, resid_ph, rcond=None)
            c_pow = np.polynomial.chebyshev.cheb2poly(c_cheb)
            c_dt = c_pow / half_min ** np.arange(len(c_pow))
            c_dt = np.pad(c_dt, (0, ncoeff - len(c_dt)))
            rphase_frac = float(np.polynomial.polynomial.polyval(0.0, c_dt))
            c_dt[0] -= rphase_frac  # the constant goes into RPHASE
            # RPHASE = int.frac with frac in [0, 1)
            carry = math.floor(rphase_frac)
            rph_int += carry
            rphase_frac -= carry
            entries.append(PolycoEntry(
                tmid, segLength, rph_int, rphase_frac, f0, ncoeff, c_dt,
                obs=obs, obsfreq=obsFreq, psrname=psrname))
        return cls(entries)

    # ---------------- evaluation ----------------

    def _find(self, mjds):
        """(mjds, idx): the index of the FIRST segment whose [start,
        stop] covers each MJD (at a shared boundary, the lower index),
        the JAX package's rule. When starts and stops both ascend with
        the index, the covering indices of an MJD are a contiguous run
        beginning at the first stop >= MJD, so a binary search finds
        it; otherwise every segment is scanned as in the JAX package."""
        mjds = np.atleast_1d(np.asarray(mjds, np.float64))
        starts = np.array([e.start for e in self.entries], np.float64)
        stops = np.array([e.stop for e in self.entries], np.float64)
        if (len(self.entries)
                and np.all(np.diff(starts) >= 0)
                and np.all(np.diff(stops) >= 0)):
            lo = np.searchsorted(stops, mjds, side="left")
            cand = np.minimum(lo, len(stops) - 1)
            hit = (lo < len(stops)) & (starts[cand] <= mjds)
            idx = np.where(hit, cand, -1)
        else:
            idx = np.full(mjds.shape, -1, dtype=int)
            for i, e in enumerate(self.entries):
                m = e.covers(mjds) & (idx < 0)
                idx[m] = i
        if (idx < 0).any():
            bad = mjds[idx < 0]
            raise ValueError(f"MJDs outside polyco span: {bad[:3]}...")
        return mjds, idx

    def _table(self):
        """The segments as arrays: tmid, rphase int/frac, f0, the
        coefficient counts and the coefficients zero-padded to the
        longest (each segment is evaluated over its own count)."""
        es = self.entries
        counts = np.array([len(e.coeffs) for e in es])
        coeffs = np.zeros((len(es), counts.max()))
        for i, e in enumerate(es):
            coeffs[i, :counts[i]] = e.coeffs
        return (np.array([e.tmid for e in es]),
                np.array([e.rphase_int for e in es], np.int64),
                np.array([e.rphase_frac for e in es]),
                np.array([e.f0 for e in es]), counts, coeffs)

    def eval_abs_phase(self, mjds):
        """(int, frac) absolute phase (reference: eval_abs_phase)."""
        mjds, idx = self._find(mjds)
        tmid, rint, rfrac, f0, ncoeff, coeffs = self._table()
        pi_ = np.empty(mjds.shape, np.int64)
        pf = np.empty(mjds.shape, np.float64)
        nc = ncoeff[idx]
        for k in np.unique(nc):
            m = nc == k
            rows = idx[m]
            dt_min = (mjds[m] - tmid[rows]) * 1440.0
            poly = _polyval_rows(dt_min, coeffs[:, :k], rows)
            ph = rfrac[rows] + 60.0 * f0[rows] * dt_min + poly
            n = np.floor(ph)
            pi_[m] = rint[rows] + n.astype(np.int64)
            pf[m] = ph - n
        return pi_, pf

    def eval_phase(self, mjds):
        """Fractional phase in [-0.5, 0.5) (reference: eval_phase)."""
        _, pf = self.eval_abs_phase(mjds)
        return pf - np.round(pf)

    def eval_spin_freq(self, mjds):
        """(reference: eval_spin_freq)"""
        mjds, idx = self._find(mjds)
        tmid, _, _, f0, ncoeff, coeffs = self._table()
        out = np.empty(mjds.shape, np.float64)
        nc = ncoeff[idx]
        for k in np.unique(nc):
            m = nc == k
            rows = idx[m]
            dt_min = (mjds[m] - tmid[rows]) * 1440.0
            dcoeffs = np.arange(1, k) * coeffs[:, 1:k]
            out[m] = f0[rows] + _polyval_rows(dt_min, dcoeffs, rows) / 60.0
        return out

    # ---------------- TEMPO format I/O ----------------

    def write_polyco_file(self, path):
        """(reference: polycos.py format writer; TEMPO polyco.dat)"""
        with open(path, "w") as f:
            for e in self.entries:
                date = _mjd_to_datestr(e.tmid)
                utc = _mjd_to_utcstr(e.tmid)
                f.write(f"{e.psrname:<10s} {date:>9s}{utc:>11s}"
                        f"{e.tmid:24.15f}{0.0:21.6f} 0.000 0.000\n")
                # sign-magnitude decimal: readers parse the field as one
                # signed number, so a negative absolute phase prints as
                # -(|int|.|frac|)
                total_neg = e.rphase_int < 0 or (e.rphase_int == 0
                                                 and e.rphase_frac < 0)
                if total_neg:
                    if e.rphase_frac == 0.0:
                        ip, fr = -e.rphase_int, 0.0
                    else:
                        ip, fr = -(e.rphase_int + 1), 1.0 - e.rphase_frac
                    rph = f"-{ip}.{min(int(round(fr * 1e6)), 999999):06d}"
                else:
                    frac6 = min(int(round(e.rphase_frac * 1e6)), 999999)
                    rph = f"{e.rphase_int}.{frac6:06d}"
                f.write(f"{rph:>20s}{e.f0:18.12f}{_obs_code(e.obs):>5s}"
                        f"{e.mjdspan:10.0f}{e.ncoeff:5d}{e.obsfreq:10.3f}\n")
                for j in range(0, e.ncoeff, 3):
                    f.write("".join(f"{c:25.17e}" for c in e.coeffs[j:j + 3])
                            + "\n")

    @classmethod
    def read_polyco_file(cls, path):
        """(reference: polycos.py::Polycos.read_polyco_file)"""
        entries = []
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        i = 0
        while i < len(lines):
            hdr1 = lines[i].split()
            psrname = hdr1[0]
            tmid = float(hdr1[3])
            hdr2 = lines[i + 1].split()
            rph = hdr2[0]
            # signed decimal: value = sign * (|int|.|frac|); renormalized
            # to rphase_int + frac with frac in [0, 1)
            neg = rph.lstrip().startswith("-")
            body = rph.lstrip().lstrip("-")
            if "." in body:
                ip, fp = body.split(".")
                rphase_int, rphase_frac = int(ip or 0), float("0." + fp)
            else:
                rphase_int, rphase_frac = int(body), 0.0
            if neg:
                if rphase_frac:
                    rphase_int = -rphase_int - 1
                    rphase_frac = 1.0 - rphase_frac
                else:
                    rphase_int = -rphase_int
            f0 = float(hdr2[1])
            obs = hdr2[2]
            span = float(hdr2[3])
            ncoeff = int(hdr2[4])
            obsfreq = float(hdr2[5])
            ncl = (ncoeff + 2) // 3
            coeffs = []
            for ln in lines[i + 2: i + 2 + ncl]:
                coeffs.extend(float(x.replace("D", "e")) for x in ln.split())
            entries.append(PolycoEntry(tmid, span, rphase_int, rphase_frac,
                                       f0, ncoeff, coeffs, obs=obs,
                                       obsfreq=obsfreq, psrname=psrname))
            i += 2 + ncl
        return cls(entries)


def _model_abs_phase(model, mjds, obs, freq_mhz, device="cuda"):
    """Absolute model phase (int, frac) at topocentric MJDs through the
    full pipeline, the phase on ``device``. The TOAs are built as
    columns: day = int(mjd), sec = (mjd - day) * 86400, bitwise the JAX
    package's one ``TOA`` per MJD."""
    mjds = np.asarray(mjds, np.float64)
    day = mjds.astype(np.int64)
    sec = (mjds - day) * 86400.0
    ephem = "de440s"
    if "EPHEM" in model.params and model.EPHEM.value:
        ephem = model.EPHEM.value.lower()
    toas = TOAs.from_arrays(day, sec, error_us=1.0, freq_mhz=freq_mhz,
                            obs=obs, ephem=ephem)
    toas.apply_clock_corrections()
    toas.compute_TDBs()
    toas.compute_posvels()
    ph = model.prepare(toas, device=device).phase()
    return (ph.int_.cpu().numpy().astype(np.int64),
            ph.frac.cpu().numpy().astype(np.float64))


_MONTHS = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")


def _mjd_to_datestr(mjd):
    """MJD -> TEMPO polyco DD-Mon-YY date field."""
    from .mjd import mjd_to_caldate

    y, mo, d = mjd_to_caldate(int(mjd))
    return f"{d:2d}-{_MONTHS[mo - 1]}-{y % 100:02d}"


def _mjd_to_utcstr(mjd):
    frac = mjd - int(mjd)
    s = frac * 86400.0
    h = int(s // 3600)
    m = int((s - 3600 * h) // 60)
    sec = s - 3600 * h - 60 * m
    return f"{h:02d}{m:02d}{sec:05.2f}"


_OBS_CODES = {"gbt": "1", "arecibo": "3", "ao": "3", "parkes": "7",
              "jodrell": "8", "jbo": "8", "vla": "6", "effelsberg": "g",
              "meerkat": "m", "@": "@", "bat": "@", "geocenter": "0"}


def _obs_code(obs):
    return _OBS_CODES.get(str(obs).lower(), str(obs)[:1])
