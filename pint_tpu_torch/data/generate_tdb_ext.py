"""Regenerate the fit-derived TDB-TT series extension
(timescales._TDB_POLY / _TDB_TERMS_EXT / _TDB_T_TERMS_EXT).

Matching-pursuit harmonic extraction of (integrated table - 10-term
published FB series) over the table coverage: iteratively take the
strongest FFT line of the residual, refine its frequency by direct
projection, and re-solve a joint least squares with per-line sin/cos +
T-modulated sin/cos columns plus a const/T/T^2 polynomial, until the
max residual is below ~60 ns. Frequencies land on genuine FB1990
lines (the 1.55e-6 s line at 7771.50 rad/cy is FB's 2D-elongation
term) — that, not the published table, is the provenance: these are
fits to THIS package's integrated dynamics (see the provenance note
in timescales.py).

Run after any intentional change to the ephemeris or the TDB
quadrature, then paste the printed literals into timescales.py:

    python -m pint_tpu_torch.data.generate_tdb_ext

The port's copy of the JAX package's generator, on the port's
``timescales`` (host numpy, as there): at the same ``max_terms`` it
prints the same literals.
"""

import numpy as np


def main(max_ns=60.0, max_terms=90):
    from pint_tpu_torch import timescales as ts
    from pint_tpu_torch.constants import SECS_PER_DAY
    from pint_tpu_torch.mjd import Epochs

    mjd = np.arange(ts._TDB_GRID_LO, ts._TDB_GRID_HI + 0.25, 0.25)
    ep = Epochs(mjd.astype(np.int64), (mjd % 1.0) * SECS_PER_DAY, "tt")
    table = ts.tdb_minus_tt(ep)
    # baseline = the 10 published FB terms only (ts._tdb_fb10; never
    # the current extension): the extension is re-derived from scratch
    # against the same anchor the table is calibrated to, so repeated
    # regenerations cannot random-walk the convention
    T = (mjd - 51544.5) / 36525.0
    r = table - ts._tdb_fb10(ep)
    N = len(T)
    dT = T[1] - T[0]

    def design(freqs):
        cols = [np.ones(N), T, T * T]
        for w in freqs:
            cols += [np.sin(w * T), np.cos(w * T),
                     T * np.sin(w * T), T * np.cos(w * T)]
        return np.stack(cols, axis=1)

    freqs, work, coef = [], r.copy(), None
    for _ in range(max_terms):
        F = np.fft.rfft(work * np.hanning(N))
        k = np.argmax(np.abs(F[1:])) + 1
        w0 = 2 * np.pi * k / (N * dT)
        cand = w0 * (1 + np.linspace(-1.5 / k, 1.5 / k, 81))
        best, bw = -1.0, w0
        for w in cand:
            a2 = (np.dot(work, np.sin(w * T)) ** 2
                  + np.dot(work, np.cos(w * T)) ** 2)
            if a2 > best:
                best, bw = a2, w
        freqs.append(bw)
        A = design(freqs)
        coef, *_ = np.linalg.lstsq(A, r, rcond=None)
        work = r - A @ coef
        if np.abs(work).max() * 1e9 < max_ns:
            break
    print(f"# {len(freqs)} lines, max resid {np.abs(work).max() * 1e9:.1f} ns,"
          f" rms {work.std() * 1e9:.1f} ns")
    print("_TDB_POLY = (%.12e, %.12e, %.12e)" % tuple(coef[:3]))
    rows, trows = [], []
    for j, w in enumerate(freqs):
        a, b, at, bt = coef[3 + 4 * j: 7 + 4 * j]
        if np.hypot(a, b) > 1e-12:
            rows.append((float(np.hypot(a, b)), float(w),
                         float(np.arctan2(b, a))))
        if np.hypot(at, bt) > 1e-12:
            trows.append((float(np.hypot(at, bt)), float(w),
                          float(np.arctan2(bt, at))))
    for name, rws in (("_TDB_TERMS_EXT", sorted(rows, key=lambda x: -x[0])),
                      ("_TDB_T_TERMS_EXT",
                       sorted(trows, key=lambda x: -x[0]))):
        print(f"{name} = np.array([")
        for amp, w, ph in rws:
            print(f"    ({amp:.9e}, {w:.7f}, {ph:.7f}),")
        print("])")


if __name__ == "__main__":
    main()
