"""The comparison that decides ``correct``: the port's refits against the
plain reference's, on a sample of (refit, pulsar) pairs drawn from the
seed, from the same start and TOAs.

Numbers compared, each the worst over the sample:

- ``x_gap_sigma``: max over the free parameters of |x_port - x_ref| over
  the reference's sigma of that parameter;
- ``chi2_gap_rel``: |chi2_port - chi2_ref| / chi2_ref;
- ``cov_gap_rel``: max over the covariance's entries of
  |C_port - C_ref| / sqrt(C_ref,ii C_ref,jj);

and, from ``reference/toastage.py``, the checks of the TOA stage that
the reference takes from the port.
"""

from __future__ import annotations

import numpy as np

from .reference import gls, toastage

FIT_NUMBERS = ("x_gap_sigma", "chi2_gap_rel", "cov_gap_rel")


def gaps(x, chi2, cov, x_ref, chi2_ref, cov_ref):
    x, cov = np.asarray(x, np.float64), np.asarray(cov, np.float64)
    sig = np.sqrt(np.diag(cov_ref))
    scale = np.sqrt(np.outer(np.diag(cov_ref), np.diag(cov_ref)))
    # a parameter the data do not constrain (zero reference variance:
    # a DMX window without TOAs) has no sigma to hold a gap against; it
    # only has to stay finite
    free = sig > 0
    x_gap = np.abs(x - x_ref)
    cov_gap = np.abs(cov - cov_ref)[scale > 0] / scale[scale > 0]
    return {
        "x_gap_sigma": (float(np.max(x_gap[free] / sig[free], initial=0.0))
                        if np.all(np.isfinite(x)) else float("inf")),
        "chi2_gap_rel": float(abs(chi2 - chi2_ref) / abs(chi2_ref)),
        "cov_gap_rel": (float(np.max(cov_gap, initial=0.0))
                        if np.all(np.isfinite(cov)) else float("inf")),
    }


def worst(readings):
    """The largest of each number over the readings; a NaN or infinite
    reading is the worst there is."""
    out = {}
    for r in readings:
        for k, v in r.items():
            v = v if np.isfinite(v) else float("inf")
            out[k] = max(out.get(k, v), v)
    return out


class Reference:
    """The reference's fits of the sampled pulsars, each pulsar's fixed
    pieces built once, its timing model on ``device``."""

    def __init__(self, refs, names, maxiter, device="cpu"):
        self.refs, self.names, self.maxiter = refs, names, maxiter
        self.device = device
        self.fitters = {}

    def fit(self, i, start, precision="float64"):
        f = self.fitters.get(i)
        if f is None:
            f = self.fitters[i] = gls.Fitter(self.refs[i], self.device)
        values, chi2, cov = f.fit(dict(zip(self.names[i], start)),
                                  self.names[i], self.maxiter, precision)
        return np.array([values[k] for k in self.names[i]]), chi2, cov


def compare(records, refs, names, sample, maxiter, device="cpu"):
    """Worst readings of the port's refits ``records`` (per refit:
    "start", "x", "chi2", "cov" {pulsar: matrix}) against the reference
    over ``sample`` [(refit, pulsar)], and of the TOA stage of the
    sampled pulsars."""
    ref = Reference(refs, names, maxiter, device)
    readings = []
    for j, i in sample:
        rec = records[j]
        x_ref, chi2_ref, cov_ref = ref.fit(i, rec["start"][i])
        readings.append(gaps(rec["x"][i], rec["chi2"][i], rec["cov"][i],
                             x_ref, chi2_ref, cov_ref))
    for i in sorted({i for _, i in sample}):
        readings.append(toastage.check(refs[i]))
    return worst(readings)


def control(records, refs, names, sample, maxiter, precision,
            device="cpu"):
    """The control's readings: the reference with its solve in
    ``precision`` ("float32") put in the port's place, and the
    TOA stage's columns rounded to float32, judged the same way."""
    ref = Reference(refs, names, maxiter, device)
    readings = []
    for j, i in sample:
        start = records[j]["start"][i]
        x_ref, chi2_ref, cov_ref = ref.fit(i, start)
        x32, chi2_32, cov32 = ref.fit(i, start, precision)
        readings.append(gaps(x32, chi2_32, cov32, x_ref, chi2_ref, cov_ref))
    for i in sorted({i for _, i in sample}):
        # the TOA stage's columns in float32, the precision below the
        # stage's f64
        readings.append(toastage.check(toastage.rounded(refs[i],
                                                        np.float32)))
    return worst(readings)


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number with a limit at
    or under it. A limit without a number fails; so does a number the
    limits file does not name (a number it names with ``"compared":
    false`` has no limit between its readings and is only reported)."""
    rows = [(k, numbers.get(k, float("inf")), limits[k]["limit"])
            for k in sorted(limits) if "limit" in limits[k]]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and set(numbers) <= set(limits), rows
