"""High-precision epoch representation: (integer MJD, seconds-of-day).

TPU-native replacement for the reference's longdouble MJD handling
(reference: src/pint/pulsar_mjd.py — PulsarMJD Time format,
mjds_to_jds/jds_to_mjds and the (jd1, jd2) split inside astropy Time).

Design: an epoch is ``(day: int64, sec: float64, lo: float64)`` with
0 <= sec < 86400 and ``lo`` a compensation term (|lo| <= ulp(sec)/2;
the represented instant is day*86400 + sec + lo seconds).
- ``day`` is the integer MJD in the relevant timescale.
- ``sec`` is seconds within the day; f64 resolution on 86400 is ~20 ps,
  well under the ~1 ns target.
- ``lo`` exists because a *single* f64 sec cannot survive timescale
  shifts exactly: adding TAI-UTC=37 s to a sec just below 2^16 lands
  just above 2^16, where the representable grid is twice as coarse —
  a pigeonhole argument shows no single-f64 scheme can round-trip
  UTC<->TAI exactly. Carrying the two_sum rounding error in ``lo``
  makes every scale conversion exactly invertible (test_property.py::
  test_utc_tai_roundtrip) at the cost of one extra f64 per epoch.
Differences between epochs are formed as double-double seconds
(day difference * 86400 is exact in f64 for any realistic span), which
is what the device-side phase computation consumes (see pint_tpu.dd).

Host-side only; device code receives plain f64 arrays.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .constants import SECS_PER_DAY

LD = np.longdouble  # x86 80-bit on the host; never on device


def _two_sum(a, b):
    """Knuth two-sum: (s, e) with s = fl(a+b) and s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


@dataclass
class Epochs:
    """Array-of-epochs in some timescale: integer day + seconds-of-day
    (+ a tiny compensation ``lo``; see module docstring)."""

    day: np.ndarray  # int64 MJD
    sec: np.ndarray  # float64 seconds of day, [0, 86400)
    scale: str = "utc"
    lo: np.ndarray | None = None  # f64 compensation; instant = sec + lo

    def __post_init__(self):
        self.day = np.atleast_1d(np.asarray(self.day, dtype=np.int64))
        self.sec = np.atleast_1d(np.asarray(self.sec, dtype=np.float64))
        self.lo = (np.zeros_like(self.sec) if self.lo is None
                   else np.atleast_1d(np.asarray(self.lo, dtype=np.float64)))

    def __len__(self):
        return len(self.day)

    def normalized(self) -> "Epochs":
        """Carry sec+lo into [0, 86400), compensated.

        All shifts go through two_sum so no bit of the represented
        instant is lost; the ``sec`` component equals what the old
        uncompensated code produced (two_sum's high word IS the plain
        float sum), so callers that ignore ``lo`` see identical values.
        """
        hi, lo = _two_sum(self.sec, self.lo)
        day = self.day
        # two passes: the first can leave hi within one ulp of a day
        # boundary (when the exact remainder straddles it), the second
        # settles it; vectorized equivalent of a tiny while-loop
        for _ in range(2):
            extra = np.floor(hi / SECS_PER_DAY).astype(np.int64)
            day = day + extra
            shift = extra.astype(np.float64) * SECS_PER_DAY  # exact
            r, e = _two_sum(hi, -shift)
            hi, lo = _two_sum(r, e + lo)
        # residual boundary snaps (values within an ulp of the edge)
        hit = hi >= SECS_PER_DAY
        day = np.where(hit, day + 1, day)
        hi = np.where(hit, hi - SECS_PER_DAY, hi)  # exact (Sterbenz)
        neg = hi < 0.0
        # clamp a sub-ulp negative to midnight, preserving it in lo
        lo = np.where(neg, lo + hi, lo)
        hi = np.where(neg, 0.0, hi)
        return Epochs(day, hi, self.scale, lo)

    def mjd_longdouble(self) -> np.ndarray:
        return LD(self.day) + (LD(self.sec) + LD(self.lo)) / LD(SECS_PER_DAY)

    def mjd_float(self) -> np.ndarray:
        return np.asarray(self.day, dtype=np.float64) + self.sec / SECS_PER_DAY

    def add_seconds(self, s) -> "Epochs":
        """Shift by s seconds, exactly (compensated)."""
        hi, e = _two_sum(self.sec, np.asarray(s, np.float64))
        return Epochs(self.day, hi, self.scale, self.lo + e).normalized()

    def with_scale(self, scale: str) -> "Epochs":
        """Same instant numbers, relabelled timescale (no conversion)."""
        return Epochs(self.day, self.sec, scale, self.lo)

    def diff_seconds_dd(self, other: "Epochs"):
        """(self - other) in seconds as a (hi, lo) double-double pair."""
        dday = (self.day - other.day).astype(np.float64) * SECS_PER_DAY  # exact
        dsec = self.sec - other.sec  # exact-ish (both < 86400)
        hi = dday + dsec
        lo = (dday - hi) + dsec + (self.lo - other.lo)
        return hi, lo


_MJD_RE = re.compile(r"^([+-]?\d+)(?:\.(\d+))?$")


def parse_mjd_string(s: str) -> tuple[int, float]:
    """Parse a decimal MJD string exactly into (int day, frac seconds).

    The reference parses tim-file MJDs into longdouble
    (reference: src/pint/toa.py tim parsing, pulsar_mjd.py::str2longdouble);
    we split digits so no precision is lost regardless of digit count.
    """
    m = _MJD_RE.match(s.strip())
    if not m:
        raise ValueError(f"bad MJD string: {s!r}")
    day = int(m.group(1))
    negative = m.group(1).lstrip().startswith("-")  # catches "-0" too
    frac_digits = m.group(2) or ""
    if frac_digits:
        # longdouble keeps sub-ns accuracy however many digits are given
        sec = float(LD(int(frac_digits)) * LD(SECS_PER_DAY) / LD(10) ** len(frac_digits))
    else:
        sec = 0.0
    if negative and sec > 0.0:
        # value = -(|day| + frac): fractional digits count *away from
        # zero*, so floor the day and complement the seconds
        # (e.g. "-1.5" -> (-2, 43200); "-0.5" -> (-1, 43200))
        day -= 1
        sec = SECS_PER_DAY - sec
    return day, sec


def format_mjds(day, sec, ndigits: int = 16) -> list[str]:
    """Format arrays of (day, sec) as decimal MJD strings with ndigits
    fractional digits (longdouble arithmetic; seconds past a day carry
    into the day, and so does a fraction that rounds up to 1)."""
    day = np.asarray(day, np.int64)
    frac = LD(np.asarray(sec, np.float64)) / LD(SECS_PER_DAY)
    carry = frac >= 1
    if carry.any():
        whole = np.floor(frac)
        day = np.where(carry, day + whole.astype(np.int64), day)
        frac = np.where(carry, frac - whole, frac)
    scaled = np.rint(frac * LD(10) ** ndigits).astype(np.int64)
    over = scaled >= 10**ndigits
    scaled = np.where(over, scaled - 10**ndigits, scaled)
    day = np.where(over, day + 1, day)
    return [f"{d}.{s:0{ndigits}d}" for d, s in zip(day.tolist(),
                                                    scaled.tolist())]


def format_mjd(day: int, sec: float, ndigits: int = 16) -> str:
    """Format (day, sec) as a decimal MJD string with ndigits fractional digits."""
    return format_mjds([day], [sec], ndigits)[0]


def mjd_to_caldate(mjd: int) -> tuple[int, int, int]:
    """MJD -> (year, month, day), proleptic Gregorian. Fliegel–Van Flandern."""
    jd = mjd + 2400001  # JDN at noon of that civil day
    a = jd + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = 100 * b + d - 4800 + m // 10
    return year, month, day


def caldate_to_mjd(year: int, month: int, day: int) -> int:
    a = (14 - month) // 12
    y = year + 4800 - a
    m = month + 12 * a - 3
    jdn = day + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100 + y // 400 - 32045
    return jdn - 2400001
