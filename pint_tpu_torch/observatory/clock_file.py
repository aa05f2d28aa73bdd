"""Clock-correction file parsing and evaluation (the JAX package's
``observatory/clock_file.py``, host numpy).

(reference: src/pint/observatory/clock_file.py::ClockFile — TEMPO
``time.dat`` and Tempo2 ``.clk`` two-column formats, linear
interpolation, out-of-range policy.)

Files are searched in pint_tpu_torch/data/clock/ and $PINT_TPU_CLOCK_DIR.
None are bundled (no network in the build env); the observatory layer
degrades to zero corrections with a warning when a chain is missing.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from ..mjd import Epochs


class ClockFile:
    """MJD -> clock offset [s], linearly interpolated."""

    def __init__(self, mjd, offset_s, name=""):
        order = np.argsort(mjd)
        self.mjd = np.asarray(mjd, dtype=np.float64)[order]
        self.offset = np.asarray(offset_s, dtype=np.float64)[order]
        self.name = name

    @classmethod
    def read_tempo2(cls, path: str) -> "ClockFile":
        """Tempo2 .clk: '# UTC(obs) UTC' header then 'MJD offset' rows."""
        mjd, off = [], []
        with open(path) as f:
            for line in f:
                ls = line.strip()
                if not ls or ls.startswith("#"):
                    continue
                parts = ls.split()
                try:
                    mjd.append(float(parts[0]))
                    off.append(float(parts[1]))
                except (ValueError, IndexError):
                    continue
        return cls(mjd, off, name=os.path.basename(path))

    @classmethod
    def read_tempo(cls, path: str, obscode: str | None = None) -> "ClockFile":
        """TEMPO time.dat: columns MJD, offset [us], obs code markers."""
        mjd, off = [], []
        with open(path) as f:
            for line in f:
                if line.startswith(("#", "C ", "*")):
                    continue
                parts = line.split()
                if len(parts) < 3:
                    continue
                try:
                    m = float(parts[0])
                    o = float(parts[2]) * 1e-6  # microseconds
                except ValueError:
                    continue
                mjd.append(m)
                off.append(o)
        return cls(mjd, off, name=os.path.basename(path))

    def evaluate(self, t: Epochs, limits="warn") -> np.ndarray:
        x = t.mjd_float()
        if len(self.mjd) == 0:
            return np.zeros_like(x)
        out_of_range = (x < self.mjd[0]) | (x > self.mjd[-1])
        if np.any(out_of_range):
            msg = (f"clock file {self.name}: {int(out_of_range.sum())} TOAs "
                   f"outside range [{self.mjd[0]:.1f}, {self.mjd[-1]:.1f}]")
            if limits == "error":
                raise RuntimeError(msg)
            warnings.warn(msg)
        return np.interp(x, self.mjd, self.offset)


_cache: dict[str, ClockFile | None] = {}


def find_clock_file(fname: str, fmt: str = "tempo2") -> ClockFile | None:
    if fname in _cache:
        return _cache[fname]
    search = [
        os.path.join(os.path.dirname(__file__), "..", "data", "clock"),
        os.environ.get("PINT_TPU_CLOCK_DIR", ""),
    ]
    cf = None
    for d in search:
        if not d:
            continue
        p = os.path.join(d, fname)
        if os.path.exists(p):
            cf = ClockFile.read_tempo(p) if fmt == "tempo" else ClockFile.read_tempo2(p)
            break
    _cache[fname] = cf
    return cf
