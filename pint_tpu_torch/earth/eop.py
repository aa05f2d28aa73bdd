"""Earth-orientation parameters (UT1-UTC, polar motion); the JAX
package's ``earth/eop.py``, host numpy.

The reference gets these from astropy's auto-downloaded IERS-A tables
(reference: src/pint/erfautils.py + astropy.utils.iers). This build
environment has no network and no bundled EOP data, so:

- ``EOPTable.from_finals2000a(path)`` parses a standard IERS
  ``finals2000A.all``-format file if the user supplies one;
- otherwise the rotation chain runs with UT1=UTC and zero polar motion
  (documented error: up to ~1.4 us Roemer from |UT1-UTC|<=0.9 s, and
  ~30 ns from ~0.3 arcsec polar motion).
"""

from __future__ import annotations

import numpy as np

from ..constants import ARCSEC_TO_RAD
from ..mjd import Epochs


class EOPTable:
    """Linear-interpolated EOP series keyed on UTC MJD."""

    def __init__(self, mjd, ut1_utc, pm_x_arcsec, pm_y_arcsec):
        self.mjd = np.asarray(mjd, dtype=np.float64)
        self.ut1_utc = np.asarray(ut1_utc, dtype=np.float64)
        self.pm_x = np.asarray(pm_x_arcsec, dtype=np.float64)
        self.pm_y = np.asarray(pm_y_arcsec, dtype=np.float64)

    @classmethod
    def from_finals2000a(cls, path: str) -> "EOPTable":
        """Parse IERS finals2000A fixed-width format (Bulletin A columns)."""
        mjd, dut, px, py = [], [], [], []
        with open(path) as f:
            for line in f:
                if len(line) < 68:
                    continue
                try:
                    m = float(line[7:15])
                    x = float(line[18:27])
                    y = float(line[37:46])
                    d = float(line[58:68])
                except ValueError:
                    continue
                mjd.append(m)
                px.append(x)
                py.append(y)
                dut.append(d)
        if not mjd:
            raise ValueError(f"no EOP rows parsed from {path}")
        return cls(mjd, dut, px, py)

    def _interp(self, series, t: Epochs):
        x = t.mjd_float()
        return np.interp(x, self.mjd, series)

    def ut1_minus_utc(self, t: Epochs) -> np.ndarray:
        return self._interp(self.ut1_utc, t)

    def polar_motion(self, t: Epochs):
        """(xp, yp) in radians."""
        return (self._interp(self.pm_x, t) * ARCSEC_TO_RAD,
                self._interp(self.pm_y, t) * ARCSEC_TO_RAD)


# --- global table: the transparent data-upgrade path -------------------
# Drop a finals2000A.all into pint_tpu_torch/data/ (or point $PINT_TPU_EOP_FILE
# at one) and every site->GCRS conversion picks it up; no code changes.
_GLOBAL: EOPTable | None = None
_SEARCHED = False


def set_eop_table(table: EOPTable | None) -> None:
    """Install the process-wide EOP table; None DISABLES EOP (the
    UT1=UTC / zero-polar-motion tier) until reset_eop_discovery() or a
    new table. Disabling sticks — it does not re-trigger file
    discovery, so "how much does EOP data contribute" comparisons are
    expressible."""
    global _GLOBAL, _SEARCHED
    _GLOBAL = table
    _SEARCHED = True


def reset_eop_discovery() -> None:
    """Forget any installed/disabled state and re-run the file
    auto-discovery on next use (e.g. after changing
    $PINT_TPU_EOP_FILE)."""
    global _GLOBAL, _SEARCHED
    _GLOBAL = None
    _SEARCHED = False


def get_eop_table() -> EOPTable | None:
    """The process-wide EOP table, auto-discovered on first use from
    $PINT_TPU_EOP_FILE or pint_tpu_torch/data/finals2000A.all; None when no
    data is available (rotation chain then runs UT1=UTC, zero polar
    motion — the documented ~1.4 us fallback tier)."""
    global _GLOBAL, _SEARCHED
    if _SEARCHED:
        return _GLOBAL
    _SEARCHED = True
    import os
    import warnings

    env_file = os.environ.get("PINT_TPU_EOP_FILE", "")
    candidates = [
        env_file,
        os.path.join(os.path.dirname(__file__), "..", "data",
                     "finals2000A.all"),
    ]
    for p in candidates:
        if not p:
            continue
        try:
            _GLOBAL = EOPTable.from_finals2000a(p)
            break
        except FileNotFoundError:
            continue  # candidate simply absent — the normal case
        except (OSError, ValueError) as e:
            # a file that EXISTS but fails to load deserves a
            # diagnostic — silently ignoring it would let the user
            # believe their data is applied while the chain runs the
            # degraded UT1=UTC tier
            which = (f"PINT_TPU_EOP_FILE={p!r}" if p == env_file
                     else f"bundled EOP file {p!r}")
            warnings.warn(f"{which} could not be loaded ({e}); "
                          "continuing without it")
            continue
    return _GLOBAL
