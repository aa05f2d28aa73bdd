"""Solar-system ephemeris dispatch (host numpy; counterpart of the JAX
package's ``ephemeris/__init__.py``).

API mirror of the reference's solar_system_ephemerides
(reference: src/pint/solar_system_ephemerides.py::objPosVel_wrt_SSB):
``objPosVel_wrt_SSB(body, tdb_epochs, ephem)`` returns a PosVel in
metres / m/s, ICRS, with respect to the solar-system barycentre.

Provider resolution order, the JAX package's:
1. a real JPL kernel: ``<name>.bsp`` found in pint_tpu_torch/data/ or in
   ``$PINT_TPU_EPHEM_DIR`` (read via io/spk.py — full DE accuracy);
2. the shipped numerically integrated kernel ``data/numeph_v1.bsp``
   (a byte-for-byte copy of the JAX package's; same SPK evaluation
   path), when every requested epoch is in its coverage (MJD
   40000-64000); ``PINT_TPU_DISABLE_NUMEPH=1`` disables it;
3. the analytic series (ephemeris/analytic.py) with reduced accuracy.
The provider tag says which tier served a request.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..mjd import Epochs
from ..utils import PosVel
from . import analytic

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
_KERNELS: dict[str, object] = {}


def _find_kernel(ephem: str):
    """The SPKKernel of ``<ephem>.bsp`` in the package's data directory
    or in ``$PINT_TPU_EPHEM_DIR``, or None; cached per name."""
    if ephem in _KERNELS:
        return _KERNELS[ephem]
    from ..io.spk import SPKKernel

    for d in (_DATA, os.environ.get("PINT_TPU_EPHEM_DIR", "")):
        if not d:
            continue
        p = os.path.join(d, f"{ephem.lower()}.bsp")
        if os.path.exists(p):
            _KERNELS[ephem] = SPKKernel(p)
            return _KERNELS[ephem]
    _KERNELS[ephem] = None
    return None


_CHAIN_TO_SSB = {
    # body -> chain of (target, center) SPK hops summed to reach SSB
    "earth": [(3, 0), (399, 3)],
    "moon": [(3, 0), (301, 3)],
    "emb": [(3, 0)],
    "sun": [(10, 0)],
    "jupiter": [(5, 0)],
    "saturn": [(6, 0)],
    "uranus": [(7, 0)],
    "neptune": [(8, 0)],
    "venus": [(2, 0)],
    "mercury": [(1, 0)],
    "mars": [(4, 0)],
}


_NUMEPH: list | None = None  # [kernel, et_lo, et_hi] or [None, 0, 0]


def _numeph_kernel():
    """(kernel, et_lo, et_hi) of the shipped integrated kernel, or
    (None, 0, 0) when it is missing or ``PINT_TPU_DISABLE_NUMEPH`` is
    set."""
    global _NUMEPH
    if os.environ.get("PINT_TPU_DISABLE_NUMEPH"):
        return None, 0.0, 0.0
    if _NUMEPH is None:
        from ..io.spk import SPKKernel

        path = os.path.join(_DATA, "numeph_v1.bsp")
        if os.path.exists(path):
            k = SPKKernel(path)
            seg = k.segment_for(3, 0)
            _NUMEPH = [k, seg.start_et, seg.end_et]
        else:
            _NUMEPH = [None, 0.0, 0.0]
    return tuple(_NUMEPH)


def _kernel_posvel(kern, body: str, tdb: Epochs,
                   et: np.ndarray | None = None) -> PosVel:
    from ..io.spk import tdb_epochs_to_et

    if et is None:
        et = tdb_epochs_to_et(tdb.day, tdb.sec)
    chain = _CHAIN_TO_SSB.get(body)
    if chain is None:
        raise KeyError(f"unknown body {body!r}")
    pos = np.zeros((len(tdb), 3))
    vel = np.zeros((len(tdb), 3))
    for target, center in chain:
        p, v = kern.posvel(target, center, et)
        pos += p * 1e3  # km -> m
        vel += v * 1e3
    return PosVel(pos, vel, origin="ssb", obj=body)


def objPosVel_wrt_SSB(body: str, tdb: Epochs, ephem: str = "de440s",
                      provider: str | None = None) -> PosVel:
    """ICRS PosVel [m, m/s] of ``body`` wrt SSB at TDB epochs.

    ``provider`` pins the tier ('spk'/'numeph'/'analytic'): a caller
    that splits one dataset into subsets resolves
    :func:`ephemeris_provider` once on the full epoch range and passes
    it down, so that subsets straddling the numeph coverage edge do not
    mix tiers. A pinned tier that cannot serve the request raises
    ``KeyError`` (no kernel for 'spk', a body or a kernel that numeph
    lacks) or ``ValueError`` (epochs outside numeph's coverage); it
    never falls back.
    """
    body = body.lower()
    if provider is None:
        provider = ephemeris_provider(ephem, tdb)
    if provider == "spk":
        kern = _find_kernel(ephem)
        if kern is None:
            raise KeyError(f"provider pinned to 'spk' but no kernel "
                           f"backs ephem {ephem!r}")
        return _kernel_posvel(kern, body, tdb)
    if provider == "numeph" and body not in _CHAIN_TO_SSB:
        raise KeyError(
            f"provider pinned to 'numeph' but body {body!r} is not in "
            f"the numeph kernel ({sorted(_CHAIN_TO_SSB)}); re-resolve "
            f"the tier (pass provider=None) or request a kernel body")
    if provider == "numeph":
        nk, et_lo, et_hi = _numeph_kernel()
        if nk is None:
            raise KeyError(
                "provider pinned to 'numeph' but the numeph kernel is "
                "unavailable; re-resolve the tier (pass provider=None)")
        from ..io.spk import tdb_epochs_to_et

        # the SPK evaluator clamps to the nearest record outside
        # coverage: a pinned tier must not extrapolate
        et = tdb_epochs_to_et(tdb.day, tdb.sec)
        if len(et) and (et.min() < et_lo or et.max() > et_hi):
            raise ValueError(
                "epochs outside the numeph kernel coverage with "
                "provider pinned to 'numeph'; re-resolve the tier "
                "for these epochs (pass provider=None)")
        return _kernel_posvel(nk, body, tdb, et=et)
    pos, vel = analytic.body_posvel_ssb(body, tdb.mjd_float())
    return PosVel(pos, vel, origin="ssb", obj=body)


def numeph_fingerprint():
    """(coverage_et_lo, coverage_et_hi, content_hash) of the shipped
    numeph kernel, or None: the SHA-256 of the file's bytes, so that a
    refit kernel with the same span and layout still differs."""
    nk, et_lo, et_hi = _numeph_kernel()
    if nk is None:
        return None
    if not hasattr(nk, "_content_hash"):
        nk._content_hash = hashlib.sha256(nk._data.tobytes()).hexdigest()
    return (et_lo, et_hi, nk._content_hash)


def best_positions_icrs(mjd: np.ndarray) -> tuple[dict, str]:
    """(dict body -> (T, 3) ICRS position [m] wrt SSB, provider tag) at
    TDB MJDs, from the numeph kernel when every epoch is in its
    coverage, else from the analytic series."""
    mjd = np.atleast_1d(np.asarray(mjd, dtype=np.float64))
    nk, et_lo, et_hi = _numeph_kernel()
    et = (mjd - 51544.5) * 86400.0
    if nk is not None and len(et) and et.min() >= et_lo and et.max() <= et_hi:
        day = np.floor(mjd).astype(np.int64)
        t = Epochs(day, (mjd - day) * 86400.0, "tdb")
        out = {b: _kernel_posvel(nk, b, t).pos for b in _CHAIN_TO_SSB}
        for b in ("jupiter", "saturn", "uranus", "neptune"):
            out[f"{b}_bary"] = out[b]
        return out, "numeph"
    T = (mjd - 51544.5) / 36525.0
    return analytic._all_positions_icrs(T), "analytic"


def ephemeris_provider(ephem: str = "de440s", tdb: Epochs | None = None) -> str:
    """Which tier serves this request: 'spk' (a real kernel backs the
    requested name), 'numeph' (the shipped integrated kernel, in
    coverage for ``tdb`` if given), or 'analytic'."""
    if _find_kernel(ephem) is not None:
        return "spk"
    nk, et_lo, et_hi = _numeph_kernel()
    if nk is not None:
        if tdb is None:
            return "numeph"
        from ..io.spk import tdb_epochs_to_et

        et = tdb_epochs_to_et(tdb.day, tdb.sec)
        if len(et) and et.min() >= et_lo and et.max() <= et_hi:
            return "numeph"
    return "analytic"
