"""JPL SPK/DAF binary ephemeris kernel reader and Chebyshev evaluation
(host numpy; counterpart of the JAX package's ``io/spk.py``).

(reference: src/pint/solar_system_ephemerides.py::objPosVel_wrt_SSB
loads DE kernels via jplephem.) This module reads the DAF container and
evaluates type 2/3 Chebyshev segments directly, vectorized over epochs.
The port ships the numerically integrated kernel
``pint_tpu_torch/data/numeph_v1.bsp``; a real ``<ephem>.bsp`` dropped
into that directory or into ``$PINT_TPU_EPHEM_DIR`` is read the same way
(``ephemeris/__init__.py``).

Each coefficient sum is a left fold over the Chebyshev order in IEEE
f64 (no FMA). The C++ library's ``pt_cheby_posvel``
(``native.cheby_posvel``) folds in the same order and serves the
evaluation when it is loaded, as in the JAX package; both paths give
bitwise-equal positions and velocities.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Segment:
    target: int
    center: int
    frame: int
    data_type: int
    start_et: float
    end_et: float
    start_word: int
    end_word: int
    # filled lazily
    init: float = 0.0
    intlen: float = 0.0
    rsize: int = 0
    n_records: int = 0


class SPKKernel:
    """Memory-mapped DAF/SPK file with type 2/3 Chebyshev segments."""

    def __init__(self, path: str):
        self.path = path
        self._data = np.memmap(path, dtype=np.uint8, mode="r")
        self._parse_file_record()
        self._parse_summaries()
        self._seg_cache: dict[tuple[int, int], Segment] = {}
        self._rec_cache: dict[tuple[int, int], np.ndarray] = {}

    def _words(self, start_word: int, count: int) -> np.ndarray:
        """1-indexed 8-byte words -> float64 array."""
        off = (start_word - 1) * 8
        return np.frombuffer(self._data[off:off + count * 8].tobytes(),
                             dtype=self._f64)

    def _parse_file_record(self):
        rec = self._data[:1024].tobytes()
        locidw = rec[:8].decode("ascii", "replace")
        if not locidw.startswith("DAF/SPK"):
            raise ValueError(f"{self.path}: not an SPK file ({locidw!r})")
        fmt = rec[88:96].decode("ascii", "replace")
        if "BIG" in fmt:
            self._f64, self._i32 = ">f8", ">i4"
        else:  # "LTL-IEEE", or an old file without the tag
            self._f64, self._i32 = "<f8", "<i4"
        endian = "<" if self._f64 == "<f8" else ">"
        self.nd, self.ni = struct.unpack(endian + "ii", rec[8:16])
        self.fward, self.bward, self.free = struct.unpack(endian + "iii",
                                                          rec[76:88])

    def _parse_summaries(self):
        self.segments: list[Segment] = []
        recno = self.fward
        ss = self.nd + (self.ni + 1) // 2  # summary size in words
        while recno > 0:
            base = (recno - 1) * 1024
            ctrl = np.frombuffer(self._data[base:base + 24].tobytes(),
                                 dtype=self._f64)
            nxt, nsum = int(ctrl[0]), int(ctrl[2])
            for i in range(nsum):
                off = base + 24 + i * ss * 8
                dbl = np.frombuffer(self._data[off:off + self.nd * 8].tobytes(),
                                    dtype=self._f64)
                ints = np.frombuffer(
                    self._data[off + self.nd * 8:
                               off + self.nd * 8 + self.ni * 4].tobytes(),
                    dtype=self._i32)
                self.segments.append(Segment(
                    target=int(ints[0]), center=int(ints[1]),
                    frame=int(ints[2]), data_type=int(ints[3]),
                    start_et=float(dbl[0]), end_et=float(dbl[1]),
                    start_word=int(ints[4]), end_word=int(ints[5])))
            recno = nxt

    def segment_for(self, target: int, center: int) -> Segment:
        key = (target, center)
        if key not in self._seg_cache:
            for seg in self.segments:
                if seg.target == target and seg.center == center:
                    if seg.data_type not in (2, 3):
                        raise ValueError(f"SPK segment type {seg.data_type} "
                                         "unsupported (only 2/3)")
                    tail = self._words(seg.end_word - 3, 4)
                    seg.init, seg.intlen = tail[0], tail[1]
                    seg.rsize, seg.n_records = int(tail[2]), int(tail[3])
                    self._seg_cache[key] = seg
                    break
            else:
                raise KeyError(f"no SPK segment {target} wrt {center} in "
                               f"{self.path}")
        return self._seg_cache[key]

    def posvel(self, target: int, center: int, et: np.ndarray):
        """Position [km] and velocity [km/s] of target wrt center at ET
        seconds, vectorized over epochs. An epoch outside the segment
        takes its nearest record (the caller checks coverage)."""
        seg = self.segment_for(target, center)
        et = np.atleast_1d(np.asarray(et, dtype=np.float64))
        idx = np.clip(((et - seg.init) / seg.intlen).astype(np.int64),
                      0, seg.n_records - 1)
        rsize = seg.rsize
        ncoef = (rsize - 2) // 3 if seg.data_type == 2 else (rsize - 2) // 6
        # the segment's records, decoded once
        key = (target, center)
        all_rec = self._rec_cache.get(key)
        if all_rec is None:
            all_rec = self._words(seg.start_word,
                                  seg.n_records * rsize).reshape(
                                      seg.n_records, rsize)
            self._rec_cache[key] = all_rec
        rec = all_rec[idx]  # (n, rsize)
        from ..native import cheby_posvel

        # the C++ mirror folds in the same order: bitwise this numpy path
        nat = cheby_posvel(et, rec, ncoef, seg.data_type)
        if nat is not None:
            return nat
        radius = rec[:, 1]
        s = (et - rec[:, 0]) / radius  # in [-1, 1]
        # Chebyshev polynomials T_k(s) and their derivatives
        n = len(et)
        T = np.zeros((ncoef, n))
        dT = np.zeros((ncoef, n))
        T[0] = 1.0
        if ncoef > 1:
            T[1] = s
            dT[1] = 1.0
        for k in range(2, ncoef):
            T[k] = 2 * s * T[k - 1] - T[k - 2]
            dT[k] = 2 * T[k - 1] + 2 * s * dT[k - 1] - dT[k - 2]

        def fold(first, basis):
            """sum_k c_k basis_k for one axis, k = 0, 1, ... in order."""
            acc = np.zeros(n)
            for k in range(ncoef):
                acc = acc + rec[:, first + k] * basis[k]
            return acc

        pos = np.empty((n, 3))
        vel = np.empty((n, 3))
        for axis in range(3):
            first = 2 + axis * ncoef
            pos[:, axis] = fold(first, T)
            vel[:, axis] = fold(first, dT) / radius
        if seg.data_type == 3:
            for axis in range(3):
                vel[:, axis] = fold(2 + (3 + axis) * ncoef, T)
        return pos, vel


def tdb_epochs_to_et(day, sec) -> np.ndarray:
    """(TDB MJD day, sec-of-day) -> ET seconds past J2000."""
    return ((np.asarray(day, np.float64) - 51544.5) * 86400.0
            + np.asarray(sec, np.float64))
