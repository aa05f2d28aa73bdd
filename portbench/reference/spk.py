"""A plain reader of DAF/SPK type-2 (Chebyshev position) kernels, the
NAIF format of the ephemeris file both sides read."""

from __future__ import annotations

import struct

import numpy as np

MJD_J2000 = 51544.5


class Kernel:
    def __init__(self, path):
        with open(path, "rb") as f:
            self.data = f.read()
        nd, ni = struct.unpack("<ii", self.data[8:16])
        fward = struct.unpack("<i", self.data[76:80])[0]
        self.segments = {}
        rec = fward
        while rec:
            base = (rec - 1) * 1024
            nxt, _, nsum = struct.unpack("<3d", self.data[base:base + 24])
            size = 8 * (nd + (ni + 1) // 2)
            for k in range(int(nsum)):
                off = base + 24 + k * size
                ints = struct.unpack(f"<{ni}i",
                                     self.data[off + 8 * nd:off + 8 * nd + 4 * ni])
                target, center, _, kind, start, end = ints[:6]
                if kind == 2:
                    self.segments[target] = (center, start, end)
            rec = int(nxt)

    def _words(self, start, end):
        return np.frombuffer(self.data, "<f8", end - start + 1,
                             (start - 1) * 8)

    def position_km(self, target, et):
        """Position of ``target`` relative to its segment's centre [km] at
        TDB seconds past J2000 ``et``; returns (centre, (n, 3))."""
        center, start, end = self.segments[target]
        words = self._words(start, end)
        init, intlen, rsize, n = words[-4:]
        rsize, n = int(rsize), int(n)
        recs = words[:rsize * n].reshape(n, rsize)
        deg = (rsize - 2) // 3
        i = np.clip(((et - init) // intlen).astype(int), 0, n - 1)
        r = recs[i]
        s = (et - r[:, 0]) / r[:, 1]
        out = np.empty((len(et), 3))
        for c in range(3):
            coef = r[:, 2 + c * deg:2 + (c + 1) * deg]
            out[:, c] = np.polynomial.chebyshev.chebval(s, coef.T,
                                                       tensor=False)
        return center, out

    def ssb_km(self, target, et):
        """Position relative to the solar-system barycentre [km]."""
        total = np.zeros((len(et), 3))
        while target != 0:
            target, pos = self.position_km(target, et)
            total += pos
        return total
