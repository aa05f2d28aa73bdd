"""DAF/SPK type-2 kernel writer (little-endian).

Counterpart of the reader in io/spk.py. Exists for two reasons:
1. the numerically integrated ephemeris artifact
   (ephemeris/numeph.py::build) is written as a REAL SPK kernel so the
   entire existing kernel path — DAF parsing, segment chains, the
   native C++ Chebyshev evaluator — serves it with no new evaluation
   code, and is thereby exercised by a shipped real-format file;
2. round-trip tests of the data-upgrade story (drop a .bsp in and the
   provider switches) against files we fully control.

Layout follows the NAIF DAF spec closely enough for any compliant
type-2 reader: file record with ND=2/NI=6 and LTL-IEEE format word,
FTP corruption-detection string, one summary record, one name record,
then contiguous element data; each segment is Chebyshev position
records [MID, RADIUS, x-coeffs, y-coeffs, z-coeffs] followed by the
[INIT, INTLEN, RSIZE, N] trailer.
(reference role: the reference writes no kernels — it reads DE kernels
via jplephem; writing is original to this framework's offline-artifact
pipeline.)

The port's copy of the JAX package's writer, host numpy as there: the
same segments give the same bytes. The default internal name stays
"pint_tpu numeph", the lineage the shipped ``numeph_v1.bsp`` records.
"""

from __future__ import annotations

import numpy as np

_FTPSTR = b"FTPSTR:\r:\n:\r\n:\r\x00:\x81:\x10\xce:ENDFTP"


def write_spk_type2(path: str, segments: list[dict],
                    internal_name: str = "pint_tpu numeph") -> None:
    """Write a little-endian DAF/SPK with type-2 Chebyshev segments.

    Each segment dict:
      target, center : int NAIF codes
      init_et        : float, ET seconds of the first record's start
      intlen_s       : float, record length in ET seconds
      coeffs         : (n_rec, 3, ncoef) float64 Chebyshev position
                       coefficients [km] per record (x, y, z)
    """
    nd, ni = 2, 6
    ss = nd + (ni + 1) // 2  # summary size in words = 5
    nseg = len(segments)
    if 3 + nseg * ss > 128:
        raise ValueError("too many segments for a single summary record")

    # element data layout (word-addressed, 1-indexed, data starts rec 4)
    first_data_word = 3 * 128 + 1
    word = first_data_word
    seg_meta = []
    blobs = []
    for s in segments:
        coeffs = np.asarray(s["coeffs"], dtype="<f8")
        n_rec, three, ncoef = coeffs.shape
        if three != 3:
            raise ValueError("coeffs must be (n_rec, 3, ncoef)")
        rsize = 2 + 3 * ncoef
        init, intlen = float(s["init_et"]), float(s["intlen_s"])
        mids = init + (np.arange(n_rec) + 0.5) * intlen
        rec = np.empty((n_rec, rsize), dtype="<f8")
        rec[:, 0] = mids
        rec[:, 1] = intlen / 2.0
        rec[:, 2:] = coeffs.reshape(n_rec, 3 * ncoef)
        blob = np.concatenate(
            [rec.ravel(),
             np.array([init, intlen, rsize, n_rec], dtype="<f8")])
        blobs.append(blob)
        start_word = word
        end_word = word + len(blob) - 1
        word = end_word + 1
        seg_meta.append((s, init, init + n_rec * intlen,
                         start_word, end_word))
    free = word  # first free word address

    # file record
    rec1 = bytearray(1024)
    rec1[0:8] = b"DAF/SPK "
    rec1[8:16] = np.array([nd, ni], dtype="<i4").tobytes()
    rec1[16:76] = internal_name.encode("ascii", "replace")[:60].ljust(60)
    rec1[76:88] = np.array([2, 2, free], dtype="<i4").tobytes()
    rec1[88:96] = b"LTL-IEEE"
    rec1[699:699 + len(_FTPSTR)] = _FTPSTR

    # summary record
    rec2 = bytearray(1024)
    rec2[0:24] = np.array([0.0, 0.0, float(nseg)], dtype="<f8").tobytes()
    for i, (s, start_et, end_et, sw, ew) in enumerate(seg_meta):
        off = 24 + i * ss * 8
        rec2[off:off + 16] = np.array([start_et, end_et],
                                      dtype="<f8").tobytes()
        rec2[off + 16:off + 40] = np.array(
            [s["target"], s["center"], s.get("frame", 1),
             2, sw, ew], dtype="<i4").tobytes()

    # name record: ss*8 = 40 chars per segment
    rec3 = bytearray(b" " * 1024)
    for i, (s, *_rest) in enumerate(seg_meta):
        name = f"numeph {s['target']} wrt {s['center']}".encode()[:40]
        rec3[i * 40:i * 40 + len(name)] = name

    data = np.concatenate(blobs).astype("<f8")
    pad_words = (-len(data)) % 128
    if pad_words:
        data = np.concatenate([data, np.zeros(pad_words, dtype="<f8")])
    with open(path, "wb") as fh:
        fh.write(bytes(rec1))
        fh.write(bytes(rec2))
        fh.write(bytes(rec3))
        fh.write(data.tobytes())
