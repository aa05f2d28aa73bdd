"""Minimal FITS binary-table I/O (a copy of the JAX package's
``io/fits.py``: host numpy, nothing of it runs on the device).

The reference reads photon-event lists and spacecraft orbit files with
``astropy.io.fits`` (reference: src/pint/event_toas.py,
src/pint/fermi_toas.py, src/pint/observatory/satellite_obs.py).
astropy is not a dependency of the package, so this module implements
the small slice of FITS the event pipeline needs: primary header +
BINTABLE extensions with scalar and fixed-length vector columns, read
and written as numpy structured arrays (big-endian per the standard).
"""

from __future__ import annotations

import re

import numpy as np

BLOCK = 2880
CARD = 80

_TFORM_RE = re.compile(r"^(\d*)([LXBIJKAED])")
_DTYPES = {
    "L": "S1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8", "A": "S",
}


def _parse_card(card: str):
    key = card[:8].strip()
    if key in ("COMMENT", "HISTORY", "END", ""):
        return key, None
    if card[8:10] != "= ":
        return key, None
    body = card[10:]
    # string value: quoted, '' escapes a quote
    if body.lstrip().startswith("'"):
        s = body.lstrip()[1:]
        out, i = [], 0
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return key, "".join(out).rstrip()
    val = body.split("/")[0].strip()
    if val == "T":
        return key, True
    if val == "F":
        return key, False
    try:
        return key, int(val)
    except ValueError:
        pass
    try:
        return key, float(val)
    except ValueError:
        return key, val


def _read_header(fh):
    header: dict = {}
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            if not header:
                return None
            raise OSError("truncated FITS header")
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(36):
            card = text[i * CARD:(i + 1) * CARD]
            key, val = _parse_card(card)
            if key == "END":
                done = True
                break
            if val is not None and key not in header:
                header[key] = val
        if done:
            return header


def _table_dtype(header):
    names, formats, sizes = [], [], []
    for i in range(1, int(header["TFIELDS"]) + 1):
        tform = str(header[f"TFORM{i}"]).strip()
        m = _TFORM_RE.match(tform)
        if not m:
            raise OSError(f"unsupported TFORM {tform!r}")
        rep = int(m.group(1)) if m.group(1) else 1
        code = m.group(2)
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        names.append(name)
        if code == "A":
            formats.append(f"S{rep}")
        elif code == "X":
            formats.append(("u1", ((rep + 7) // 8,)))
        elif rep == 1:
            formats.append(_DTYPES[code])
        else:
            formats.append((_DTYPES[code], (rep,)))
        sizes.append(rep)
    return np.dtype({"names": names, "formats": formats})


def read_fits(path):
    """Parse a FITS file -> list of HDU dicts
    {"name", "header", "data"}; data is a dict col->ndarray for
    BINTABLE HDUs, None otherwise (image data is skipped)."""
    hdus = []
    with open(path, "rb") as fh:
        # reject non-FITS input up front: the primary header MUST begin
        # with a SIMPLE card (FITS standard 3.0 section 4.4.1); without
        # this check arbitrary bytes "parse" into an empty HDU list and
        # the caller sees a confusing missing-extension error instead
        # of the real problem
        magic = fh.read(6)
        fh.seek(0)
        if magic != b"SIMPLE":
            raise ValueError(
                f"{path!r} is not a FITS file (primary header does not "
                f"begin with SIMPLE)")
        while True:
            header = _read_header(fh)
            if header is None:
                break
            # data size
            naxis = int(header.get("NAXIS", 0))
            shape = [int(header.get(f"NAXIS{i}", 0)) for i in range(1, naxis + 1)]
            bitpix = abs(int(header.get("BITPIX", 8)))
            nbytes = (bitpix // 8) * int(np.prod(shape)) if shape else 0
            nbytes += int(header.get("PCOUNT", 0))
            data = None
            if header.get("XTENSION", "").strip().startswith("BINTABLE"):
                dt = _table_dtype(header)
                nrows = int(header["NAXIS2"])
                raw = fh.read(dt.itemsize * nrows)
                rec = np.frombuffer(raw, dtype=dt, count=nrows)
                data = {}
                for name in rec.dtype.names:
                    col = rec[name]
                    if col.dtype.kind in "iuf":
                        col = col.astype(col.dtype.newbyteorder("="))
                    data[name] = col
                skip = nbytes - dt.itemsize * nrows
            else:
                skip = nbytes
            # seek past remaining data + padding
            pos = fh.tell()
            pad = (-(pos + max(skip, 0))) % BLOCK
            fh.seek(max(skip, 0) + pad, 1)
            hdus.append({"name": str(header.get("EXTNAME", "")).strip(),
                         "header": header, "data": data})
    return hdus


def get_table(path, extname):
    """(header, columns) of the named BINTABLE extension."""
    for hdu in read_fits(path):
        if hdu["data"] is not None and hdu["name"].upper() == extname.upper():
            return hdu["header"], hdu["data"]
    raise KeyError(f"no BINTABLE extension {extname!r} in {path}")


# ---- writer (used by tests and simulation tooling) ----

def _card(key, val, comment=""):
    if isinstance(val, bool):
        v = "T" if val else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(val, (int, np.integer)):
        body = f"{key:<8}= {val:>20d}"
    elif isinstance(val, float):
        body = f"{key:<8}= {val:>20.16G}"
    else:
        body = f"{key:<8}= '{val}'"
    if comment:
        body += f" / {comment}"
    return body[:CARD].ljust(CARD)


def _write_header(fh, cards):
    text = "".join(cards) + "END".ljust(CARD)
    pad = (-len(text)) % BLOCK
    fh.write((text + " " * pad).encode("ascii"))


def write_fits_table(path, columns: dict, header_extra: dict | None = None,
                     extname="EVENTS"):
    """Write a minimal primary HDU + one BINTABLE with the given
    columns (name -> 1-D array or (n, k) vector column)."""
    cols = {}
    for name, arr in columns.items():
        a = np.asarray(arr)
        if a.dtype.kind == "f":
            a = a.astype(">f8")
        elif a.dtype.kind == "u" and a.itemsize == 1:
            pass  # B column (also how logical/bit columns read back)
        elif a.dtype.kind in "iu":
            a = a.astype(">i4") if a.itemsize <= 4 else a.astype(">i8")
        elif a.dtype.kind in "SU":
            a = a.astype(f"S{a.dtype.itemsize or 1}")
        else:
            raise TypeError(f"column {name!r}: unsupported dtype {a.dtype}")
        cols[name] = a
    n = len(next(iter(cols.values())))

    def fmt_code(dt):
        if dt.kind == "u":
            return "B"
        if dt.kind == "i":
            return {2: "I", 4: "J", 8: "K"}[dt.itemsize]
        return {4: "E", 8: "D"}[dt.itemsize]
    names = list(cols)
    dt = np.dtype({"names": names,
                   "formats": [(c.dtype.str, c.shape[1:]) if c.ndim > 1
                               else c.dtype.str for c in cols.values()]})
    rec = np.zeros(n, dtype=dt)
    for name in names:
        rec[name] = cols[name]
    with open(path, "wb") as fh:
        _write_header(fh, [_card("SIMPLE", True), _card("BITPIX", 8),
                           _card("NAXIS", 0), _card("EXTEND", True)])
        cards = [_card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
                 _card("NAXIS", 2), _card("NAXIS1", dt.itemsize),
                 _card("NAXIS2", n), _card("PCOUNT", 0), _card("GCOUNT", 1),
                 _card("TFIELDS", len(names))]
        for i, name in enumerate(names, 1):
            c = cols[name]
            if c.dtype.kind == "S":
                rep, code = c.dtype.itemsize, "A"
            else:
                rep = int(np.prod(c.shape[1:])) if c.ndim > 1 else 1
                code = fmt_code(c.dtype)
            tform = f"{rep}{code}" if rep > 1 else code
            cards += [_card(f"TTYPE{i}", name), _card(f"TFORM{i}", tform)]
        cards.append(_card("EXTNAME", extname))
        for k, v in (header_extra or {}).items():
            cards.append(_card(k, v))
        _write_header(fh, cards)
        raw = rec.tobytes()
        fh.write(raw)
        fh.write(b"\0" * ((-len(raw)) % BLOCK))
