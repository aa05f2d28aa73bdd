"""A plain reader of the FORMAT 1 tim files the benchmark writes:
``name freq mjd error site [-flag value ...]`` per line. Flags come back
as columns (a missing flag reads as ""), the site as it is written."""

from __future__ import annotations

import os

import numpy as np


def read(path):
    freq, mjd, err, rows, sites = [], [], [], [], []
    with open(path) as f:
        for line in f:
            words = line.split()
            if not words or words[0] in ("FORMAT", "MODE", "C", "#"):
                continue
            freq.append(float(words[1]))
            day, _, frac = words[2].partition(".")
            mjd.append(int(day) + float("0." + (frac or "0")))
            err.append(float(words[3]))
            sites.append(words[4])
            rest = words[5:]
            rows.append({rest[k][1:]: rest[k + 1]
                         for k in range(0, len(rest) - 1, 2)})
    keys = sorted({k for r in rows for k in r})
    flags = {k: np.array([r.get(k, "") for r in rows]) for k in keys}
    return {"freq_mhz": np.array(freq), "mjd": np.array(mjd),
            "error_us": np.array(err), "site": np.array(sites),
            "flags": flags}


def read_cached(path):
    """``read(path)``, kept beside the file as ``<path>.npz`` after the
    first read (the tim file is written once per checkout)."""
    cache = path + ".npz"
    if os.path.exists(cache):
        with np.load(cache) as z:
            return {"freq_mhz": z["freq_mhz"], "mjd": z["mjd"],
                    "error_us": z["error_us"], "site": z["site"],
                    "flags": {k[5:]: z[k] for k in z.files
                              if k.startswith("flag_")}}
    out = read(path)
    tmp = cache + ".tmp.npz"
    np.savez(tmp, freq_mhz=out["freq_mhz"], mjd=out["mjd"],
             error_us=out["error_us"], site=out["site"],
             **{f"flag_{k}": v for k, v in out["flags"].items()})
    os.replace(tmp, cache)
    return out
