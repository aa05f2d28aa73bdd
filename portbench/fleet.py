"""A configuration's fleet: its TOA schedule, built once per checkout
and cached, then read as a user's session reads it; and the per-seed
noise realisation laid over it.

The schedule: lognormal TOA counts over ``n_pulsars`` scaled to
``total_toas`` and clipped to [min_toas, max_toas] (copied from
chip_smoke.py's ``ragged_counts``); each pulsar's par text, epochs,
frequencies, flags and site from the configuration's builder;
zero-residual TOAs under each pulsar's model
(``make_fake_toas_fromMJDs``, as chip_smoke.py's ``build_pta``). Each
pulsar's TOAs are written as a tim file into the cache and read back
with ``get_TOAs(usepickle=True)``; a later run reads the pickle.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import shutil
import warnings

import numpy as np

from .reference import noise as ref_noise
from .reference import par as ref_par
from .reference import tim as ref_tim
from .reference import timing as ref_timing


def ragged_counts(n_psr, total, seed, lo, hi):
    rng = np.random.default_rng(seed)
    c = rng.lognormal(np.log(8000.0), 0.9, n_psr)
    for _ in range(3):
        c = np.clip(c * (total / c.sum()), lo, hi)
    return np.sort(c.astype(int))[::-1]


def builder(config):
    return importlib.import_module(f"portbench.builders.{config['builder']}")


def counts_of(config):
    return ragged_counts(config["n_pulsars"], config["total_toas"],
                         config["counts_seed"], config["min_toas"],
                         config["max_toas"])


def cache_dir(root, config):
    blob = json.dumps(config, sort_keys=True).encode()
    return os.path.join(root, ".portbench_cache", "toas",
                        f"{config['name']}-{hashlib.sha256(blob).hexdigest()[:12]}")


def _make(config, out, device):
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.simulation import make_fake_toas_fromMJDs

    b = builder(config)
    counts = counts_of(config)
    for i, n in enumerate(counts):
        m = get_model(b.par_text(config, i, len(counts), n))
        mjds, freqs, flags, site = b.toas(config, i, len(counts), n)
        t = make_fake_toas_fromMJDs(
            mjds, m, error_us=config["error_us"], freq_mhz=freqs,
            obs=site, iterations=config["fake_iterations"], device=device)
        for f, extra in zip(t.flags, flags):
            f.update(extra)
        t.write_TOA_file(os.path.join(out, f"psr{i:03d}.tim"))


def load(root, config, device):
    """(par texts, tim paths, the port's models and TOAs) of the
    configuration's fleet, building the cached schedule first if this
    checkout has none."""
    from pint_tpu_torch.models import get_model
    from pint_tpu_torch.toa import get_TOAs

    d = cache_dir(root, config)
    n = int(config["n_pulsars"])
    done = os.path.join(d, "complete")
    build = not os.path.exists(done)
    with warnings.catch_warnings():
        # the sites have no clock file in the checkout: zero correction
        warnings.filterwarnings("ignore", message="no clock files")
        if build:
            tmp = d + ".building"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _make(config, tmp, device)
            shutil.rmtree(d, ignore_errors=True)
            os.replace(tmp, d)
        b = builder(config)
        counts = counts_of(config)
        pars = [b.par_text(config, i, n, c) for i, c in enumerate(counts)]
        paths = [os.path.join(d, f"psr{i:03d}.tim") for i in range(n)]
        models = [get_model(p) for p in pars]
        toas = [get_TOAs(p, model=m, usepickle=True)
                for p, m in zip(paths, models)]
    if build:
        # the pickles are written: later runs only read
        with open(done, "w") as f:
            f.write("ok\n")
    return pars, paths, models, toas


def reference_pulsars(pars, paths, toas):
    """The reference's view of each pulsar: its own reading of the par
    text and the tim file (UTC MJD, frequency, error, flags, site), with the
    TDB epochs and the observatory and Sun vectors of the port's TOA
    table (see PERF.md: the reference follows the port's TOA stage and
    checks it on its own in ``reference/toastage.py``)."""
    out = []
    for text, path, t in zip(pars, paths, toas):
        rows = ref_tim.read_cached(path)
        out.append(ref_timing.Pulsar(
            par=ref_par.parse(text), tdb_day=np.array(t.tdb.day),
            tdb_sec=np.array(t.tdb.sec), obs_pos_m=np.array(t.ssb_obs.pos),
            obs_sun_m=np.array(t.obs_sun.pos), freq_mhz=rows["freq_mhz"],
            error_us=rows["error_us"], flags=rows["flags"],
            mjd_utc=rows["mjd"], site=str(rows["site"][0])))
    return out


def add_noise(seed, toas, refs):
    """Draw each pulsar's noise realisation from ``seed`` (the
    reference's noise model) and shift both sides' TOAs by it: the UTC
    and TDB epochs move together; the observatory and Sun vectors stay
    (over a few microseconds they move by centimetres, 1e-10 s of
    Roemer delay)."""
    from pint_tpu_torch.mjd import Epochs

    rng = np.random.default_rng([seed, 0])
    for t, r in zip(toas, refs):
        delta = ref_noise.draw(r, rng)
        utc = Epochs(t.day, t.sec + delta, "utc").normalized()
        t.day, t.sec = utc.day, utc.sec
        t.tdb = Epochs(t.tdb.day, t.tdb.sec + delta, "tdb",
                       t.tdb.lo).normalized()
        r.tdb_day, r.tdb_sec = np.array(t.tdb.day), np.array(t.tdb.sec)
        r.mjd_utc = r.mjd_utc + delta / 86400.0
