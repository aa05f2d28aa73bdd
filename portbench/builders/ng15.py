"""NANOGrav-15-yr-like pulsars (arXiv:2306.16217), each with the parts of
a NANOGrav timing model: free position, proper motion and parallax, F0
and F1, one free DMX offset per observing epoch (a window of at most six
days), FD1/FD2, a JUMP on one receiver and one on the legacy backend,
and isolated / ELL1 / ELL1H / DD orbits in turn; EFAC, EQUAD and ECORR
per receiver and backend, and power-law red noise of 30 harmonics
(arXiv:2306.16218) at amplitudes near 1e-14.

Schedule (``schedule``, ``toas``): the pulsars join in the cohorts of
NANOGrav's data releases (the heaviest first) and are observed from
their cohort's start to the end of the data set at a roughly monthly
cadence.
Each epoch observes both of the site's receivers (at GBT up to four
days apart, at Arecibo in one session), each in many sub-bands; the
pulsar's TOA count sets the sub-bands. Pulsars with declinations
between 0 and 38 degrees are timed at Arecibo, the others at GBT.
"""

import numpy as np

# (start MJD, share of the pulsars): the 5-, 9-, 11-, 12.5- and 15-yr
# releases' additions
COHORTS = ((53216.0, 17), (55000.0, 20), (55900.0, 8), (56600.0, 2),
           (57600.0, 21))
LEGACY_END_MJD = 55400.0  # GASP/ASP before, GUPPI/PUPPI after
SITES = {
    "gbt": (("Rcvr_800", 730.0, 910.0, 0.25), ("Rcvr1_2", 1150.0, 1880.0,
                                               0.75)),
    "arecibo": (("L-wide", 1150.0, 1730.0, 0.5), ("S-wide", 1730.0, 2400.0,
                                                  0.5)),
}
BACKENDS = {"gbt": ("GASP", "GUPPI"), "arecibo": ("ASP", "PUPPI")}
ORBITS = (
    "",
    "BINARY ELL1\nPB 1.533449 1\nA1 1.89799 1\nTASC 55001.0 1\n"
    "EPS1 2e-8 1\nEPS2 -8e-8 1\nM2 0.21\nSINI 0.998\n",
    "BINARY ELL1H\nPB 12.32717 1\nA1 9.230780 1\nTASC 53601.0 1\n"
    "EPS1 -2.15e-5 1\nEPS2 -3.1e-6 1\nH3 2.7e-7\nSTIGMA 0.72\n",
    "BINARY DD\nPB 8.0 1\nA1 12.0 1\nT0 55300 1\nECC 0.12 1\nOM 45.0 1\n"
    "M2 0.35\nSINI 0.92\n")
SPACING_DAYS = 0.5 / 86400.0  # sub-band TOAs of one observation


def declination_deg(i):
    return (i * 3) % 60 - 30


def site_of(i):
    return "arecibo" if 0 <= declination_deg(i) <= 38 else "gbt"


def cohort_start(i, n):
    """The start of pulsar ``i``'s cohort (pulsars in order of TOA
    count, heaviest first) over a fleet of ``n``."""
    total = sum(k for _, k in COHORTS)
    edge = 0.0
    for start, k in COHORTS:
        edge += k / total
        if i < edge * n - 1e-9:
            return start
    return COHORTS[-1][0]


def schedule(config, i, n, count):
    """Pulsar ``i``'s epochs: (epoch days, second-receiver offsets in
    days, TOAs per epoch), from the configuration's schedule seed."""
    rng = np.random.default_rng([int(config["schedule_seed"]), i])
    start = cohort_start(i, n)
    cadence = float(config["cadence_days"])
    n_ep = max(2, int(round((config["mjd_end"] - 6.0 - start) / cadence)))
    days = start + cadence * (np.arange(n_ep) + rng.uniform(0.0, 0.3, n_ep))
    if site_of(i) == "gbt":
        second = rng.uniform(0.5, 4.0, n_ep)
    else:
        second = np.full(n_ep, 1.0 / 24.0)
    per = max(int(config["min_toas_per_epoch"]), int(count) // n_ep)
    return days, second, per


def _receivers(i, per):
    out = []
    for name, lo, hi, share in SITES[site_of(i)]:
        out.append((name, lo, hi, max(2, int(round(per * share)))))
    return out


def par_text(config, i, n, count):
    site = site_of(i)
    days, second, per = schedule(config, i, n, count)
    start = cohort_start(i, n)
    pepoch = round(0.5 * (start + config["mjd_end"]))
    text = (f"PSR BEN{i}\nRAJ {i % 24}:{(7 * i) % 60:02d}:00.0 1\n"
            f"DECJ {declination_deg(i)}:30:00.0 1\n"
            f"PMRA {(-1) ** i * (1.5 + i % 9)} 1\n"
            f"PMDEC {(-1) ** (i // 2) * (0.5 + i % 7)} 1\n"
            f"PX {0.3 + 0.1 * (i % 13):.1f} 1\nPOSEPOCH {pepoch}\n"
            f"F0 {150 + 5 * (i % 40)}.318 1\nF1 -{2 + i % 7}e-16 1\n"
            f"PEPOCH {pepoch}\nDM {8 + i}.21\n")
    text += "".join(f"DMX_{k + 1:04d} 0.0 1\nDMXR1_{k + 1:04d} {d - 0.5}\n"
                    f"DMXR2_{k + 1:04d} {d + s + 0.5}\n"
                    for k, (d, s) in enumerate(zip(days, second)))
    rx = _receivers(i, per)
    legacy, modern = BACKENDS[site]
    text += (f"FD1 1.5e-5 1\nFD2 -4e-6 1\nJUMP -fe {rx[0][0]} 0.0 1\n")
    if days[0] < LEGACY_END_MJD:
        text += f"JUMP -be {legacy} 0.0 1\n"
    for j, (name, _, _, _) in enumerate(rx):
        for be in (legacy, modern):
            if be == legacy and days[0] >= LEGACY_END_MJD:
                continue
            f = f"{name}_{be}"
            text += (f"EFAC -f {f} {1.05 + 0.05 * j}\n"
                     f"EQUAD -f {f} {0.2 + 0.2 * j}\n"
                     f"ECORR -f {f} {0.5 + 0.3 * j}\n")
    text += (f"TNREDAMP {-14.5 + 0.25 * (i % 5)}\n"
             f"TNREDGAM {3.0 + 0.5 * (i % 3)}\nTNREDC 30\n")
    return text + ORBITS[i % 4]


def toas(config, i, n, count):
    """(UTC MJDs, frequencies in MHz, flags per TOA, site) of pulsar
    ``i``'s schedule."""
    days, second, per = schedule(config, i, n, count)
    legacy, modern = BACKENDS[site_of(i)]
    mjds, freqs, flags = [], [], []
    for d, s in zip(days, second):
        be = legacy if d < LEGACY_END_MJD else modern
        for (name, lo, hi, m), t0 in zip(_receivers(i, per), (d, d + s)):
            f = lo + (hi - lo) * (np.arange(m) + 0.5) / m
            mjds.append(t0 + SPACING_DAYS * np.arange(m))
            freqs.append(f)
            flags.extend({"fe": name, "be": be, "f": f"{name}_{be}"}
                         for _ in range(m))
    return np.concatenate(mjds), np.concatenate(freqs), flags, site_of(i)
