"""Photon-event TOA loaders for X-ray/gamma-ray missions (torch
package; host numpy, carried over from the JAX package's
``event_toas.py``).

(reference: src/pint/event_toas.py — load_event_TOAs /
load_NICER_TOAs / load_RXTE_TOAs / load_XMM_TOAs / load_NuSTAR_TOAs /
load_Swift_TOAs; src/pint/fermi_toas.py — load_Fermi_TOAs with photon
weights.)

Event times are MET seconds since the mission MJDREF (TT), read from
the EVENTS binary table. Barycentered files (TIMESYS='TDB') map to the
'@' barycenter observatory; otherwise the TOAs are tagged with the
mission's satellite observatory. Register it from the mission's orbit
file first (``observatory.satellite_obs.get_satellite_observatory``,
``photonphase --orbfile``); without it, packing such a table raises
``KeyError`` for the unknown observatory, as in the JAX package.

Per-photon TOAs are microsecond-precision and carry no uncertainty;
the device phase-folds all of them in one pass of the timing model.
"""

from __future__ import annotations

import numpy as np

from .toa import TOAs

# MJDREF fallbacks when the event header omits them (TT days).
# Values are the published mission epochs.
MISSION_MJDREF = {
    "nicer": 56658.000777592592592593,
    "nustar": 55197.00076601852,
    "rxte": 49353.000696574074,
    "swift": 51910.00074287037,
    "xmm": 50814.0,
    "fermi": 51910.00074287037,
    "ixpe": 57754.00080074074,
}


def _mjdref_days(header, mission=None) -> float:
    if "MJDREFI" in header:
        return float(header["MJDREFI"]) + float(header.get("MJDREFF", 0.0))
    if "MJDREF" in header:
        return float(header["MJDREF"])
    if mission and mission.lower() in MISSION_MJDREF:
        return MISSION_MJDREF[mission.lower()]
    raise KeyError("no MJDREF in event header and unknown mission")


def met_to_day_sec(met_s, mjdref_days):
    """MET seconds -> (int MJD day, float sec-of-day) without losing
    precision: the fractional MJDREF is carried in seconds."""
    met_s = np.asarray(met_s, dtype=np.float64)
    ref_day = int(np.floor(mjdref_days))
    ref_sec = (mjdref_days - ref_day) * 86400.0
    tot_sec = met_s + ref_sec
    dday = np.floor(tot_sec / 86400.0)
    sec = tot_sec - dday * 86400.0
    return (ref_day + dday.astype(np.int64)), sec


def load_event_TOAs(eventfile, mission, weights=None, weightcolumn=None,
                    minmjd=-np.inf, maxmjd=np.inf, extname="EVENTS",
                    errors_us=1.0, ephem="de440s", planets=False,
                    table=None):
    """FITS event list -> TOAs (reference: event_toas.py::load_event_TOAs).

    Returns a TOAs table (TDB and posvels are filled when it is packed,
    ``TOAs.compute_posvels``), from the ephemeris ``ephem`` names
    through the tiers of ``ephemeris/``. Weights (probability the photon is
    from the pulsar) land in the table's ``weights`` column. ``table``
    supplies an already-read (header, cols) pair so callers that pre-scan columns
    (the Fermi CALC weight path) don't parse a multi-million-photon
    file twice.
    """
    from .io.fits import get_table

    header, cols = table if table is not None else get_table(eventfile,
                                                             extname)
    tcol = next(k for k in cols if k.upper() == "TIME")
    met = np.asarray(cols[tcol], np.float64)
    mjdref = _mjdref_days(header, mission)
    timesys = str(header.get("TIMESYS", "TT")).strip().upper()
    obs = "barycenter" if timesys == "TDB" else str(mission).lower()
    day, sec = met_to_day_sec(met, mjdref)
    mjd_f = day + sec / 86400.0
    keep = (mjd_f >= minmjd) & (mjd_f <= maxmjd)
    if weightcolumn is not None:
        wcol = next(k for k in cols if k.upper() == weightcolumn.upper())
        weights = np.asarray(cols[wcol], np.float64)
    if weights is not None:
        weights = np.asarray(weights, np.float64)[keep]
    # vectorized build: no per-photon Python objects (flags stay lazy)
    t = TOAs.from_arrays(day[keep], sec[keep], error_us=errors_us,
                         freq_mhz=np.inf, obs=obs, weights=weights,
                         ephem=ephem)
    t.planets = planets
    t.filename = str(eventfile)
    return t


def _mission_loader(mission):
    def load(eventfile, **kw):
        kw.setdefault("mission", mission)
        m = kw.pop("mission")
        return load_event_TOAs(eventfile, m, **kw)
    load.__name__ = f"load_{mission.upper()}_TOAs"
    load.__doc__ = (f"Load {mission.upper()} photon events "
                    "(reference: event_toas.py::load_%s_TOAs)" % mission)
    return load


load_NICER_TOAs = _mission_loader("nicer")
load_RXTE_TOAs = _mission_loader("rxte")
load_XMM_TOAs = _mission_loader("xmm")
load_NuSTAR_TOAs = _mission_loader("nustar")
load_Swift_TOAs = _mission_loader("swift")
load_IXPE_TOAs = _mission_loader("ixpe")


def calc_lat_weights(energies_mev, angseps_deg, logeref=4.1,
                     logesig=0.5):
    """Heuristic Fermi-LAT photon weights from angular separation and
    energy (reference: fermi_toas.py::calc_lat_weights — Bruel's
    SearchPulsation convention): a King-profile radial factor
    fgeom = (1 + theta^2 / (2 gamma sigma^2))^(-gamma) with gamma = 2
    and an energy-dependent PSF scale, times a log-normal energy
    window centered on log10(E/MeV) = logeref. No spacecraft pointing
    history or IRF is used — these are aperture-photometry-grade
    weights; for likelihood-grade weights run gtsrcprob and pass its
    column.

    PSF scale: sigma(E) = sqrt(p0^2 (100 MeV/E)^(2 p1) + p2^2)/3 deg
    with (p0, p1, p2) = (5.445, 0.848, 0.084), the front-converting
    P7-era parameterization the reference convention uses.
    """
    e = np.asarray(energies_mev, np.float64)
    th = np.asarray(angseps_deg, np.float64)
    psfpar0, psfpar1, psfpar2, scalepsf = 5.445, 0.848, 0.084, 3.0
    gamma = 2.0
    sigma = np.sqrt(psfpar0**2 * (100.0 / e) ** (2 * psfpar1)
                    + psfpar2**2) / scalepsf
    fgeom = (1.0 + th**2 / (2.0 * gamma * sigma**2)) ** (-gamma)
    loge = np.log10(e)
    return fgeom * np.exp(-0.5 * ((loge - logeref) / logesig) ** 2)


def _angsep_deg(ra1, dec1, ra2, dec2):
    """Great-circle separation [deg] (Vincenty formula, stable at all
    separations), inputs in degrees; ra2/dec2 may be arrays."""
    l1, b1, l2, b2 = map(np.radians, (ra1, dec1, ra2, dec2))
    dl = l2 - l1
    num = np.hypot(np.cos(b2) * np.sin(dl),
                   np.cos(b1) * np.sin(b2)
                   - np.sin(b1) * np.cos(b2) * np.cos(dl))
    den = (np.sin(b1) * np.sin(b2)
           + np.cos(b1) * np.cos(b2) * np.cos(dl))
    return np.degrees(np.arctan2(num, den))


def load_Fermi_TOAs(ft1file, weightcolumn=None, targetcoord=None,
                    minmjd=-np.inf, maxmjd=np.inf, ephem="de440s",
                    planets=False, logeref=4.1, logesig=0.5):
    """Fermi-LAT FT1 photons (reference: fermi_toas.py::load_Fermi_TOAs).

    weightcolumn: name of a photon-weight column (e.g. from gtsrcprob),
    or "CALC" to compute heuristic PSF weights on the fly from the FT1
    RA/DEC/ENERGY columns and ``targetcoord`` (see calc_lat_weights).
    targetcoord: (ra_deg, dec_deg) of the pulsar, required for CALC.
    """
    if weightcolumn == "CALC":
        if targetcoord is None:
            raise ValueError("weightcolumn='CALC' needs targetcoord="
                             "(ra_deg, dec_deg)")
        from .io.fits import get_table

        table = get_table(ft1file, "EVENTS")
        cols = table[1]

        def col(name):
            return np.asarray(
                cols[next(k for k in cols if k.upper() == name)],
                np.float64)

        angsep = _angsep_deg(targetcoord[0], targetcoord[1],
                             col("RA"), col("DEC"))
        weights = calc_lat_weights(col("ENERGY"), angsep,
                                   logeref=logeref, logesig=logesig)
        return load_event_TOAs(ft1file, "fermi", weights=weights,
                               minmjd=minmjd, maxmjd=maxmjd, ephem=ephem,
                               planets=planets, table=table)
    return load_event_TOAs(ft1file, "fermi", weightcolumn=weightcolumn,
                           minmjd=minmjd, maxmjd=maxmjd, ephem=ephem,
                           planets=planets)


def get_event_weights(toas: TOAs) -> np.ndarray | None:
    """Per-photon weights (TOAs.weights column, with a fallback to
    per-TOA '-weight' flags for tim-file round-trips), or None."""
    if toas.weights is not None:
        return np.asarray(toas.weights, float)
    if not toas.has_flags():
        return None  # lazy flags: don't materialize 1e7 empty dicts
    w = [f.get("weight") for f in toas.flags]
    if any(x is None for x in w):
        return None
    return np.array([float(x) for x in w])
