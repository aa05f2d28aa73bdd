"""Zero-residual fake TOAs at the geocentre (the JAX package's
``simulation.py::make_fake_toas_fromMJDs``, for ``obs="geocenter"``).

(reference: src/pint/simulation.py — iterate the phase->time inversion
until residuals vanish, then optionally add Gaussian measurement
noise.)

Host ingest (clock chains, UTC->TDB, observatory posvels) is not
ported yet, so the epochs given here are taken as TDB at the geocentre
(the JAX package reads them as UTC and converts them with
``timescales.py``): the observatory is the Earth's centre, and the
Earth, the Sun and the planets come from the ephemeris tiers
(``ephemeris/``: the shipped numeph kernel inside its coverage), as the
JAX package's ``GeocenterObs`` takes them.
"""

from __future__ import annotations

import numpy as np

from .constants import SECS_PER_DAY
from .ephemeris import ephemeris_provider, objPosVel_wrt_SSB
from .mjd import Epochs
from .observatory import solar_system_posvels
from .toa import TOAs
from .utils import PosVel


def geocenter_posvels(toas: TOAs):
    """Fill ``tdb``, ``ssb_obs``, ``obs_sun`` (and ``planet_pos`` when
    ``toas.planets``) for geocentric TOAs whose epochs are TDB: the
    ephemeris tier is resolved once on every epoch, the observatory is
    the Earth with its velocity from that tier (JAX
    ``GeocenterObs.posvel_ssb``), and the Sun and planets are taken
    relative to it."""
    toas.tdb = Epochs(toas.day, toas.sec, "tdb")
    toas.ephem_provider = ephemeris_provider(toas.ephem, toas.tdb)
    earth = objPosVel_wrt_SSB("earth", toas.tdb, toas.ephem,
                              provider=toas.ephem_provider)
    toas.ssb_obs = PosVel(earth.pos, earth.vel, origin="ssb", obj="obs")
    return solar_system_posvels(toas, earth)


def _iterate_zero_residuals(toas: TOAs, model, iterations=4, device="cuda"):
    """Shift TOA times until model residuals are ~0 (sub-ns).

    (reference: simulation.py internal zero_residual iteration)
    """
    for _ in range(iterations):
        geocenter_posvels(toas)
        prepared = model.prepare(toas, device=device)
        frac, _ = prepared.phase_frac_and_int()
        shift = (frac / prepared.params0["F"][0]).cpu().numpy()
        toas.adjust_times(-shift)
    return geocenter_posvels(toas)


def make_fake_toas_fromMJDs(mjds, model, error_us=1.0, freq_mhz=1400.0,
                            obs="geocenter", add_noise=False, seed=None,
                            iterations=4, flags=None, device="cuda") -> TOAs:
    """(reference: simulation.py::make_fake_toas_fromMJDs)

    Zero-residual TOAs at the TDB epochs ``mjds`` for a geocentric
    observer; ``flags`` (dict) is applied to every TOA. ``add_noise``
    adds white noise at the model-scaled uncertainty, drawn from
    ``numpy.random.default_rng(seed)``. The phase evaluations run on
    ``device``.
    """
    if obs != "geocenter":
        raise NotImplementedError(
            f"obs={obs!r}: only geocentric fake TOAs are ported (observatory "
            "posvels and clock chains are host ingest, not ported yet)")
    mjds = np.asarray(mjds, dtype=np.float64)
    day = np.floor(mjds).astype(np.int64)
    sec = (mjds - day) * SECS_PER_DAY
    base_flags = {"simulated": "1", **{k: str(v) for k, v in (flags or {}).items()}}
    ephem = "de440s"
    if "EPHEM" in model.params and model.EPHEM.value:
        ephem = model.EPHEM.value.lower()
    toas = TOAs.from_arrays(day, sec, error_us=error_us, freq_mhz=freq_mhz,
                            obs=obs, flags=[dict(base_flags) for _ in mjds],
                            ephem=ephem)
    toas.planets = ("PLANET_SHAPIRO" in model.params
                    and bool(model.PLANET_SHAPIRO.value))
    _iterate_zero_residuals(toas, model, iterations=iterations, device=device)
    if add_noise:
        # draw at the MODEL-scaled uncertainty (EFAC/EQUAD applied), so
        # simulated data matches what the fitter whitens with
        rng = np.random.default_rng(seed)
        sigma_us = model.prepare(toas, device=device).scaled_sigma_us()
        toas.adjust_times(rng.standard_normal(len(toas))
                          * sigma_us.cpu().numpy() * 1e-6)
        geocenter_posvels(toas)
    return toas
