"""Absolute phase reference (TZRMJD/TZRSITE/TZRFRQ), torch counterpart
of the JAX package's ``models/absolute_phase.py``.

(reference: src/pint/models/absolute_phase.py::AbsPhase —
get_TZR_toa builds a single TOA at the reference epoch/site/frequency
and pushes it through the full pipeline; model phase is then quoted
relative to that TOA, so absolute pulse numbers agree across
observatories and with external ephemerides.)

The TZR TOA goes through the host ingest chain (clock corrections,
UTC->TDB, posvels at TZRSITE); its phase is evaluated on the device the
model is being prepared for.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .timing_model import PhaseComponent


class AbsPhase(PhaseComponent):
    category = "absolute_phase"
    order = 90

    # TZRMJD/TZRSITE/TZRFRQ are top-level model parameters
    # (builder.py TOP_LEVEL_*); this component consumes them.

    def __init__(self):
        super().__init__()
        self._tzr_cache: tuple[str, float, float] | None = None

    def get_TZR_toa(self, model):
        """The 1-TOA table at the reference point
        (reference: absolute_phase.py::AbsPhase.get_TZR_toa)."""
        from ..toa import TOA, TOAs

        tzr = model.TZRMJD
        site = ((model.TZRSITE.value or "barycenter")
                if "TZRSITE" in model.params else "barycenter")
        freq = (model.TZRFRQ.value if "TZRFRQ" in model.params
                and model.TZRFRQ.value is not None else np.inf)
        if freq == 0.0:
            # tempo convention: TZRFRQ 0 means infinite frequency
            freq = np.inf
        ephem = (model.EPHEM.value if "EPHEM" in model.params
                 and model.EPHEM.value else "de440s")
        planets = ("PLANET_SHAPIRO" in model.params
                   and bool(model.PLANET_SHAPIRO.value))
        t = TOAs([TOA(int(tzr.day), float(tzr.sec), error_us=0.0,
                      freq_mhz=freq, obs=site)], ephem=ephem, planets=planets)
        t.apply_clock_corrections()
        t.compute_TDBs()
        t.compute_posvels()
        return t

    def pack(self, model, toas, prep, params0, device=None):
        if "TZRMJD" not in model.params or model.TZRMJD.value is None:
            prep["tzr_frac"] = np.float64(0.0)
            return
        # the TZR phase depends only on the model, not on the data TOAs:
        # cache it across prepare() calls, keyed on the model's state
        from ..utils import compute_hash

        key = compute_hash(model.as_parfile())
        if self._tzr_cache is not None and self._tzr_cache[0] == key:
            _, tzr_int, tzr_frac = self._tzr_cache
        else:
            tzr_toas = self.get_TZR_toa(model)
            # the model's own phase at the TZR point, without this
            # component (no recursion), at the reference parameters
            m2 = copy.deepcopy(model)
            m2.remove_component("AbsPhase")
            ph = m2.prepare(tzr_toas, device=device).phase()
            tzr_frac = float(ph.frac[0])
            tzr_int = float(ph.int_[0])
            self._tzr_cache = (key, tzr_int, tzr_frac)
        prep["tzr_frac"] = np.float64(tzr_frac)
        # fold the integer reference into the packed integer phase, so
        # Phase.int_ counts pulses since the TZR TOA
        prep["phi_ref_int"] = prep["phi_ref_int"] - np.float64(tzr_int)

    def phase(self, params, batch, prep, delay_total):
        return -prep["tzr_frac"] * torch.ones_like(batch.tdb_sec)
