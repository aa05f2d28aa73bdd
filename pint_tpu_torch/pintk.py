"""Headless interactive-fitting state — the logic layer of the
reference's pintk GUI, without Tk (the JAX package's ``pintk.py``).

(reference: src/pint/pintk/pulsar.py::Pulsar — the GUI-independent
wrapper that pintk's plk widget drives: fit/undo/reset, TOA
selection, per-selection jump add/remove, random-model spread.) This
class is the tested surface; ``pintk_gui.PlkGui`` is widget plumbing
over it. The session's residuals, fits and random models run on
``device`` (default ``"cuda"``), which is passed on to the fitter
factory and to ``Residuals``; every array it returns is host numpy.
"""

from __future__ import annotations

import copy

import numpy as np

from . import resolve_device
from .fitter import auto_fitter
from .residuals import Residuals
from .simulation import calculate_random_models


class InteractivePulsar:
    """Mutable fit session over (model, TOAs) with undo history.

    (reference: pintk/pulsar.py::Pulsar)
    """

    def __init__(self, model, toas, fitter_factory=auto_fitter,
                 device="cuda"):
        self.toas = toas
        self.fitter_factory = fitter_factory
        self.device = resolve_device(device)
        self._history = [copy.deepcopy(model)]
        # parallel to _history: whether each entry came from a fit
        # (par edits also grow history, so len(history)>1 != fitted)
        self._from_fit = [False]
        self.selected = np.zeros(len(toas), dtype=bool)
        self.fitted = False
        self.last_fit = None
        self._all_toas = None  # pre-deletion snapshot (restore_all_toas)

    @property
    def model(self):
        return self._history[-1]

    @property
    def prefit_model(self):
        return self._history[0]

    # -- residuals --

    def resids_us(self, model=None) -> np.ndarray:
        r = Residuals(self.toas, model or self.model, device=self.device)
        return r.calc_time_resids().cpu().numpy() * 1e6

    def whitened_resids(self) -> np.ndarray:
        """Dimensionless whitened residuals of the last fit — with a
        GLS fit, the fitted noise realizations are subtracted first
        (reference: plk whitened plotting mode backed by
        Residuals.calc_whitened_resids)."""
        if self.last_fit is None:
            raise ValueError("no fit yet — run fit() first")
        return self.last_fit.resids.calc_whitened_resids().cpu().numpy()

    # -- selection (reference: plk click/drag selection) --

    def select(self, mask):
        self.selected = np.asarray(mask, dtype=bool).copy()

    def select_mjd_range(self, lo, hi):
        mjd = self.toas.get_mjds()
        self.selected = (mjd >= lo) & (mjd <= hi)

    def clear_selection(self):
        self.selected[:] = False

    # -- fitting with history (reference: Pulsar.fit / undo / reset) --

    def fit(self, **kw):
        model = copy.deepcopy(self.model)
        fitter = self.fitter_factory(self.toas, model, device=self.device)
        fitter.fit_toas(**kw)
        self._history.append(fitter.model)
        self._from_fit.append(True)
        self.fitted = True
        self.last_fit = fitter
        return fitter

    def undo(self):
        if len(self._history) > 1:
            self._history.pop()
            self._from_fit.pop()
        self.fitted = self._from_fit[-1]
        if not self.fitted:
            self.last_fit = None
        return self.model

    def reset(self):
        del self._history[1:]
        del self._from_fit[1:]
        self.fitted = False
        self.last_fit = None

    # -- jumps on the current selection (reference: Pulsar.add_jump) --

    def add_jump_to_selection(self):
        """JUMP the selected TOAs via a per-TOA flag mask; returns the
        new jump parameter name."""
        if not self.selected.any():
            raise ValueError("no TOAs selected")
        model = self.model
        if "PhaseJump" not in model.components:
            from .models.jump import PhaseJump

            model.add_component(PhaseJump())
        comp = model.components["PhaseJump"]
        idx = (max(comp.jump_ids) + 1) if comp.jump_ids else 1
        flag_val = f"pintk_{idx}"
        for i in np.flatnonzero(self.selected):
            self.toas.flags[i]["jump"] = flag_val
        par = comp.add_jump(key="-jump", key_value=[flag_val], index=idx)
        return par.name

    def remove_jump(self, name):
        comp = self.model.components.get("PhaseJump")
        if comp is None or name not in comp.params:
            raise KeyError(name)
        idx = int(name[4:])
        par = getattr(comp, name)
        if par.key == "-jump":
            tag = par.key_value[0]
            for f in self.toas.flags:
                if f.get("jump") == tag:
                    del f["jump"]
        comp.remove_param(name)
        comp.jump_ids.remove(idx)

    # -- TOA deletion (reference: plk delete/restore on selection) --

    def delete_selected(self):
        """Drop the selected TOAs from the working set (the full set is
        kept for restore, mirroring pintk's all_toas/selected_toas
        split: reference pintk/pulsar.py::Pulsar.delete_TOAs)."""
        if not self.selected.any():
            raise ValueError("no TOAs selected")
        if self._all_toas is None:
            self._all_toas = self.toas
        keep = ~self.selected
        self.toas = self.toas.mask(keep)
        self.selected = np.zeros(len(self.toas), dtype=bool)

    def restore_all_toas(self):
        """Undo every deletion (reference: Pulsar.reset_TOAs side)."""
        if self._all_toas is not None:
            self.toas = self._all_toas
            self._all_toas = None
        self.selected = np.zeros(len(self.toas), dtype=bool)

    # -- pulse numbers / phase wraps (reference: Pulsar.add_phase_wrap) --

    def compute_pulse_numbers(self):
        """Stamp model-predicted pulse numbers into the pn flags so
        residual tracking survives wraps/deletions (reference:
        TOAs.compute_pulse_numbers + pintk track mode)."""
        r = Residuals(self.toas, self.model, track_mode="nearest",
                      device=self.device)
        frac, pulse_int = r.prepared.phase_frac_and_int(None)
        pn = pulse_int.cpu().numpy() + np.round(frac.cpu().numpy())
        for i, f in enumerate(self.toas.flags):
            f["pn"] = repr(int(pn[i]))
        return pn

    def add_phase_wrap(self, n_wraps: int):
        """Add +-N integer turns to the selected TOAs' pulse numbers
        (reference: pintk/pulsar.py::Pulsar.add_phase_wrap). Computes
        pulse numbers first unless every SELECTED TOA already carries
        one (delete/restore cycles can leave partial stamping)."""
        if not self.selected.any():
            raise ValueError("no TOAs selected")
        sel_idx = np.flatnonzero(self.selected)
        if not all("pn" in self.toas.flags[i] for i in sel_idx):
            self.compute_pulse_numbers()
        for i in sel_idx:
            f = self.toas.flags[i]
            f["pn"] = repr(int(float(f["pn"])) + int(n_wraps))

    # -- color modes (reference: pintk/colormodes.py, headless form) --

    COLOR_MODES = ("default", "obs", "freq", "error", "jump", "selected")

    def color_categories(self, mode="default"):
        """Per-TOA category labels for plotting frontends: the logic
        layer of pintk's colormodes (DefaultMode/ObservatoryMode/
        FreqMode/ErrorMode/JumpMode) without Tk or colors."""
        n = len(self.toas)
        if mode == "default":
            return np.array(["prefit" if not self.fitted else "postfit"] * n,
                            dtype=object)
        if mode == "obs":
            return self.toas.obs.astype(object)
        if mode == "freq":
            f = self.toas.freq_mhz
            bands = [(0.0, "<400"), (400.0, "400-700"), (700.0, "700-1000"),
                     (1000.0, "1000-1800"), (1800.0, "1800-3000"),
                     (3000.0, ">3000")]
            out = np.empty(n, dtype=object)
            for lo, name in bands:
                out[f >= lo] = name
            out[~np.isfinite(f)] = "inf"
            return out
        if mode == "error":
            med = np.median(self.toas.error_us)
            return np.where(self.toas.error_us > med, "above-median",
                            "below-median").astype(object)
        if mode == "jump":
            tags = self.toas.get_flag_value("jump", fill="")
            return np.array([t if t else "unjumped" for t in tags],
                            dtype=object)
        if mode == "selected":
            return np.where(self.selected, "selected",
                            "unselected").astype(object)
        raise ValueError(f"unknown color mode {mode!r}; "
                         f"choose from {self.COLOR_MODES}")

    # -- x-axis quantities (reference: pintk/plk.py xy-axis choices) --

    X_AXIS_CHOICES = ("mjd", "serial", "year", "day of year", "frequency",
                      "TOA error", "orbital phase")

    def xvals(self, mode="mjd"):
        """Per-TOA x-axis values for the residual plot, matching plk's
        x-axis dropdown. 'orbital phase' requires a binary model."""
        import datetime

        from .constants import DAYS_PER_JULIAN_YEAR, MJD_J2000

        t = self.toas
        if mode == "mjd":
            return t.get_mjds()
        if mode == "serial":
            return np.arange(len(t), dtype=float)
        if mode == "year":
            return 2000.0 + (t.get_mjds() - MJD_J2000) / DAYS_PER_JULIAN_YEAR
        if mode == "day of year":
            mjd0 = datetime.date(1858, 11, 17).toordinal()
            return np.array(
                [datetime.date.fromordinal(int(m) + mjd0).timetuple().tm_yday
                 + (m % 1.0) for m in t.get_mjds()])
        if mode == "frequency":
            f = np.asarray(t.freq_mhz)
            # infinite-frequency (barycentered) TOAs would break axis
            # autoscale; nan makes matplotlib skip them
            return np.where(np.isfinite(f), f, np.nan)
        if mode == "TOA error":
            return np.asarray(t.error_us)
        if mode == "orbital phase":
            return self.model.orbital_phase(t, device=self.device)
        raise ValueError(f"unknown x-axis mode {mode!r}; "
                         f"choose from {self.X_AXIS_CHOICES}")

    def x_axis_choices(self):
        """The modes valid for THIS model (orbital phase only for
        binaries)."""
        has_binary = any(c.category == "pulsar_system"
                         for c in self.model.delay_components())
        return tuple(m for m in self.X_AXIS_CHOICES
                     if has_binary or m != "orbital phase")

    # -- fit-parameter checkboxes (reference: plk fitbox) --

    def set_fit_params(self, names):
        """Free exactly these parameters (the plk fitbox behavior)."""
        self.model.free_params = list(names)

    # -- par/tim editing (reference: pintk/paredit.py + timedit.py) --

    def apply_parfile(self, par_text: str):
        """Replace the working model with an edited par file, keeping
        history (paredit's 'apply changes'). The previous fit no
        longer describes the working model, so last_fit is dropped
        (random_models must not spread around a stale covariance)."""
        from .models import get_model

        self._history.append(get_model(par_text))
        self._from_fit.append(False)
        self.fitted = False
        self.last_fit = None

    def write_par(self, path):
        with open(path, "w") as f:
            f.write(self.model.as_parfile())

    def write_tim(self, path):
        self.toas.write_TOA_file(path)

    # -- random-model spread (reference: Pulsar.random_models) --

    def random_models(self, n_models=30, seed=0):
        if self.last_fit is None:
            raise RuntimeError("fit first")
        return calculate_random_models(self.last_fit, self.toas,
                                       n_models=n_models, seed=seed)
