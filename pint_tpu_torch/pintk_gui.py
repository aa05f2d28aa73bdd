"""Tkinter front-end for interactive fitting — the plk-style GUI
(reference: src/pint/pintk/ — plk.py residual plot with click
selection, fit/undo/reset, jump management, fitbox, colormodes,
random-model spread).

The JAX package's ``pintk_gui.py`` over the port's session. ALL
timing logic lives in the headless, tested
``pint_tpu_torch.pintk.InteractivePulsar``; this module is exclusively
widget plumbing around it, so every button is a one-line delegation to
a tested method. Tk and matplotlib are imported when a window is
built, never with the module; without a display :func:`launch`
refuses and points to the session layer. The drawing logic
(:meth:`PlkGui.redraw`) is tested headless with a stub canvas
(tests/test_torch_pintk.py).

Launch: ``python -m pint_tpu_torch.scripts.pintk par tim [--device]``.
"""

from __future__ import annotations

import numpy as np

COLORS = ("#336699", "#cc3333", "#33a02c", "#ff7f00", "#6a3d9a",
          "#b15928", "#a6cee3", "#fb9a99")


class PlkGui:
    """plk-equivalent window: residual plot + control bar."""

    def __init__(self, session, title="pint_tpu_torch pintk"):
        import tkinter as tk
        from matplotlib.backends.backend_tkagg import (
            FigureCanvasTkAgg, NavigationToolbar2Tk)
        from matplotlib.figure import Figure

        self.session = session
        self.root = tk.Tk()
        self.root.title(title)
        self.colormode = tk.StringVar(value="default")
        self.show_random = tk.BooleanVar(value=False)

        # --- control bar ---
        bar = tk.Frame(self.root)
        bar.pack(side=tk.TOP, fill=tk.X)
        for label, cmd in (
                ("Fit", self.on_fit),
                ("Undo", self.on_undo),
                ("Reset", self.on_reset),
                ("Add jump", self.on_add_jump),
                ("Delete TOAs", self.on_delete),
                ("Restore TOAs", self.on_restore),
                ("Clear sel", self.on_clear_selection),
                ("Write par", self.on_write_par),
                ("Write tim", self.on_write_tim),
        ):
            tk.Button(bar, text=label, command=cmd).pack(side=tk.LEFT)
        import tkinter as _tk

        om = _tk.OptionMenu(bar, self.colormode, "default", "obs", "freq",
                            "jump", command=lambda *_: self.redraw())
        om.pack(side=_tk.LEFT)
        self.xaxis = _tk.StringVar(value="mjd")
        xom = _tk.OptionMenu(bar, self.xaxis, *session.x_axis_choices(),
                             command=lambda *_: self.redraw())
        xom.pack(side=_tk.LEFT)
        _tk.Checkbutton(bar, text="random models", variable=self.show_random,
                        command=self.redraw).pack(side=_tk.LEFT)

        # --- fitbox: checkbox per fittable parameter ---
        self.fit_vars = {}
        fitbox = tk.Frame(self.root)
        fitbox.pack(side=tk.TOP, fill=tk.X)
        model = session.model
        for pname in model.params:
            par = getattr(model, pname)
            if getattr(par, "units", None) is None or par.value is None:
                continue
            if pname not in model.free_params and par.frozen \
                    and not hasattr(par, "uncertainty"):
                continue
            if len(self.fit_vars) >= 12:
                break
            v = tk.BooleanVar(value=pname in model.free_params)
            self.fit_vars[pname] = v
            tk.Checkbutton(fitbox, text=pname, variable=v,
                           command=self.on_fitbox).pack(side=tk.LEFT)

        # --- matplotlib canvas ---
        self.fig = Figure(figsize=(9, 5), dpi=100)
        self.ax = self.fig.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.fig, master=self.root)
        self.canvas.get_tk_widget().pack(side=tk.TOP, fill=tk.BOTH,
                                         expand=True)
        NavigationToolbar2Tk(self.canvas, self.root)
        self._press = None
        self.canvas.mpl_connect("button_press_event", self.on_press)
        self.canvas.mpl_connect("button_release_event", self.on_release)
        self.status = tk.Label(self.root, text="", anchor="w")
        self.status.pack(side=tk.BOTTOM, fill=tk.X)
        self.redraw()

    # ---- drawing ----

    def redraw(self):
        s = self.session
        self.ax.clear()
        xmode = self.xaxis.get()
        xs = s.xvals(xmode)
        self._xs, self._xs_mode = xs, xmode  # reused by drag-selection
        r = s.resids_us()
        err = np.asarray(s.toas.error_us)
        labels = s.color_categories(mode=self.colormode.get())
        cats = sorted(set(labels), key=str)
        for ci, label in enumerate(cats):
            mask = labels == label
            self.ax.errorbar(xs[mask], r[mask], yerr=err[mask], fmt=".",
                             ms=4, color=COLORS[ci % len(COLORS)],
                             label=str(label))
        sel = getattr(s, "selected", None)
        if sel is not None and np.any(sel):
            self.ax.plot(xs[sel], r[sel], "o", mfc="none", ms=9,
                         color="black", label="selected")
        # the spread band only makes sense on time-ordered axes: on
        # frequency/error/orbital-phase it would pair temporally
        # unrelated residuals into a crisscrossing envelope
        if (self.show_random.get() and xmode in ("mjd", "year", "serial")
                and getattr(s, "last_fit", None) is not None):
            spread = s.random_models(n_models=20)
            order = np.argsort(xs)
            self.ax.fill_between(
                xs[order],
                (r + spread.std(axis=0) * 1e6)[order],
                (r - spread.std(axis=0) * 1e6)[order],
                alpha=0.15, color="gray", label="model spread")
        self.ax.set_xlabel(self.xaxis.get())
        self.ax.set_ylabel("residual [us]")
        if len(cats) > 1 or self.show_random.get():
            self.ax.legend(loc="best", fontsize=8)
        self.canvas.draw_idle()
        self._set_status(r)

    def _set_status(self, r):
        s = self.session
        w = 1.0 / np.square(np.asarray(s.toas.error_us))
        wrms = np.sqrt(np.sum(w * r**2) / np.sum(w))
        self.status.config(text=f"{len(s.toas)} TOAs   wrms {wrms:.3f} us")

    # ---- mouse selection (x-range in the CURRENT axis quantity) ----

    def on_press(self, event):
        if event.inaxes is self.ax:
            self._press = event.xdata

    def on_release(self, event):
        if self._press is None or event.inaxes is not self.ax:
            self._press = None
            return
        lo, hi = sorted((self._press, event.xdata))
        self._press = None
        if hi - lo > 1e-6:
            # reuse the draw's xvals (orbital phase recomputation is a
            # full prepare+delay chain) unless the axis changed mid-drag
            xs = (self._xs if getattr(self, "_xs_mode", None)
                  == self.xaxis.get()
                  else self.session.xvals(self.xaxis.get()))
            with np.errstate(invalid="ignore"):
                self.session.select((xs >= lo) & (xs <= hi))
            self.redraw()

    # ---- button handlers: pure delegation ----

    def on_fit(self):
        self.session.fit()
        self.redraw()

    def on_undo(self):
        self.session.undo()
        self.redraw()

    def on_reset(self):
        self.session.reset()
        self.redraw()

    def on_add_jump(self):
        self.session.add_jump_to_selection()
        self.redraw()

    def on_delete(self):
        self.session.delete_selected()
        self.redraw()

    def on_restore(self):
        self.session.restore_all_toas()
        self.redraw()

    def on_clear_selection(self):
        self.session.clear_selection()
        self.redraw()

    def on_fitbox(self):
        names = [p for p, v in self.fit_vars.items() if v.get()]
        self.session.set_fit_params(names)

    def on_write_par(self):
        import tkinter.filedialog as fd

        path = fd.asksaveasfilename(defaultextension=".par")
        if path:
            self.session.write_par(path)

    def on_write_tim(self):
        import tkinter.filedialog as fd

        path = fd.asksaveasfilename(defaultextension=".tim")
        if path:
            self.session.write_tim(path)

    def mainloop(self):
        self.root.mainloop()


def launch(parfile, timfile, device="cuda"):
    """Build the session (its fits and residuals on ``device``) and open
    the window (reference: scripts/pintk.py::main)."""
    import os
    import sys as _sys

    # macOS Aqua Tk needs no X11 $DISPLAY; only block true headless
    if (not os.environ.get("DISPLAY") and os.name != "nt"
            and _sys.platform != "darwin"):
        raise RuntimeError(
            "pintk needs a display (set $DISPLAY or run under a desktop "
            "session). For scripted/headless use, drive "
            "pint_tpu_torch.pintk.InteractivePulsar directly — it is the "
            "same engine without the widgets.")
    import matplotlib

    matplotlib.use("TkAgg")
    from .models import get_model
    from .pintk import InteractivePulsar
    from .toa import get_TOAs

    model = get_model(parfile)
    toas = get_TOAs(timfile, model=model)
    gui = PlkGui(InteractivePulsar(model, toas, device=device))
    gui.mainloop()
    return gui
