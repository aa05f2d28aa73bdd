"""TimingModel: component container + device preparation (torch).

Counterpart of the JAX package's ``models/timing_model.py``
(reference: src/pint/models/timing_model.py — TimingModel, Component,
DelayComponent, PhaseComponent).

- **Host**: ``TimingModel`` holds Parameter metadata and Component
  instances. ``model.prepare(toas, device=)`` runs every component's
  ``pack`` on the host (numpy; the spindown reference phase in
  longdouble) and moves the packed tree to the device in one pass.
- **Device**: the component methods evaluate exact small-delta terms
  in float64 torch, exactly as the JAX package does.

Phase identity used on device (exact algebra, f64-safe term by term)::

    phi(T - d) = phi_ref(T)                      # host longdouble, (int, frac)
             + sum_i dF_i T^(i+1)/(i+1)!         # dF_i = F_i - F_ref_i, small
             - d * sum_i F_i/(i+1)! * sum_{j<=i} T^(i-j) (T-d)^j

where T = tdb - PEPOCH (packed as exact (hi, lo) seconds) and d is the
total delay (<~3000 s, f64).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import DTYPE, autodiff, resolve_device
from ..constants import SECS_PER_DAY
from ..mjd import LD
from ..toa import TOABatch
from .parameter import Parameter


class TimingModelError(Exception):
    pass


class MissingParameter(TimingModelError):
    def __init__(self, component, param, msg=""):
        super().__init__(f"{component} requires {param} {msg}")
        self.component = component
        self.param = param


class Component:
    """Base component; subclasses register themselves by class name in
    ``component_types`` (reference: timing_model.py::Component + the
    ModelMeta metaclass), which ``utils.list_parameters`` reads."""

    component_types: dict[str, type] = {}
    category = ""
    order = 50  # delay evaluation order; lower = earlier

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if not cls.__name__.startswith("_"):
            Component.component_types[cls.__name__] = cls

    def __init__(self):
        self.params: list[str] = []
        self._parent: TimingModel | None = None

    def add_param(self, par: Parameter):
        setattr(self, par.name, par)
        par._component = self
        self.params.append(par.name)

    def remove_param(self, name: str):
        """Drop a parameter inherited from a superclass that this
        variant does not support (reference: Component.remove_param)."""
        self.params.remove(name)
        delattr(self, name)

    def setup(self):
        pass

    def validate(self):
        pass

    @property
    def free_params_component(self):
        return [p for p in self.params if not getattr(self, p).frozen]

    # --- device hooks ---
    def pack(self, model, toas, prep: dict, params0: dict, device=None):
        """Host-side: add numpy arrays to prep, values to params0.
        ``device`` is the prepare's, for a pack that itself evaluates
        the model there (AbsPhase's TZR phase)."""

    def delay(self, params, batch, prep, delay_accum):
        """Device: delay seconds added by this component."""
        raise NotImplementedError

    def phase(self, params, batch, prep, delay_total):
        """Device: small phase contribution in cycles."""
        raise NotImplementedError


class DelayComponent(Component):
    kind = "delay"


class PhaseComponent(Component):
    kind = "phase"


class TimingModel:
    """(reference: timing_model.py::TimingModel — the parameter and
    component surface the GLS slice uses)."""

    def __init__(self, components=(), name=""):
        self.name = name
        self.components: dict[str, Component] = {}
        self.top_params: list[str] = []
        self._top: dict[str, Parameter] = {}
        for c in components:
            self.add_component(c)

    def add_component(self, comp: Component):
        comp._parent = self
        self.components[type(comp).__name__] = comp

    def remove_component(self, name: str):
        del self.components[name]

    def add_top_param(self, par: Parameter):
        self._top[par.name] = par
        self.top_params.append(par.name)

    def __getattr__(self, name):
        # delegate parameter lookup to the owning component
        if name.startswith("_") or name in ("components", "top_params"):
            raise AttributeError(name)
        top = self.__dict__.get("_top", {})
        if name in top:
            return top[name]
        for comp in self.__dict__.get("components", {}).values():
            if name in comp.params:
                return getattr(comp, name)
        raise AttributeError(f"TimingModel has no parameter or attribute {name!r}")

    @property
    def params(self) -> list[str]:
        out = list(self.top_params)
        for comp in self.components.values():
            out.extend(comp.params)
        return out

    @property
    def free_params(self) -> list[str]:
        return [p for p in self.params if p not in self.top_params
                and not getattr(self, p).frozen]

    @free_params.setter
    def free_params(self, names):
        # check every name before touching a frozen flag: a typo must
        # not leave a half-rewritten free-parameter set
        missing = set(names) - set(self.params)
        if missing:
            raise KeyError(f"unknown params {missing}")
        for p in self.params:
            if p in self.top_params:
                continue
            getattr(self, p).frozen = p not in names

    def get_params_dict(self):
        return {p: getattr(self, p).value for p in self.params}

    def delay_components(self):
        return sorted([c for c in self.components.values() if c.kind == "delay"],
                      key=lambda c: c.order)

    def phase_components(self):
        return sorted([c for c in self.components.values() if c.kind == "phase"],
                      key=lambda c: c.order)

    def setup(self):
        for c in self.components.values():
            c.setup()

    def validate(self):
        for c in self.components.values():
            c.validate()

    def map_component(self, name: str):
        for comp in self.components.values():
            if name in comp.params:
                return comp
        raise KeyError(name)

    def prepare(self, toas, subtract_mean=True,
                device="cuda") -> "PreparedTiming":
        return PreparedTiming(self, toas, subtract_mean=subtract_mean,
                              device=device)

    def phase(self, toas, abs_phase=False, device="cuda"):
        """The model's pulse phase at ``toas`` as a
        :class:`~pint_tpu_torch.phase.Phase` of tensors on ``device``
        (reference: TimingModel.phase; ``abs_phase`` is accepted and
        ignored, as there)."""
        return self.prepare(toas, device=device).phase()

    def delay(self, toas, device="cuda"):
        """Total delay [s] at each TOA, a tensor on ``device``."""
        return self.prepare(toas, device=device).delay()

    def designmatrix(self, toas, incoffset=True, device="cuda"):
        """(M, labels): d(phase)/d(param) [cycles per unit], by
        forward-mode autodiff on ``device``."""
        return self.prepare(toas, device=device).designmatrix(
            incoffset=incoffset)

    def scaled_toa_uncertainty(self, toas, device="cuda"):
        """EFAC/EQUAD-scaled sigma [us] (reference: noise_model scaled
        sigma)."""
        return self.prepare(toas, device=device).scaled_sigma_us()

    # ---- par file round trip (reference: TimingModel.as_parfile) ----

    # parameter spellings tempo/tempo2 expect on output; the reader
    # accepts both, so format="pint" files stay canonical (the JAX
    # package's tables)
    _TEMPO2_RENAMES = {
        "EFAC": "T2EFAC", "EQUAD": "T2EQUAD", "STIGMA": "VARSIGMA",
        "A1DOT": "XDOT", "NE_SW": "NE1AU", "ELONG": "LAMBDA",
        "ELAT": "BETA", "PMELONG": "PMLAMBDA", "PMELAT": "PMBETA",
    }
    _TEMPO_RENAMES = {
        "ELONG": "LAMBDA", "ELAT": "BETA",
        "PMELONG": "PMLAMBDA", "PMELAT": "PMBETA", "NE_SW": "SOLARN0",
        "A1DOT": "XDOT", "STIGMA": "VARSIGMA",
    }

    def as_parfile(self, format="pint") -> str:
        """Serialize the model (reference: TimingModel.as_parfile with
        format in {"pint", "tempo", "tempo2"}): the top-level lines,
        then every delay and phase component's parameters, then the
        noise components' (EFAC/EQUAD/ECORR/red noise are model state
        too). A binary component writes its BINARY line first, so the
        file rebuilds the same model. tempo and tempo2 get the same
        values under their spellings (T2EFAC, VARSIGMA, LAMBDA, ...), a
        UNITS TDB line when the model has none, and tempo a MODE 1
        header."""
        if format not in ("pint", "tempo", "tempo2"):
            raise ValueError(f"unknown par file format {format!r} "
                             "(expected pint, tempo, or tempo2)")
        renames = (self._TEMPO2_RENAMES if format == "tempo2"
                   else self._TEMPO_RENAMES if format == "tempo" else {})
        lines = [f"{'MODE':<15} 1\n"] if format == "tempo" else []
        lines += [self._top[p].as_parfile_line() for p in self.top_params
                  if not (format == "tempo" and p == "MODE")]
        if format != "pint" and "UNITS" not in self.top_params:
            lines.append(f"{'UNITS':<15} TDB\n")
        ordered = list(self.delay_components()) + list(self.phase_components())
        ordered += [c for c in self.components.values() if c not in ordered]
        for comp in ordered:
            name = getattr(comp, "binary_model_name", None)
            if name is not None:
                lines.append(f"{'BINARY':<15} {name}\n")
            lines.extend(getattr(comp, p).as_parfile_line()
                         for p in comp.params)
        return "".join(_rename_line(l, renames) for l in lines if l)

    def write_parfile(self, path, format="pint"):
        with open(path, "w") as f:
            f.write(self.as_parfile(format=format))

    def compare(self, other: "TimingModel", sigma=None) -> str:
        """Pre/post-fit comparison table (reference: TimingModel.compare).

        ``sigma``: only list parameters whose difference exceeds this
        many combined uncertainties (parameters with no uncertainty on
        either side are shown when their values differ)."""
        rows = [f"{'PARAM':<12} {'SELF':>20} {'OTHER':>20} {'DIFF/UNC':>10}"]
        for p in self.params:
            a = getattr(self, p)
            b = getattr(other, p, None) if p in other.params else None
            if a.kind in ("str",) or a.value is None or b is None or b.value is None:
                continue
            try:
                diff = float(b.value) - float(a.value)
            except (TypeError, ValueError):
                continue
            # combined (quadrature) uncertainty when both sides have one
            ua, ub = a.uncertainty or 0.0, b.uncertainty or 0.0
            unc = float(np.hypot(ua, ub)) or None
            if sigma is not None:
                if unc:
                    if abs(diff) < sigma * unc:
                        continue
                elif diff == 0.0:
                    continue
            rel = f"{diff / unc:.2f}" if unc else "-"
            rows.append(f"{p:<12} {float(a.value):>20.12g} {float(b.value):>20.12g} {rel:>10}")
        return "\n".join(rows)

    # ---- host diagnostics (reference: TimingModel conveniences) ----

    def total_dm(self, toas, device="cuda"):
        """Model DM at each TOA [pc/cm^3], numpy: every nu^-2
        dispersion term — the DM Taylor series, DMX windows, DMWaveX
        and solar wind (reference: TimingModel.total_dm). DMJUMP
        offsets are left out: they apply to wideband DM measurements."""
        from ..residuals import wideband_dm_model

        prepared = self.prepare(toas, device=device)
        return wideband_dm_model(
            self, prepared.params0, prepared.prep, batch=prepared.batch,
            include_jumps=False).cpu().numpy()

    def d_phase_d_toa(self, toas, sample_step_s=1.0, device="cuda"):
        """Instantaneous topocentric spin frequency [Hz] at each TOA
        (reference: TimingModel.d_phase_d_toa): a central difference
        through the whole pipeline, so every delay's time dependence
        (Doppler from the observatory's motion included) is in it."""
        h = float(sample_step_s)
        keep = np.ones(len(toas), dtype=bool)
        tp = toas.mask(keep)
        tp.adjust_times(+h)
        tm = toas.mask(keep)
        tm.adjust_times(-h)
        php = self.prepare(tp, device=device).phase()
        phm = self.prepare(tm, device=device).phase()
        dint = (php.int_ - phm.int_).cpu().numpy()
        dfrac = (php.frac - phm.frac).cpu().numpy()
        return (dint + dfrac) / (2.0 * h)

    def _delay_contributions(self, prepared):
        """(component, contribution) over delay_components() with the
        chain's accumulation convention (as in _delay_impl)."""
        d = torch.zeros_like(prepared.batch.tdb_sec)
        for comp in self.delay_components():
            di = comp.delay(prepared.params0, prepared.batch,
                            prepared.prep, d)
            d = d + di
            yield comp, di

    def _delay_until(self, prepared, stop_comp):
        """Accumulated delay up to but excluding ``stop_comp``
        (None = all components)."""
        d = torch.zeros_like(prepared.batch.tdb_sec)
        for comp, di in self._delay_contributions(prepared):
            if comp is stop_comp:
                break
            d = d + di
        return d

    def delay_breakdown(self, toas, device="cuda"):
        """{component name: per-TOA delay [s], numpy} in evaluation
        order, each with the accumulated upstream delay exactly as in
        the full chain, so the values sum to ``delay(toas)``."""
        prepared = self.prepare(toas, device=device)
        return {type(comp).__name__: di.cpu().numpy()
                for comp, di in self._delay_contributions(prepared)}

    def get_barycentric_toas(self, toas, cutoff_component=None,
                             device="cuda"):
        """Barycentric arrival times [TDB MJD, float64 numpy]: the TDB
        TOA times minus every delay up to but excluding
        ``cutoff_component`` (default: the binary component, so binary
        pulsars get infinite-frequency barycentric orbital times)
        (reference: TimingModel.get_barycentric_toas)."""
        prepared = self.prepare(toas, device=device)
        delays = self.delay_components()
        if cutoff_component is None:
            stop = next((c for c in delays
                         if c.category == "pulsar_system"), None)
        else:
            stop = next((c for c in delays
                         if c.__class__.__name__ == cutoff_component), None)
            if stop is None:
                raise KeyError(f"no delay component named "
                               f"{cutoff_component!r} (have "
                               f"{[c.__class__.__name__ for c in delays]})")
        d = self._delay_until(prepared, stop).cpu().numpy()
        return (prepared.batch.tdb_day.cpu().numpy()
                + (prepared.batch.tdb_sec.cpu().numpy() - d) / SECS_PER_DAY)

    def orbital_phase(self, toas, radians=False, device="cuda"):
        """Mean orbital phase at each TOA, numpy — cycles in [0, 1) by
        default, radians in [0, 2 pi) with ``radians=True`` — from the
        binary epoch (T0, or TASC for ELL1 models) (reference:
        TimingModel.orbital_phase)."""
        binary = next((c for c in self.delay_components()
                       if c.category == "pulsar_system"), None)
        if binary is None:
            raise AttributeError("model has no binary component")
        prepared = self.prepare(toas, device=device)
        d = self._delay_until(prepared, binary)
        phi = binary.orbital_phase(prepared.params0, prepared.prep,
                                   d).cpu().numpy()
        cycles = (phi / (2.0 * np.pi)) % 1.0
        return cycles * (2.0 * np.pi) if radians else cycles


def _rename_line(line, renames):
    """``line`` with its leading name replaced from ``renames``, keeping
    the name field's width (15 for plain parameters, 8 for mask
    prefixes) so the columns stay aligned."""
    head = line.split(" ", 1)[0]
    if head not in renames:
        return line
    body = line.rstrip("\n")
    rest = body[len(head):].lstrip()
    field_w = len(body) - len(rest) - 1
    new = renames[head]
    return f"{new:<{max(field_w, len(new))}} {rest}\n"


def _delay_impl(model, params, batch, prep):
    d = torch.zeros_like(batch.tdb_sec)
    for comp in model.delay_components():
        d = d + comp.delay(params, batch, prep, d)
    return d


def _phase_impl(model, params, batch, prep):
    d = _delay_impl(model, params, batch, prep)
    ph = torch.zeros_like(d)
    for comp in model.phase_components():
        ph = ph + comp.phase(params, batch, prep, d)
    return ph  # cycles; includes phi_ref_frac via spindown component


def _sigma_impl(model, params, batch, prep):
    sigma = batch.error_us
    for comp in model.components.values():
        scale = getattr(comp, "scale_sigma", None)
        if scale is not None:
            sigma = scale(params, batch, prep, sigma)
    return sigma


def _overlay_params(x, params0, free_map):
    """Overlay flat free-param vector x onto the params0 dict.

    Functional (``torch.where`` on a one-hot index, never an in-place
    write) so it composes with ``torch.func.jacfwd``/``vmap``. The JAX
    package routes the result through ``lax.optimization_barrier`` to
    stop XLA constant-folding frozen params at f32 precision on the TPU
    backend; PyTorch runs eagerly and folds nothing, so the barrier has
    no counterpart here.
    """
    p = dict(params0)
    for i, (_, key, idx) in enumerate(free_map):
        if idx is None:
            p[key] = x[..., i]
        else:
            v = p[key]
            hot = torch.arange(v.shape[-1], device=v.device) == idx
            p[key] = torch.where(hot, x[..., i, None], v)
    return p


def host_to_device(tree, device):
    """Move the numeric numpy leaves of a prep/params dict to ``device``:
    floats as float64, integers as int64 (torch indexes with int64),
    booleans as bool. Python scalars, tuples, strings and longdouble
    arrays stay on the host untouched."""
    out = {}
    for k, v in tree.items():
        kind = (v.dtype.kind if isinstance(v, (np.ndarray, np.generic))
                and v.dtype.itemsize <= 8 else None)
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        elif kind == "f":
            out[k] = torch.as_tensor(np.array(v, np.float64), device=device)
        elif kind in ("i", "u"):
            out[k] = torch.as_tensor(np.array(v, np.int64), device=device)
        elif kind == "b":
            out[k] = torch.as_tensor(np.array(v, bool), device=device)
        elif isinstance(v, np.ndarray) and not v.flags.writeable:
            out[k] = np.array(v)  # a read-only view (a mapped file)
        else:
            out[k] = v
    return out


class PreparedTiming:
    """Model x TOAs packed for device execution: the TOABatch, the prep
    dict, the initial params dict (all float64 tensors on ``device``)
    and the residual/design functions of the free-parameter vector."""

    def __init__(self, model, toas, subtract_mean=True, device="cuda"):
        dev = resolve_device(device)
        toas.ensure_posvels()
        self.model = model
        self.toas = toas
        self.subtract_mean = subtract_mean
        self.device = dev
        prep: dict = {}
        params0: dict = {}
        # exact T = tdb - PEPOCH split, shared by spindown/astrometry/...
        pepoch = model.PEPOCH if "PEPOCH" in model.params else None
        if pepoch is not None and pepoch.day is not None:
            pd, psec = pepoch.day, pepoch.sec
        else:
            pd, psec = int(np.median(toas.tdb.day)), 0.0
        t_hi = (toas.tdb.day - pd).astype(np.float64) * SECS_PER_DAY
        t_lo = toas.tdb.sec - psec
        prep["pepoch_day"] = pd
        prep["pepoch_sec"] = psec
        prep["T_hi"] = t_hi
        prep["T_lo"] = t_lo
        prep["T_ld"] = LD(t_hi) + LD(t_lo)  # host-side longdouble copy
        for comp in model.components.values():
            comp.pack(model, toas, prep, params0, device=dev)
        if "phi_ref_int" not in prep:
            prep["phi_ref_int"] = np.zeros_like(t_hi)
        # one move of the packed tree (the JAX package's CPU staging +
        # batched device_put becomes this)
        self.batch = toas.to_batch(dev)
        self.prep = host_to_device(prep, dev)
        self.params0 = {k: torch.as_tensor(np.array(v, np.float64),
                                           dtype=DTYPE, device=dev)
                        for k, v in params0.items()}

    @classmethod
    def from_numpy(cls, model, params0, prep, batch_fields, device="cuda"):
        """Rebuild from numpy state: ``params0``/``prep`` dicts and the
        TOABatch fields as the JAX package's PreparedTiming holds them
        (each array through ``np.asarray``). Lets tests feed
        bit-identical packed inputs to both packages."""
        dev = resolve_device(device)
        self = cls.__new__(cls)
        self.model = model
        self.toas = None
        self.subtract_mean = True
        self.device = dev
        self.prep = host_to_device(
            {k: v for k, v in prep.items() if k != "T_ld"}, dev)
        self.params0 = {k: torch.as_tensor(np.array(v, np.float64),
                                           dtype=DTYPE, device=dev)
                        for k, v in params0.items()}
        self.batch = TOABatch(**{
            f: torch.as_tensor(np.array(batch_fields[f], np.float64),
                               dtype=DTYPE, device=dev)
            for f in TOABatch._fields})
        return self

    # -- parameter vector mapping (free params <-> flat vector) --

    def free_param_map(self):
        """[(par_name, params key, index)] for free params."""
        out = []
        for pname in self.model.free_params:
            comp = self.model.map_component(pname)
            key, idx = comp.device_slot(pname)
            out.append((pname, key, idx))
        return out

    def params_with_vector(self, x):
        """The params dict with the flat free-param vector x overlaid
        (see _overlay_params)."""
        return _overlay_params(x, self.params0, tuple(self.free_param_map()))

    def vector_from_params(self, params=None):
        p = self.params0 if params is None else params
        vals = [p[key] if idx is None else p[key][idx]
                for (_, key, idx) in self.free_param_map()]
        return torch.stack(vals).to(DTYPE)

    # -- device functions --

    def delay(self, params=None):
        return _delay_impl(self.model, self.params0 if params is None
                           else params, self.batch, self.prep)

    def _phase_continuous(self, params):
        """Differentiable phase minus the (constant) host reference
        integers: the phase of ``params`` before it is split into
        integer and fraction (the JAX package's ``_phase_continuous``;
        the template likelihood of ``mcmc_fitter.py`` folds it)."""
        return _phase_impl(self.model, params, self.batch, self.prep)

    def phase_frac_and_int(self, params=None):
        frac = _phase_impl(self.model, self.params0 if params is None
                           else params, self.batch, self.prep)
        n = torch.floor(frac + 0.5)
        return frac - n, self.prep["phi_ref_int"] + n

    def phase(self, params=None):
        """Full Phase (int, frac) (reference: TimingModel.phase)."""
        from ..phase import Phase

        frac, pint_ = self.phase_frac_and_int(params)
        return Phase(pint_, frac)

    def scaled_sigma_us(self, params=None):
        return _sigma_impl(self.model, self.params0 if params is None
                           else params, self.batch, self.prep)

    def residual_vector_fn(self, subtract_mean=True, use_weighted_mean=True,
                           track_mode="nearest"):
        """x -> time residuals [s] as a function of the free-param
        vector (the exact-delta phase formulation makes this valid for
        any x without re-preparing)."""
        from ..utils import weighted_mean

        model, prep, batch = self.model, self.prep, self.batch
        params0 = self.params0
        free_map = tuple(self.free_param_map())

        def f(x):
            p = _overlay_params(x, params0, free_map)
            frac = _phase_impl(model, p, batch, prep)
            if track_mode == "use_pulse_numbers":
                pn = batch.pulse_number
                tracked = (prep["phi_ref_int"] - pn) + frac
                wrapped = frac - torch.floor(frac + 0.5)
                resid = torch.where(torch.isnan(pn), wrapped, tracked)
            else:
                resid = frac - torch.floor(frac + 0.5)
            if subtract_mean:
                if use_weighted_mean:
                    sigma = _sigma_impl(model, p, batch, prep)
                    resid = resid - weighted_mean(resid, sigma)
                else:
                    resid = resid - torch.mean(resid)
            return resid / p["F"][0]

        return f

    def designmatrix_fn(self, incoffset=True):
        """x -> (n_toa, n_free[+1]) phase-derivative matrix, by
        forward-mode autodiff (``torch.func.jacfwd`` in place of the JAX
        package's ``jax.jacfwd``)."""
        labels = [n for n, _, _ in self.free_param_map()]
        # PHOFF free is the offset column: drop the implicit one
        # (reference: phase_offset.py PhaseOffset vs 'Offset')
        if incoffset and "PHOFF" in labels:
            incoffset = False
        model, prep, batch = self.model, self.prep, self.batch
        params0 = self.params0
        free_map = tuple(self.free_param_map())

        def phase_of(xx):
            return _phase_impl(model, _overlay_params(xx, params0, free_map),
                               batch, prep)

        def dm(x):
            M = autodiff.jacfwd(phase_of)(x)
            if incoffset:
                M = torch.cat([torch.ones((M.shape[0], 1), dtype=M.dtype,
                                          device=M.device), M], dim=1)
            return M

        labels_out = (["Offset"] + labels) if incoffset else labels
        return dm, labels_out

    def designmatrix(self, params=None, incoffset=True):
        """M[i,j] = d(phase_i)/d(param_j) in cycles/par-unit."""
        p = self.params0 if params is None else params
        fn, labels = self.designmatrix_fn(incoffset=incoffset)
        return fn(self.vector_from_params(p)), labels
