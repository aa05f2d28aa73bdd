"""Parameter system: par-file metadata on host, flat pytree on device.

TPU-native re-design of the reference's parameter layer
(reference: src/pint/models/parameter.py — Parameter, floatParameter,
MJDParameter, AngleParameter, prefixParameter, maskParameter, and
toa_select.py::TOASelect).

Key architectural difference from the reference: Parameter objects are
*host-only metadata* (name, units, free/frozen, aliases, par-file
formatting). The device never sees them — ``TimingModel.prepare``
flattens free/frozen values into a ``{name: f64}`` pytree and resolves
every maskParameter into a static boolean mask over the TOABatch, so
one jitted kernel serves any parameter values without retracing.
"""

from __future__ import annotations

import numpy as np

from ..mjd import LD, parse_mjd_string, format_mjd
from ..constants import SECS_PER_DAY

_D2R = np.pi / 180.0


def _parse_fit_and_unc(fields):
    """Par-file line tail: [fit-flag] [uncertainty]."""
    frozen = True
    unc = None
    if len(fields) >= 1:
        if fields[0] in ("1", "2"):
            frozen = False
            if len(fields) >= 2:
                unc = fields[1]
        elif fields[0] == "0":
            if len(fields) >= 2:
                unc = fields[1]
        else:
            unc = fields[0]
    return frozen, unc


def _float(s):
    return float(str(s).replace("D", "e").replace("d", "e"))


class Parameter:
    """Base parameter (reference: parameter.py::Parameter).

    value       — float in natural par-file units (device-facing)
    uncertainty — same units, or None
    frozen      — True = not fit
    """

    kind = "float"

    def __init__(self, name, value=None, units="", description="", aliases=(),
                 frozen=True, uncertainty=None, continuous=True):
        self.name = name
        self.value = value
        self.units = units
        self.description = description
        self.aliases = tuple(aliases)
        self.frozen = frozen
        self.uncertainty = uncertainty
        self.continuous = continuous
        self._component = None

    @property
    def quantity(self):
        return self.value

    def from_parfile_fields(self, fields):
        self.value = _float(fields[0])
        self.frozen, unc = _parse_fit_and_unc(fields[1:])
        if unc is not None:
            self.uncertainty = _float(unc)

    def as_parfile_line(self):
        if self.value is None:
            return ""
        fit = "0" if self.frozen else "1"
        line = f"{self.name:<15} {self._format_value()}"
        line += f" {fit}"
        if self.uncertainty is not None:
            line += f" {self._format_unc()}"
        return line + "\n"

    def _format_value(self):
        return repr(float(self.value))

    def _format_unc(self):
        return f"{float(self.uncertainty):.5g}"

    def set_fitted_value(self, v):
        """Write a fitted device-vector entry back (same units as
        ``.value``; overridden where the device layout differs)."""
        self.value = v

    def __repr__(self):
        state = "frozen" if self.frozen else "free"
        return f"<{type(self).__name__} {self.name}={self.value} ({state})>"


class floatParameter(Parameter):
    pass


class intParameter(Parameter):
    kind = "int"

    def from_parfile_fields(self, fields):
        self.value = int(float(fields[0]))

    def _format_value(self):
        return str(int(self.value))


class boolParameter(Parameter):
    kind = "bool"

    def from_parfile_fields(self, fields):
        s = str(fields[0]).upper()
        self.value = s in ("1", "Y", "YES", "T", "TRUE")

    def _format_value(self):
        return "Y" if self.value else "N"


class strParameter(Parameter):
    kind = "str"

    def from_parfile_fields(self, fields):
        self.value = fields[0]

    def as_parfile_line(self):
        if self.value is None:
            return ""
        return f"{self.name:<15} {self.value}\n"


class MJDParameter(Parameter):
    """Epoch parameter held as exact (day, sec) (reference: MJDParameter).

    ``.value`` is float MJD; assigning it (e.g. from a fitter update)
    re-derives ``.day``/``.sec``, which keep full precision when set
    via ``from_parfile_fields``/``set_mjd``.
    """

    kind = "mjd"

    def __init__(self, *a, **kw):
        self.day = None
        self.sec = None
        super().__init__(*a, **kw)

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = v
        if v is not None:
            day = int(np.floor(v))
            self.day = day
            self.sec = (v - day) * SECS_PER_DAY

    def from_parfile_fields(self, fields):
        self.day, self.sec = parse_mjd_string(fields[0])
        self._value = self.day + self.sec / SECS_PER_DAY
        self.frozen, unc = _parse_fit_and_unc(fields[1:])
        if unc is not None:
            self.uncertainty = _float(unc)

    def set_mjd(self, day, sec):
        self.day, self.sec = int(day), float(sec)
        self._value = self.day + self.sec / SECS_PER_DAY

    def _format_value(self):
        # 16 decimals of a day (~4e-12 s): the (day, sec) pair reads
        # back to the f64 resolution of its seconds (the JAX package
        # writes 11, half a microsecond)
        return format_mjd(self.day, self.sec, 16)


class AngleParameter(Parameter):
    """RA/Dec-style angle (reference: AngleParameter). ``.value`` is radians.

    Par-file representation: 'h:m:s' (units=hourangle) or 'd:m:s'.
    """

    kind = "angle"

    def __init__(self, *a, angle_unit="deg", **kw):
        super().__init__(*a, **kw)
        self.angle_unit = angle_unit

    def from_parfile_fields(self, fields):
        self.value = self._parse_angle(fields[0])
        self.frozen, unc = _parse_fit_and_unc(fields[1:])
        if unc is not None:
            # uncertainty given in seconds (of time or arc)
            scale = 15.0 if self.angle_unit == "hourangle" else 1.0
            self.uncertainty = _float(unc) * scale / 3600.0 * _D2R

    def _parse_angle(self, s):
        s = str(s)
        scale = 15.0 if self.angle_unit == "hourangle" else 1.0
        if ":" in s:
            sign = -1.0 if s.strip().startswith("-") else 1.0
            parts = s.replace("-", "").split(":")
            deg = float(parts[0])
            if len(parts) > 1:
                deg += float(parts[1]) / 60.0
            if len(parts) > 2:
                deg += float(parts[2]) / 3600.0
            return sign * deg * scale * _D2R
        return _float(s) * _D2R  # bare degrees

    def _format_value(self):
        rad = float(self.value)
        scale = 15.0 if self.angle_unit == "hourangle" else 1.0
        total = rad / _D2R / scale
        sign = "-" if total < 0 else ""
        # integer tick arithmetic at the printed resolution so seconds
        # can never print as 60.0 ("1:0:0" used to format as 00:59:60
        # through float truncation)
        ndec = 10
        unit = 10**ndec
        ticks = round(abs(total) * 3600 * unit)
        d, rem = divmod(ticks, 3600 * unit)
        m, s_ticks = divmod(rem, 60 * unit)
        s_int, s_frac = divmod(s_ticks, unit)
        return (f"{sign}{int(d):02d}:{int(m):02d}:"
                f"{int(s_int):02d}.{int(s_frac):0{ndec}d}")

    def _format_unc(self):
        # seconds of time (hour angle) or of arc, the unit
        # from_parfile_fields reads (the JAX package writes radians
        # here, which its reader takes as seconds)
        scale = 15.0 if self.angle_unit == "hourangle" else 1.0
        return f"{float(self.uncertainty) / (scale / 3600.0 * _D2R):.5g}"


class prefixParameter(floatParameter):
    """One member of a numbered family F0..Fn, DMX_0001.. (reference: prefixParameter)."""

    kind = "prefix"

    def __init__(self, name, prefix, index, **kw):
        super().__init__(name, **kw)
        self.prefix = prefix
        self.index = index


class pairParameter(Parameter):
    """Two-component parameter, e.g. WAVEn 'A B' sin/cos amplitudes
    (reference: parameter.py::pairParameter). ``.value`` is (a, b)."""

    kind = "pair"

    def __init__(self, name, prefix="", index=0, **kw):
        super().__init__(name, **kw)
        self.prefix = prefix
        self.index = index

    def from_parfile_fields(self, fields):
        self.value = (_float(fields[0]), _float(fields[1]))
        if len(fields) > 2:
            self.frozen, unc = _parse_fit_and_unc(fields[2:])
            if unc is not None:
                self.uncertainty = _float(unc)

    def _format_value(self):
        a, b = self.value
        return f"{float(a)!r} {float(b)!r}"

    def set_fitted_value(self, v):
        # device exposes only the amplitude (second element)
        self.value = (self.value[0] if self.value else 0.0, v)

    def as_parfile_line(self):
        # the fit flag and uncertainty follow the pair when there are
        # any, so a free IFUNC node reads back free (the JAX package
        # writes the pair alone)
        if self.value is None:
            return ""
        line = f"{self.name:<15} {self._format_value()}"
        if not self.frozen or self.uncertainty is not None:
            line += f" {'0' if self.frozen else '1'}"
            if self.uncertainty is not None:
                line += f" {self._format_unc()}"
        return line + "\n"


class maskParameter(floatParameter):
    """Parameter applying to a TOA subset (reference: maskParameter).

    Selection spec: (key, key_value) where key is 'flag <name>',
    'mjd', 'freq', 'tel', or '' (all TOAs). ``resolve_mask(toas)``
    evaluates it host-side into a static boolean array — the TPU-native
    stand-in for the reference's TOASelect cache
    (reference: src/pint/toa_select.py::TOASelect).
    """

    kind = "mask"

    def __init__(self, name, prefix, index, **kw):
        super().__init__(name, **kw)
        self.prefix = prefix
        self.index = index
        self.key = ""
        self.key_value: list[str] = []

    @staticmethod
    def _is_flag_token(tok) -> bool:
        # "-f"/"-fe" are flag selectors; "-6.0"/"-1e-5" are negative
        # values (e.g. a selector-less global TNGlobalEQ line)
        t = str(tok)
        return (t.startswith("-") and len(t) > 1
                and not (t[1].isdigit() or t[1] == "."))

    def from_parfile_fields(self, fields):
        # e.g. "EFAC -f L-wide 1.1" parsed from fields after name:
        # [-f, L-wide, 1.1, [fit], [unc]] or "JUMP MJD 55000 55100 1e-6 1"
        if fields and self._is_flag_token(fields[0]):
            self.key = str(fields[0])
            self.key_value = [str(fields[1])]
            rest = fields[2:]
        elif fields and str(fields[0]).lower() in ("mjd", "freq"):
            self.key = str(fields[0]).lower()
            self.key_value = [str(fields[1]), str(fields[2])]
            rest = fields[3:]
        elif fields and str(fields[0]).lower() in ("tel", "obs"):
            self.key = "tel"
            self.key_value = [str(fields[1])]
            rest = fields[2:]
        else:
            self.key = ""
            self.key_value = []
            rest = fields
        if rest:
            self.value = _float(rest[0])
            self.frozen, unc = _parse_fit_and_unc(rest[1:])
            if unc is not None:
                self.uncertainty = _float(unc)

    def resolve_mask(self, toas) -> np.ndarray:
        n = len(toas)
        if self.key == "":
            return np.ones(n, dtype=bool)
        if self.key.startswith("-"):
            flag = self.key[1:]
            vals = toas.get_flag_value(flag)
            return np.array([str(v) == self.key_value[0] for v in vals])
        if self.key == "mjd":
            mjds = toas.get_mjds()
            lo, hi = float(self.key_value[0]), float(self.key_value[1])
            return (mjds >= lo) & (mjds <= hi)
        if self.key == "freq":
            lo, hi = float(self.key_value[0]), float(self.key_value[1])
            return (toas.freq_mhz >= lo) & (toas.freq_mhz <= hi)
        if self.key == "tel":
            return toas.obs.astype(str) == self.key_value[0].lower()
        raise ValueError(f"unsupported mask key {self.key!r}")

    def as_parfile_line(self):
        if self.value is None:
            return ""
        sel = f"{self.key} {' '.join(self.key_value)}".strip()
        fit = "0" if self.frozen else "1"
        line = f"{self.prefix:<8} {sel} {self._format_value()} {fit}"
        if self.uncertainty is not None:
            line += f" {self._format_unc()}"
        return line + "\n"


class funcParameter(floatParameter):
    """Read-only derived parameter computed from other parameters
    (reference: parameter.py::funcParameter *(version-dependent)* —
    e.g. total mass from PB/A1/SINI/M2). Not fittable; ``value``
    evaluates the function on each access."""

    kind = "func"

    def __init__(self, name, func, params, units="", description=""):
        super().__init__(name, units=units, description=description,
                         frozen=True)
        self._func = func
        self._src_params = tuple(params)

    @property
    def value(self):
        if self._component is None or self._component._parent is None:
            return None
        model = self._component._parent
        args = []
        for p in self._src_params:
            par = getattr(model, p, None)
            if par is None or par.value is None:
                return None
            args.append(par.value)
        return self._func(*args)

    @value.setter
    def value(self, v):
        if v is not None:
            raise AttributeError(f"{self.name} is a derived parameter")

    def as_parfile_line(self):
        return ""  # derived values never round-trip into par files


def pack_mask_values(component, names, toas):
    """Shared pack-time evaluation for a component's maskParameter
    slots: returns (values, masks) as float64 arrays of shapes (P,)
    and (P, n_toa). Empty name list gives ((0,), (0, n_toa)) so device
    code can contract unconditionally. Used by PhaseJump/DelayJump/
    FDJump and any future mask-family component."""
    if not names:
        return (np.zeros(0), np.zeros((0, len(toas))))
    vals = np.array([getattr(component, nm).value or 0.0 for nm in names],
                    dtype=np.float64)
    masks = np.stack([getattr(component, nm).resolve_mask(toas)
                      for nm in names]).astype(np.float64)
    return vals, masks
