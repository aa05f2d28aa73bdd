"""A plain reader of the par files the benchmark's fleets hand the port.

It knows the lines those fleets write (tempo2 style): ``NAME value
[fit]``, and the mask lines ``EFAC|EQUAD|ECORR|JUMP -flag value value
[fit]``. Angles are sexagesimal (RAJ in hours, DECJ in degrees).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

MASKED = ("EFAC", "EQUAD", "ECORR", "JUMP")


@dataclass
class Mask:
    kind: str  # EFAC, EQUAD, ECORR or JUMP
    flag: str  # without its dash
    flag_value: str
    value: float
    free: bool


@dataclass
class Par:
    values: dict = field(default_factory=dict)  # name -> float (or str)
    free: list = field(default_factory=list)  # free names, in file order
    masks: list = field(default_factory=list)

    def get(self, name, default=0.0):
        return self.values.get(name, default)

    def mask_params(self, kind):
        """The masks of one kind, numbered 1.. in file order (the
        names ``JUMP1``, ``EFAC1`` ...)."""
        return [m for m in self.masks if m.kind == kind]


def sexagesimal(text, hours):
    sign = -1.0 if text.strip().startswith("-") else 1.0
    parts = [abs(float(p)) for p in text.strip().lstrip("+-").split(":")]
    while len(parts) < 3:
        parts.append(0.0)
    deg = parts[0] + parts[1] / 60.0 + parts[2] / 3600.0
    return sign * math.radians(deg * (15.0 if hours else 1.0))


def parse(text):
    par = Par()
    for line in text.splitlines():
        words = line.split()
        if not words or words[0].startswith("#"):
            continue
        name = words[0].upper()
        if name in MASKED and len(words) >= 4 and words[1].startswith("-"):
            free = len(words) > 4 and words[4] == "1"
            par.masks.append(Mask(name, words[1][1:], words[2],
                                  float(words[3]), free))
            if free:
                index = len(par.mask_params(name))
                par.free.append(f"{name}{index}")
            continue
        if name == "RAJ":
            value = sexagesimal(words[1], hours=True)
        elif name == "DECJ":
            value = sexagesimal(words[1], hours=False)
        else:
            try:
                value = float(words[1].replace("D", "E"))
            except ValueError:
                value = words[1]
        par.values[name] = value
        if len(words) > 2 and words[2] == "1":
            par.free.append(name)
    return par
