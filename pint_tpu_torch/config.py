"""Packaged-data accessors (the JAX package's ``config.py``).

(reference: src/pint/config.py — examplefile()/runtimefile() resolve
names inside the installed package's data directories.) The names
resolve inside the port's own ``pint_tpu_torch/data``.
"""

from __future__ import annotations

import os

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def datadir() -> str:
    return _DATA


def examplefile(name: str) -> str:
    """Full path of a packaged example file (reference:
    pint.config.examplefile)."""
    path = os.path.join(_DATA, "examples", name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no packaged example {name!r}")
    return path


def runtimefile(name: str) -> str:
    """Full path of a packaged runtime data file (observatories, leap
    seconds, clock chains; reference: pint.config.runtimefile)."""
    for sub in ("", "clock"):
        path = os.path.join(_DATA, sub, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no packaged runtime file {name!r}")
