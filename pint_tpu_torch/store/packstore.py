"""Content signatures of a fleet's packed inputs (the JAX package's
``store/packstore.py``: ``store_identity`` and ``content_signature``).

The signature is the key a persisted artifact is stored under: a hash
of everything the packed arrays are a function of — every model's
par-file serialization, every TOA table's columns and the build
options — so an edited par file or a new TOA lands on a different
signature. The streaming lanes (``serve/streaming.py``) root their
append-delta chains (``store/deltas.py``) at it. The pack store itself
is not ported yet.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["content_signature", "store_identity", "STORE_FORMAT_VERSION"]

STORE_FORMAT_VERSION = 1


def store_identity():
    """Environment identity stamped into (and checked against) every
    persisted entry: format version, torch version (where the JAX
    package stamps its jax version) and the packed-geometry version."""
    import torch

    from ..parallel.shapeplan import PACK_GEOMETRY_VERSION

    return {"format": STORE_FORMAT_VERSION,
            "torch_version": torch.__version__,
            "pack_geometry": PACK_GEOMETRY_VERSION}


def _digest_toas(h, toas):
    """Fold one TOAs table's content into ``h``: the columns the port's
    barycentred table holds as given (epochs, frequencies, errors,
    observatories, the planets switch) and its flags. The derived
    columns (tdb, posvels) are functions of these and are not hashed."""
    h.update(np.ascontiguousarray(toas.day).tobytes())
    h.update(np.ascontiguousarray(toas.sec).tobytes())
    h.update(np.ascontiguousarray(toas.freq_mhz).tobytes())
    h.update(np.ascontiguousarray(toas.error_us).tobytes())
    h.update("|".join(str(o) for o in toas.obs).encode())
    h.update(repr(bool(toas.planets)).encode())
    # flags feed maskParameter selection; only the non-empty dicts
    for i, f in enumerate(toas.flags):
        if f:
            h.update(repr((i, sorted(f.items()))).encode())


def content_signature(models, toas_list, **build_opts):
    """Hex signature over everything the packed arrays are a function
    of: every model's par-file serialization, every TOA table's columns
    and the build options. Two fleets with equal signatures would build
    bit-identical pack states; anything else must miss. (The JAX
    package also folds in shape-plan signatures, for the pack store,
    which is not ported.)

    The environment identity (:func:`store_identity`) is deliberately
    NOT part of this hash: it is stamped into each entry and checked at
    load, so a version bump finds the old entry at the same path and
    invalidates it visibly instead of leaving an orphan on disk."""
    h = hashlib.sha256()
    for m in models:
        h.update(m.as_parfile().encode())
        h.update(b"\x00")
    for t in toas_list:
        _digest_toas(h, t)
        h.update(b"\x00")
    h.update(repr(sorted(build_opts.items())).encode())
    return "pack-" + h.hexdigest()[:40]
