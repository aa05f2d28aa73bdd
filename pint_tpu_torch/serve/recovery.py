"""The bitwise witness of the serve path (the JAX package's
``serve/recovery.py``, in part): :func:`result_digest`.

The JAX package's ``save_serve_state`` / ``restore_serve_state`` (one
durable snapshot of breaker, health, drift and fit-quality state under
the journal directory) wait with ``checkpoint.py`` in the durability
queue (ROADMAP §1 item 3).
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np


def result_digest(value):
    """Canonical byte digest of a ServeResult value dict — the
    bit-identity witness the serve contracts are asserted with (async
    vs sync, traced vs untraced, ledger on vs off). Arrays contribute
    their exact buffer bytes, floats their IEEE-754 encoding: two
    digests match iff the results are bitwise identical, not merely
    close."""
    if value is None:
        return None
    h = hashlib.sha256()
    for k in sorted(value):
        v = value[k]
        h.update(str(k).encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode())
            h.update(repr(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, float):
            h.update(struct.pack("<d", v))
        else:
            h.update(repr(v).encode())
    return h.hexdigest()
