"""Forward-mode autodiff that threads can share.

The dual levels that ``torch.func.jacfwd`` enters are process-global in
torch, not per thread: two threads inside a jacfwd at once corrupt each
other's level ("Trying to access a forward AD level with an invalid
index", "no level exists"). The serving engine captures programs on one
thread (a flush, the persisted tier's background re-capture) while
another registers append lanes or fits eagerly, and each traces a
design matrix with jacfwd. Every jacfwd of the package goes through
:func:`jacfwd`, which holds one process lock (:data:`LOCK`) for the
whole call. The lock is taken inside ``vmap`` and inside a capture
alike (it is host code); nothing a jacfwd computes takes another lock,
so it is always the innermost one.
"""

from __future__ import annotations

import threading

import torch

LOCK = threading.RLock()


def jacfwd(fn, *args, **kwargs):
    """``torch.func.jacfwd(fn, *args, **kwargs)`` whose calls hold
    :data:`LOCK`."""
    jac = torch.func.jacfwd(fn, *args, **kwargs)

    def locked(*a, **k):
        with LOCK:
            return jac(*a, **k)

    return locked
