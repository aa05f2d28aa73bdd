"""The pow2 bucket convention of the JAX package's ``serve/batcher.py``.

Only ``pow2_bucket`` is ported, as a plain function: ``PTAFleet``'s
``toa_bucket="pow2"`` keys its buckets on it (through
``parallel/shapeplan.py::pow2_width``). The micro-batcher itself is not
ported (ROADMAP §1 item 3).
"""

from __future__ import annotations


def pow2_bucket(n, floor=256):
    """Smallest power-of-two >= n, starting at ``floor`` (PTAFleet's
    pow2 convention; the floor is configurable so CPU tests and
    benches can keep padding cheap)."""
    b = int(floor)
    while b < n:
        b *= 2
    return b
