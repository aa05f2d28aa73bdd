"""Columnar packed-TOA store: mmap'd post-barycentering arrays (the
JAX package's ``store/``).

See :mod:`pint_tpu_torch.store.packstore` for the format, keying, and
failure-handling contract, and :mod:`pint_tpu_torch.store.deltas` for
the append-delta chains of streaming lanes. Public surface::

    from pint_tpu_torch.store import PackStore, content_signature

    store = PackStore("cache/packstore")
    fleet = PTAFleet(models, toas_list, toa_bucket="plan", store=store)
"""

from .deltas import (  # noqa: F401
    DeltaStore,
    chain_signature,
    DELTA_MAGIC,
    DELTA_FORMAT_VERSION,
)
from .packstore import (  # noqa: F401
    PackStore,
    content_signature,
    store_identity,
    STORE_MAGIC,
    STORE_FORMAT_VERSION,
)

__all__ = [
    "PackStore", "content_signature", "store_identity",
    "STORE_MAGIC", "STORE_FORMAT_VERSION",
    "DeltaStore", "chain_signature", "DELTA_MAGIC",
    "DELTA_FORMAT_VERSION",
]
