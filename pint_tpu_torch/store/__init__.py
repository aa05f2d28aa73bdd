"""On-disk stores of the port: content signatures of a fleet
(packstore.py) and the append-delta chain of streaming lanes
(deltas.py)."""

from .deltas import DeltaStore, chain_signature
from .packstore import content_signature, store_identity

__all__ = ["DeltaStore", "chain_signature", "content_signature",
           "store_identity"]
