"""Degradation policy (the JAX package's ``serve/policy.py``; the port
has the one rule the streaming lanes use)."""

from __future__ import annotations


def has_correlated_noise(model):
    """GLS is required when any component contributes noise-basis
    columns (same criterion as PTAFleet.fit's method="auto"). A
    streaming lane for such a model refits in full on every append."""
    return any(getattr(c, "basis_weight", None) is not None
               for c in model.components.values())
