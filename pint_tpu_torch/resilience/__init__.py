"""Resilience helpers of the port (see faultinject.py)."""

from .faultinject import (POINTS, FaultPoint, arm, disarm, fire,  # noqa: F401
                          fire_kill, inject)
