"""Timing models (torch): the components the port has so far."""

from .builder import get_model, get_model_and_toas, parse_parfile
from .timing_model import PreparedTiming, TimingModel

__all__ = ["get_model", "get_model_and_toas", "parse_parfile",
           "PreparedTiming", "TimingModel"]
