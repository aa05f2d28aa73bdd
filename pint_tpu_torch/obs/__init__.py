"""Observability helpers of the port (see drift.py)."""
