"""Resilience helpers of the port (see faultinject.py)."""
