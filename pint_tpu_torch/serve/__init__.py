"""Serving paths of the port: streaming append refits
(streaming.py)."""

from .streaming import StreamingRefitter, lane_key

__all__ = ["StreamingRefitter", "lane_key"]
