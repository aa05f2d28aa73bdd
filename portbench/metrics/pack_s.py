"""Host prep and pack in set-up (``PTAFleet``'s per-bucket host prep and
the wait for it): the union of the ``fleet.host_prep`` and
``fleet.pack`` spans."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.setup_union_s(ctx, ("fleet.host_prep", "fleet.pack"))
