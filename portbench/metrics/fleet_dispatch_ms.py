"""The fleet executor's dispatch (``PTAFleet._fit_pipelined``: the
graph replays and the eager eighs between them): the summed
``fleet.dispatch`` spans per unprofiled refit of the traced window."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.per_refit_ms(ctx, "fleet.dispatch")
