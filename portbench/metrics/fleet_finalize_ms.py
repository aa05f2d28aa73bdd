"""The finalize (``PTABatch._finalize_gls``: waiting for the
device, the one pull, the mixed->f64 guard, the probes): the summed
``fleet.execute`` spans per unprofiled refit of the traced window."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.per_refit_ms(ctx, "fleet.execute")
