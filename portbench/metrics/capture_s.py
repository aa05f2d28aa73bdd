"""The executor's capture in set-up (``PTAFleet.precompile`` ->
``fleet_aot_compile`` -> ``graphs.GraphProgram``): the union of the
``fleet.compile`` spans."""

from portbench.metrics import _spans


def read(ctx):
    return _spans.setup_union_s(ctx, ("fleet.compile",))
