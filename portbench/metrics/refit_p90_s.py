"""The 90th percentile of the wall of every refit in the window (host
clock from the call to ``PTAFleet.fit`` to its return, which ends in the
fit's one pull), linear between order statistics."""

import numpy as np


def read(ctx):
    if not ctx.walls:
        return None
    return float(np.percentile(ctx.walls, 90))
