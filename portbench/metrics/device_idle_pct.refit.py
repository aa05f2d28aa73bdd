"""The share of the profiled refits' host wall in which no kernel ran on
the card (1 - the union of kernel intervals over the wall)."""


def read(ctx):
    prof = ctx.profile
    if not prof or not prof["reduced"] or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["reduced"]["busy_s"] / prof["wall_s"])
