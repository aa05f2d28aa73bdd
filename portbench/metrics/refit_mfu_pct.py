"""The whole refit's share of the chip's peak: the benchmark's FLOP
count of one refit (costs.refit_flops over each pulsar's real TOAs and
own columns) times the refits profiled, over their host wall and the
peak rate of peaks.json."""


def read(ctx):
    prof = ctx.profile
    if not prof or not prof["n"] or prof["wall_s"] <= 0:
        return None
    rate = ctx.refit_flops * prof["n"] / prof["wall_s"]
    return 100.0 * rate / ctx.peaks["mfu_flops_per_s"]
