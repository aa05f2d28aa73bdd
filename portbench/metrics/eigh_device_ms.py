"""The solve core's eigendecompositions: the device time of the kernels
launched inside the host ops named in names/eigh_device_ms/ (today
``aten::linalg_eigh``), per profiled refit."""

from portbench import profiling


def read(ctx):
    prof = ctx.profile
    if not prof or not prof["reduced"] or not prof["n"]:
        return None
    t = profiling.op_device_s(prof["reduced"]["events"],
                              set(ctx.names("eigh_device_ms")))
    return 1e3 * t / prof["n"] if t > 0 else None
