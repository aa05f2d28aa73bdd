"""The process's start (the first statement of run.py) to the first
timed refit: imports, the CUDA context, the cached TOAs, the noise
realisation, the fleet's pack, precompile (capture) and the warm fits."""


def read(ctx):
    return ctx.setup_s
