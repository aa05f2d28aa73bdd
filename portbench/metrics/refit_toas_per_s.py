"""The fleet's TOAs times the refits completed in the window, over the
window's seconds (host clock, from the window's start to the return of
its last refit). A failed refit counts nothing."""


def read(ctx):
    if not ctx.completed:
        return None
    return ctx.n_toas * ctx.completed / ctx.window_s
