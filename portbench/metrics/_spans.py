"""Shared arithmetic of the span readers: the program's spans by name,
inside the window's unprofiled refits or inside set-up."""


def per_refit_ms(ctx, name):
    """The summed duration of the spans ``name`` that start inside an
    unprofiled refit of the window, per such refit, in ms."""
    plain = [(t0, t1) for t0, t1, profiled in ctx.refits if not profiled]
    if not plain:
        return None
    total, found = 0.0, False
    for sp in ctx.spans:
        if sp["name"] != name or sp["t1"] is None:
            continue
        if any(t0 <= sp["t0"] <= t1 for t0, t1 in plain):
            total += sp["t1"] - sp["t0"]
            found = True
    return 1e3 * total / len(plain) if found else None


def setup_union_s(ctx, names):
    """Seconds covered by the spans ``names`` that ran in set-up (their
    union: pool threads overlap)."""
    iv = [(sp["t0"], sp["t1"]) for sp in ctx.spans
          if sp["name"] in names and sp["t1"] is not None
          and sp["t1"] <= ctx.setup_end]
    return ctx.union_s(iv) if iv else None
