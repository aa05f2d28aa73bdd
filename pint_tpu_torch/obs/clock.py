"""The one timing primitive every instrumented module shares (the JAX
package's ``obs/clock.py``).

Host-side timing of the observability layer — the fit-quality probes'
own wall, flight-recorder event stamps, SLO windows — goes through
:func:`now` so there is exactly one clock to reason about (monotonic,
sub-microsecond, immune to NTP steps). Import idiom::

    from pint_tpu_torch.obs import clock as obs_clock
    t0 = obs_clock.now()
    ...
    elapsed = obs_clock.now() - t0

Classes that take an injectable ``clock=`` collaborator keep doing so;
this module is the default they should be handed, not a replacement
for injection. A device time is not a host time: work queued on a card
is timed by CUDA events, or by this clock after a synchronize.
"""

from __future__ import annotations

import time

# Monotonic high-resolution process clock. An alias, not a wrapper:
# callers pay no indirection over calling time.perf_counter directly.
now = time.perf_counter

# Wall-clock (UNIX epoch) — ONLY for timestamping exported artifacts
# (flight-recorder dumps, trace files); never for measuring durations.
walltime = time.time


class Stopwatch:
    """Restartable elapsed-time meter over :func:`now`.

    ``lap()`` returns the time since construction (or the previous
    lap) and restarts; ``elapsed()`` peeks without restarting.
    """

    __slots__ = ("t0",)

    def __init__(self):
        self.t0 = now()

    def elapsed(self):
        return now() - self.t0

    def lap(self):
        t = now()
        dt = t - self.t0
        self.t0 = t
        return dt

    def restart(self):
        self.t0 = now()
