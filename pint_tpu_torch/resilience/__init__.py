"""Fault injection, retry/backoff, circuit breaking, and health for
the port's serving/fitting stack (the JAX package's ``resilience/``).

Import surface:

- :mod:`pint_tpu_torch.resilience.faultinject` — named deterministic
  injection points (``inject`` context manager, ``PINT_TPU_FAULTS``
  env spec).
- :mod:`pint_tpu_torch.resilience.retry` — ``BackoffPolicy`` /
  ``with_retries`` and the per-slot ``CircuitBreaker``.
- :mod:`pint_tpu_torch.resilience.health` — the engine ``HealthMonitor``
  (healthy -> degraded -> draining).

Nothing in this package touches a device; it is safe to import from
any layer.
"""

from .faultinject import (  # noqa: F401
    DEVICE_POINTS,
    POINTS,
    FaultInjected,
    FaultPoint,
    arm,
    arm_from_env,
    armed,
    disarm,
    fire,
    fire_kill,
    inject,
    parse_spec,
)
from .health import STATES, HealthMonitor  # noqa: F401
from .retry import (  # noqa: F401
    BackoffPolicy,
    CircuitBreaker,
    is_retryable,
    with_retries,
)

arm_from_env()
