"""The benchmark's plain reference: the same semantics as the port's
fleet GLS refit, written in plain numpy and PyTorch. Nothing here
imports the port (``pint_tpu_torch``), its JAX original, or JAX."""
