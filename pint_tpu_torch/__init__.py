"""pint_tpu_torch — the PyTorch/CUDA port of pint_tpu.

The JAX package ``pint_tpu`` stays the reference; this package mirrors
its module names (``models/timing_model.py``, ``parallel/pta.py``,
``kernels/fusedgls.py``, ...) so each counterpart is easy to find, and
uses PyTorch's idiom inside. It imports neither JAX nor any module of
``pint_tpu``: what it needs from host-only modules there (constants,
MJD epochs, parameters, the shape planner, the analytic ephemeris) is
copied here.

Policies set for the whole package:

- Every tensor is ``torch.float64`` unless a kernel's f32 tier says
  otherwise; the JAX package turns on x64 globally, torch defaults to
  f32, so the port names the dtype at every construction.
- TF32 is OFF for matmuls and convolutions. The mixed-precision GLS
  tier refines an f32 Gram against exact f64 matvecs, and its
  contraction argument assumes f32 rounding (~1e-7, see
  ``fitter.gls_gram``); TF32's ~1e-3 would break it.
- Entry points take ``device=`` and default to ``"cuda"``. With no card
  present they raise unless the caller asked for ``"cpu"``: nothing
  quietly runs on the CPU.
"""

from __future__ import annotations

import torch

# TF32 off everywhere (see module docstring): the mixed tier needs true
# f32 products from cuBLAS as well as from the package's own kernels.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.2.0"  # the JAX package's version this port mirrors

DTYPE = torch.float64


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the
    default everywhere) requires a card; the CPU is used only when the
    caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pint_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev



def get_model_and_toas(parfile, timfile, **kw):
    """(reference: pint.models.get_model_and_toas)"""
    from .models.builder import get_model_and_toas as _gmt

    return _gmt(parfile, timfile, **kw)
