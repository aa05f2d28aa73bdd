"""Pair-block cross-correlation products for the GW detection stage
(torch counterpart of the JAX package's ``kernels/paircorr.py``).

The Hellings–Downs optimal statistic (``pint_tpu_torch/gw/``) needs, for
every pulsar pair (a, b), the weighted zero-lag cross products over a
common epoch lattice:

    num_ab = sum_m U_a[m] U_b[m]      with U = W * z (weighted resid)
    den_ab = sum_m W_a[m] W_b[m]      (pair weight / inverse variance)

Over a (B_a, M) x (B_b, M) block of pulsars both are matrix products,
``U_a @ U_b^T`` and ``W_a @ W_b^T``.

Three paths, as for the GLS kernels:

- :func:`pair_products_ref` — both products in the input's dtype (f64 in
  the sweep), used by ``precision="f64"``;
- :func:`pair_products_plain` — the same products in f32; the CPU form
  of the kernel and the yardstick the card's kernel is held to;
- :func:`pair_products_cuda` — the hand-written Hopper kernel
  (``csrc/paircorr.cu::pair_products_f32``), replacing the TPU kernel
  ``pint_tpu/kernels/paircorr.py::pair_products_pallas``. Whether its
  rows copy 16 bytes at a time is decided here (:func:`copies_16_bytes`),
  and :func:`pair_grid` gives its grid, where the CPU tests reach them.

:func:`pair_products` dispatches: under ``precision="mixed"`` the plain
version for CPU tensors and the kernel for CUDA tensors, which launches
or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from ..fitter import check_precision

# csrc/paircorr.cu: a 64 x 64 output tile of 128 threads, each owning 8
# rows x 4 columns; a ring of 2 chunks of 32 lattice cells, rows padded
# to 36 floats, for both operands
TILE, THREADS, PER_THREAD = 64, 128, (8, 4)
CHUNK, STAGES = 32, 2
ROW_STRIDE = CHUNK + 4
SMEM_BYTES = STAGES * 2 * TILE * ROW_STRIDE * 4

_FN = None


def pair_grid(ba, bb):
    """The launch grid csrc/paircorr.cu takes for a (B_a, B_b) pair
    block: (x over B_b, y over B_a, z = the 2 products)."""
    return (-(-bb // TILE), -(-ba // TILE), 2)


def copies_16_bytes(m, *data_ptrs):
    """Whether rows copy 16 bytes at a time: M a multiple of 4 and every
    operand 16-byte aligned. Else each thread copies 4 bytes at a time."""
    bits = 0
    for p in data_ptrs:
        bits |= p
    return m % 4 == 0 and bits % 16 == 0


def pair_products_ref(ua, wa, ub, wb):
    """(B_a, M) x (B_b, M) -> (U_a U_b^T, W_a W_b^T) in the input dtype."""
    return ua @ ub.mT, wa @ wb.mT


def pair_products_plain(ua, wa, ub, wb):
    """The two products in f32 (the kernel's arithmetic, in torch)."""
    f32 = torch.float32
    return pair_products_ref(ua.to(f32), wa.to(f32), ub.to(f32), wb.to(f32))


def _kernel_fn():
    """The C entry ``pair_products_f32`` of csrc/paircorr.cu, argtypes
    set (pointers and the stream as c_void_p, sizes and the device index
    as c_int)."""
    global _FN
    if _FN is None:
        from .build import load

        fn = load("paircorr").pair_products_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(name, t, device, m=None):
    if t.device.type != "cuda":
        raise ValueError(f"pair_products_cuda: {name} must be a CUDA "
                         f"tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"pair_products_cuda: {name} is on {t.device}, "
                         f"not {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"pair_products_cuda: {name} must be float32, "
                        f"got {t.dtype}")
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"pair_products_cuda: {name} must be a "
                         "contiguous 2-D tensor")
    if m is not None and t.shape[1] != m:
        raise ValueError(f"pair_products_cuda: {name} has {t.shape[1]} "
                         f"lattice cells, expected {m}")


def pair_products_cuda(ua, wa, ub, wb):
    """The Hopper kernel: both f32 products of contiguous CUDA rows in
    one launch on the current stream. Counts its launches in
    ``pair_products_cuda.launches``."""
    _check("ua", ua, ua.device)
    ba, m = ua.shape
    bb = ub.shape[0]
    for name, t in (("wa", wa), ("ub", ub), ("wb", wb)):
        _check(name, t, ua.device, m)
    if wa.shape[0] != ba or wb.shape[0] != bb:
        raise ValueError("pair_products_cuda: ua/wa and ub/wb must have "
                         "matching row counts")
    if max(ba, bb, m) > 2**31 - 1:
        raise ValueError("pair_products_cuda: dimensions exceed int32")
    num = torch.empty((ba, bb), dtype=torch.float32, device=ua.device)
    den = torch.empty_like(num)
    if ba == 0 or bb == 0:
        return num, den
    ptrs = (ua.data_ptr(), wa.data_ptr(), ub.data_ptr(), wb.data_ptr())
    stream = torch.cuda.current_stream(ua.device).cuda_stream
    rc = _kernel_fn()(*ptrs, num.data_ptr(), den.data_ptr(), ba, bb, m,
                      int(copies_16_bytes(m, *ptrs)), ua.device.index,
                      stream)
    if rc != 0:
        raise RuntimeError(f"pair_products_f32 launch failed with CUDA "
                           f"error {rc}")
    pair_products_cuda.launches += 1
    return num, den


pair_products_cuda.launches = 0


def pair_products(ua, wa, ub, wb, precision="f64"):
    """One pair-block's (num, den): ``"f64"`` takes the reference;
    ``"mixed"`` the f32 products, the plain version for CPU tensors and
    the kernel for CUDA tensors."""
    check_precision(precision)
    if precision == "f64":
        return pair_products_ref(ua, wa, ub, wb)
    if ua.device.type == "cpu":
        return pair_products_plain(ua, wa, ub, wb)
    f32 = torch.float32
    return pair_products_cuda(*(t.to(f32).contiguous()
                                for t in (ua, wa, ub, wb)))
