"""Streaming harmonic sums over photon phases, the H-test / Z^2_m hot
loop (torch counterpart of the JAX package's ``kernels/harmonics.py``).

For harmonics k = 1..m:

    C_k = sum_i w_i cos(2 pi k phi_i)      S_k = sum_i w_i sin(2 pi k phi_i)

Three paths, as for the other kernels:

- :func:`harmonic_sums_ref` — f64, the expression of the JAX package's
  ``harmonic_sums_jnp`` (``cos(k * 2 pi phi)`` per harmonic), one
  harmonic at a time so no (m, n) tensor is held;
- :func:`harmonic_sums_plain` — the kernel's arithmetic in f32 torch
  ops: theta = phi * f32(2 pi), one cos and sin, then the Chebyshev
  recurrence cos(k t) = 2 cos(t) cos((k-1) t) - cos((k-2) t) over k,
  each harmonic reduced with ``torch.sum``; the CPU form of the kernel
  and the yardstick the card's kernel is held to. Its cos and sin of
  the f32 theta are taken in f64 and rounded to f32, the correctly
  rounded values, as the kernel takes them: the recurrence multiplies
  an error in cos(theta) near theta = 0 or pi by ~k^2 at harmonic k,
  and torch's f32 cos on the CPU is biased near pi, enough to leave the
  K4 tolerance against the Pallas kernel at n = 70,000 and m = 20 (a
  case of tests/test_torch_kernels.py). Each recurrence step is the
  kernel's contracted ``fmaf(2 c1, c_k, -c_{k-1})``, formed here as the
  exact f64 product (two f32 factors) minus c_{k-1}, rounded once to
  f32. The kernel's per-photon terms are this version's bit for bit,
  except at a double-rounding tie (an f64 value within an ulp of an f32
  rounding boundary, ~1 in 2^28 values), where they differ by one f32
  ulp;
- :func:`harmonic_sums_cuda` — the hand-written Hopper kernel
  (``csrc/harmonics.cu::harmonic_sums_f32``), replacing the TPU kernel
  ``pint_tpu/kernels/harmonics.py::harmonic_sums_pallas``.

Phases are (n,) or (G, n) (G rows, one launch for all of them, as the
JAX package's ``vmap`` of the kernel in ``eventstats.hm_scan`` does);
weights are None, (n,) shared by every row, or (G, n). Every path
returns (C, S) in f64 of shape (m,) or (G, m).

:func:`harmonic_sums` dispatches by the JAX package's size rule (its
``harmonics.py:143-159``): a CUDA tensor with n >= 65536 photons per
row takes the kernel, which launches or raises; any other input takes
the f64 reference, which is also what the JAX function computes on the
CPU. There is no fallback on failure.

The kernel's launch plan is computed here, so that the CPU tests reach
every choice (:func:`harmonic_plan`): the instantiation (harmonics per
chunk), the blocks per row (one wave of the blocks the occupancy API
says stay resident, :func:`resident_blocks`), whether photons load 16
bytes at a time, and the partial-sums scratch (:func:`partial_floats`);
:func:`launch_plan` caches the packed plan per shape and alignment.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

# photons per row from which a CUDA input takes the kernel (JAX
# harmonics.py: ``n >= (1 << 16)``)
KERNEL_MIN_PHOTONS = 1 << 16
_TWO_PI_F32 = np.float32(2.0 * np.pi)
# the launch geometry of csrc/harmonics.cu: threads per block, photons a
# thread takes per loop iteration, and the accumulator counts (harmonics
# per chunk) it instantiates
THREADS = 256
PHOTONS = 4
CHUNKS = (2, 4, 8, 16, 20, 32)
# {g, n, m, chunk, chunks, blocks, vec, w_stride}, as harmonics.cu reads it
PlanArray = ctypes.c_longlong * 8
_FNS = None
_RESIDENT = {}
_PLANS = {}


def _weights_like(phases, weights, dtype):
    if weights is None:
        return None
    w = torch.as_tensor(weights, device=phases.device).to(dtype)
    if w.shape[-1] != phases.shape[-1] or w.ndim > phases.ndim:
        raise ValueError(f"weights of shape {tuple(w.shape)} do not match "
                         f"phases of shape {tuple(phases.shape)}")
    return w


def harmonic_sums_ref(phases, m, weights=None):
    """(C[1..m], S[1..m]) in f64 (JAX ``harmonic_sums_jnp``)."""
    ph = phases.to(torch.float64) * (2.0 * math.pi)
    w = _weights_like(phases, weights, torch.float64)
    cs, ss = [], []
    for k in range(1, m + 1):
        ck = torch.cos(k * ph)
        sk = torch.sin(k * ph)
        if w is not None:
            ck = ck * w
            sk = sk * w
        cs.append(torch.sum(ck, dim=-1))
        ss.append(torch.sum(sk, dim=-1))
    return torch.stack(cs, dim=-1), torch.stack(ss, dim=-1)


def harmonic_sums_plain(phases, m, weights=None):
    """The kernel's arithmetic in f32 torch ops: one cos/sin per photon,
    the contracted Chebyshev recurrence over k, an f32 ``torch.sum`` per
    harmonic, returned in f64."""
    theta = (phases.to(torch.float32) * _TWO_PI_F32).to(torch.float64)
    w = _weights_like(phases, weights, torch.float32)
    # correctly rounded f32 cos/sin of the f32 theta (module docstring)
    c1 = torch.cos(theta).to(torch.float32)
    s1 = torch.sin(theta).to(torch.float32)
    del theta
    two_c1 = (2.0 * c1).to(torch.float64)  # exact
    ckm2, skm2 = torch.ones_like(c1), torch.zeros_like(s1)
    ck, sk = c1, s1
    cs, ss = [], []
    for k in range(m):
        if w is None:
            cs.append(torch.sum(ck, dim=-1))
            ss.append(torch.sum(sk, dim=-1))
        else:
            cs.append(torch.sum(w * ck, dim=-1))
            ss.append(torch.sum(w * sk, dim=-1))
        if k + 1 < m:  # fmaf(2 c1, c_k, -c_{k-1}): one rounding to f32
            ck, ckm2 = (two_c1 * ck - ckm2).to(torch.float32), ck
            sk, skm2 = (two_c1 * sk - skm2).to(torch.float32), sk
    return (torch.stack(cs, dim=-1).to(torch.float64),
            torch.stack(ss, dim=-1).to(torch.float64))


def harmonic_chunk(m):
    """Harmonics per chunk for m harmonics: the smallest instantiation of
    csrc/harmonics.cu that holds m, else 32 (several chunks)."""
    return next((kc for kc in CHUNKS if kc >= m), CHUNKS[-1])


def harmonic_blocks(g, n, nchunks, resident):
    """Blocks per (row, chunk): the grid's g * nchunks rows share the
    ``resident`` blocks the card keeps (one wave), never fewer than 1
    and never more than the row's quads of photons need (a thread per
    quad)."""
    need = -(-(-(-n // PHOTONS)) // THREADS)
    return max(1, min(need, resident // (g * nchunks)))


def copies_16_bytes(g, n, ph_ptr, w_ptr=None, w_stride=0):
    """Whether each thread loads its 4 photons (and weights) as one
    16-byte piece: every row must start on a 16-byte boundary (aligned
    base, and n % 4 == 0 unless there is one row), for the weights as
    well unless one row of them is shared."""
    rows = g == 1 or n % PHOTONS == 0
    ok = ph_ptr % 16 == 0 and rows
    if w_ptr is not None:
        ok = ok and w_ptr % 16 == 0 and (w_stride == 0 or rows)
    return ok


def harmonic_plan(g, n, m, ph_ptr, w_ptr, w_stride, resident):
    """Everything the C entry needs besides the tensors, in its order:
    (g, n, m, chunk, chunks, blocks, vec, w_stride), with ``resident``
    blocks of the instantiation resident on the card."""
    kc = harmonic_chunk(m)
    nchunks = -(-m // kc)
    return (g, n, m, kc, nchunks, harmonic_blocks(g, n, nchunks, resident),
            int(copies_16_bytes(g, n, ph_ptr, w_ptr, w_stride)), w_stride)


def partial_floats(plan):
    """Floats of the partial-sums scratch a plan needs: (g, chunks,
    blocks, 2 chunk)."""
    g, _, _, kc, nchunks, nb = plan[:6]
    return g * nchunks * nb * 2 * kc


def _kernel_fns():
    """The C entries of csrc/harmonics.cu, argtypes set (pointers and
    the stream as c_void_p, the plan as one int64 array, the device
    index and counts as c_int)."""
    global _FNS
    if _FNS is None:
        from .build import load

        lib = load("harmonics")
        fn = lib.harmonic_sums_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [PlanArray, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.harmonic_resident_blocks
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        _FNS = (fn, occ)
    return _FNS


def resident_blocks(device_index, kc, weighted):
    """Blocks of the partials kernel with ``kc`` harmonics per chunk that
    stay resident on the card (SM count x blocks per SM, from the CUDA
    occupancy API), cached per instantiation."""
    key = (device_index, kc, weighted)
    n = _RESIDENT.get(key)
    if n is None:
        out = ctypes.c_int(0)
        rc = _kernel_fns()[1](kc, int(weighted), device_index,
                              ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"harmonic_resident_blocks failed with CUDA "
                               f"error {rc} ({out.value} blocks)")
        n = _RESIDENT[key] = out.value
    return n


def launch_plan(dev, g, n, m, ph_ptr, w_ptr, w_stride):
    """The packed plan of a launch, cached per shape and alignment."""
    key = (dev, g, n, m, w_ptr is not None, w_stride, ph_ptr % 16,
           None if w_ptr is None else w_ptr % 16)
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= 1024:
            _PLANS.clear()
        resident = resident_blocks(dev, harmonic_chunk(m), w_ptr is not None)
        plan = _PLANS[key] = PlanArray(*harmonic_plan(
            g, n, m, ph_ptr, w_ptr, w_stride, resident))
    return plan


def _check(name, t, device):
    if t.device.type != "cuda":
        raise ValueError(f"harmonic_sums_cuda: {name} must be a CUDA "
                         f"tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"harmonic_sums_cuda: {name} is on {t.device}, "
                         f"not {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"harmonic_sums_cuda: {name} must be float32, "
                        f"got {t.dtype}")
    if t.ndim not in (1, 2) or not t.is_contiguous():
        raise ValueError(f"harmonic_sums_cuda: {name} must be a "
                         "contiguous 1-D or 2-D tensor")


def harmonic_sums_cuda(phases, m, weights=None):
    """The Hopper kernel on f32 contiguous CUDA phases (n,) or (G, n)
    and weights None, (n,) or (G, n), on the current stream. Returns
    f64 (C, S). Counts its launches in ``harmonic_sums_cuda.launches``."""
    _check("phases", phases, phases.device)
    m = int(m)
    if m < 1:
        raise ValueError(f"harmonic_sums_cuda: m must be >= 1, got {m}")
    rows = phases.reshape(1, -1) if phases.ndim == 1 else phases
    g, n = rows.shape
    if n == 0:
        raise ValueError("harmonic_sums_cuda: no photons")
    if g > 65535:
        raise ValueError(f"harmonic_sums_cuda: {g} rows exceed 65535")
    w_ptr, w_stride = None, 0
    if weights is not None:
        _check("weights", weights, phases.device)
        if weights.shape[-1] != n or (weights.ndim == 2
                                      and weights.shape[0] != g):
            raise ValueError(f"harmonic_sums_cuda: weights of shape "
                             f"{tuple(weights.shape)} do not match phases "
                             f"of shape {tuple(phases.shape)}")
        w_ptr, w_stride = weights.data_ptr(), (n if weights.ndim == 2
                                               else 0)
    dev = phases.device.index
    plan = launch_plan(dev, g, n, m, rows.data_ptr(), w_ptr, w_stride)
    partial = torch.empty(partial_floats(plan), dtype=torch.float32,
                          device=phases.device)
    out = torch.empty((g, 2, m), dtype=torch.float64, device=phases.device)
    stream = torch.cuda.current_stream(phases.device).cuda_stream
    rc = _kernel_fns()[0](rows.data_ptr(), w_ptr, partial.data_ptr(),
                          out.data_ptr(), plan, dev, stream)
    if rc != 0:
        raise RuntimeError(f"harmonic_sums_f32 launch failed with CUDA "
                           f"error {rc}")
    harmonic_sums_cuda.launches += 1
    if phases.ndim == 1:
        out = out[0]
    return out[..., 0, :], out[..., 1, :]


harmonic_sums_cuda.launches = 0


def harmonic_sums(phases, m, weights=None):
    """(C[1..m], S[1..m]) in f64 of phases (n,) or (G, n): the kernel
    for a CUDA tensor with n >= 65536 photons per row, the f64
    reference otherwise (the JAX package's dispatch)."""
    if phases.is_cuda and phases.shape[-1] >= KERNEL_MIN_PHOTONS:
        f32 = torch.float32
        w = (None if weights is None else
             torch.as_tensor(weights, device=phases.device).to(f32)
             .contiguous())
        return harmonic_sums_cuda(phases.to(f32).contiguous(), m, w)
    return harmonic_sums_ref(phases, m, weights)
