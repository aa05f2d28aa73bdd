"""The C interface of ``csrc/gram.cu``: its ctypes binding, its launch
plan and a checked launcher, shared by the two kernels that source
carries (K1 in :mod:`.fusedgls`, K2 in :mod:`.seggram`, and K1′ in
:mod:`.incremental`). The library is built and loaded on first use by
:func:`.build.load`.

The launch plan is computed here, in Python, so that the CPU tests reach
every choice: the threads of a block (one per 4 x 4 tile of the output's
upper triangle, up to 256; grid.y splits the rest), the rows of a ring
chunk, the dynamic shared memory, whether rows copy 16 bytes at a time,
whether the products read rows straight from the ring, whether the
output leaves by one bulk store, and the persistent grid (as many
blocks as stay resident on the card, never more than there are
Q-blocks). ``csrc/gram.cu`` checks the shared bytes against its own
layout and refuses a plan it cannot run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

TILE = 4  # output tile edge owned by one thread (gram.cu kTile)
MAX_THREADS = 256  # gram.cu kMaxThreads
STAGES = 3  # row chunks in the ring (gram.cu kStages)
CHUNK_BYTES = 8192  # target size of one ring chunk
SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt into (227 KB)

# {nb, q, ka, grid_x, threads, chunk, vec, bulk, smem_bytes}, as
# csrc/gram.cu's `launch` reads it
PlanArray = ctypes.c_longlong * 9

_FN = {}
_RESIDENT = {}
_PLANS = {}


class GramShape(NamedTuple):
    """Per-block launch shape of ``block_gram_kernel`` for (q, ka)."""
    threads: int  # threads per block, a multiple of 32
    grid_y: int  # blocks that split the output tiles
    chunk: int  # rows per ring chunk
    direct: bool  # the products read rows straight from the ring
    smem_bytes: int  # dynamic shared memory of one block


@functools.lru_cache(maxsize=256)
def gram_shape(q, ka, whiten):
    """The launch shape for Q-blocks of q rows of ka floats (the last
    column whitening the rest when ``whiten``): one thread per 4 x 4
    tile of the upper triangle, up to 256 a block. Shared memory holds a
    ring of ``STAGES`` chunks of about ``CHUNK_BYTES`` (a multiple of 4
    rows, at most q); the chunk laid out at a row stride of ka rounded
    up to 4, except where the products read rows straight from the ring
    (no whitening, ka a multiple of 4); and the dense (ka, ka) staging
    tile. Raises when that exceeds what a block may have."""
    if q < 1 or ka < 1:
        raise ValueError(f"gram: need q >= 1 and ka >= 1, got {q}, {ka}")
    ntr = -(-ka // TILE)
    n_tiles = ntr * (ntr + 1) // 2
    threads = min(MAX_THREADS, -(-n_tiles // 32) * 32)
    chunk = min(q, max(4, CHUNK_BYTES // (4 * TILE * ka) * 4))
    direct = not whiten and ka % TILE == 0
    smem = 4 * (STAGES * (-(-chunk * ka // 4) * 4)
                + (0 if direct else chunk * TILE * ntr) + ka * ka)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gram: {ka} columns need {smem} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may have")
    return GramShape(threads, -(-n_tiles // threads), chunk, direct, smem)


def copies_16_bytes(q, ka, chunk, data_ptr):
    """Whether the ring copies rows 16 bytes at a time: every chunk of
    every Q-block must start on a 16-byte boundary and be a whole number
    of 16-byte pieces. Else each thread copies 4 bytes at a time."""
    return q * ka % 4 == 0 and chunk * ka % 4 == 0 and data_ptr % 16 == 0


def bulk_store(ka, grid_y, out_ptr, nb, grid_x):
    """Whether a Q-block's (ka, ka) Gram leaves shared memory by one bulk
    store (the Tensor Memory Accelerator): it needs ka * ka floats to be
    whole 16-byte pieces (ka even), an aligned output and one block per
    Q-block (grid_y 1), and it pays only where a block walks more than
    one Q-block (nb > grid_x), so that the store drains while the next
    one is multiplied out. Else the block's threads copy the Gram out
    (K1′'s single Q-block among them)."""
    return (nb > grid_x and ka % 2 == 0 and grid_y == 1
            and out_ptr % 16 == 0)


def persistent_grid(nb, grid_y, resident):
    """Blocks along x: as many as stay resident (``resident`` blocks on
    the card, shared by the ``grid_y`` rows of the grid), at least 1 and
    never more than the ``nb`` Q-blocks."""
    return max(1, min(nb, resident // grid_y))


def kernel_fn(name):
    """The C entry ``name`` of csrc/gram.cu, argtypes set (pointers and
    the stream as c_void_p, so none is cut to 32 bits; the launch plan as
    one int64 array)."""
    fn = _FN.get(name)
    if fn is None:
        from .build import load

        lib = load("gram")
        fn = getattr(lib, name)
        if name == "gram_resident_blocks":
            fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, PlanArray,
                           ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN[name] = fn
    return fn


def resident_blocks(device_index, threads, smem_bytes):
    """Blocks of this shape that stay resident on the card (SM count x
    blocks per SM, from the CUDA occupancy API), cached per shape."""
    key = (device_index, threads, smem_bytes)
    n = _RESIDENT.get(key)
    if n is None:
        out = ctypes.c_int(0)
        rc = kernel_fn("gram_resident_blocks")(threads, smem_bytes,
                                               device_index,
                                               ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"gram_resident_blocks failed with CUDA "
                               f"error {rc} ({out.value} blocks)")
        n = _RESIDENT[key] = out.value
    return n


def gram_plan(nb, q, ka, whiten, data_ptr, out_ptr, resident):
    """Everything the C entry needs besides the tensors: (grid_x,
    threads, chunk, vec, bulk, smem_bytes), with ``resident`` blocks of
    the shape resident on the card."""
    shape = gram_shape(q, ka, whiten)
    grid_x = persistent_grid(nb, shape.grid_y, resident)
    return (grid_x, shape.threads, shape.chunk,
            int(copies_16_bytes(q, ka, shape.chunk, data_ptr)),
            int(bulk_store(ka, shape.grid_y, out_ptr, nb, grid_x)),
            shape.smem_bytes)


def launch_gram(name, x, block):
    """Check ``x`` and launch the C entry ``name`` on it: (n, k) f32
    contiguous CUDA rows -> (n/block, k, k) f32 block Grams, on the
    current stream of x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D tensor")
    n, k = x.shape
    if block < 1 or n % block:
        raise ValueError(f"{name}: {n} rows are not a multiple of block={block}")
    nb = n // block
    out = torch.empty((nb, k, k), dtype=torch.float32, device=x.device)
    if nb == 0 or k == 0:
        return out
    dev = x.device.index
    xp, op = x.data_ptr(), out.data_ptr()
    # the plan depends on the pointers only through their alignment; a
    # lookup of the packed plan keeps the per-call host cost of small
    # launches (K1′) down
    key = (name, dev, nb, block, k, xp % 16, op % 16)
    plan = _PLANS.get(key)
    if plan is None:
        whiten = name == "fused_block_gls_f32"
        shape = gram_shape(block, k, whiten)
        if len(_PLANS) >= 1024:
            _PLANS.clear()
        plan = _PLANS[key] = PlanArray(nb, block, k, *gram_plan(
            nb, block, k, whiten, xp, op,
            resident_blocks(dev, shape.threads, shape.smem_bytes)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = kernel_fn(name)(xp, op, plan, dev, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    return out
