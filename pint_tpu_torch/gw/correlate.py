"""All-pairs cross-correlation sweep over the common epoch lattice
(torch counterpart of the JAX package's ``gw/correlate.py``).

For every unordered pulsar pair (a, b) the optimal statistic needs the
weighted zero-lag products

    num_ab = sum_m U_a[m] U_b[m]     U = W * z
    den_ab = sum_m W_a[m] W_b[m]

i.e. the pair correlation rho_ab = num/den and its inverse variance
den. Over a block of pulsars both are matrix products (see
kernels/paircorr.py), so the O(P^2) sweep — ~4.5M pairs at 3000
pulsars — is a dense matrix-product workload.

:func:`correlation_sweep` streams the strict upper triangle in
(block x block) tiles through a caller-supplied fold, so the full
(P, P) pair matrix never materializes: peak memory is one (block,
block) tile pair on the host regardless of P. ``U`` and ``W`` go to the
device once and the tiles are sliced there. Diagonal tiles have their
a >= b entries zeroed in BOTH products before the fold sees them, so
any fold that weights by num/den (every accumulation in hd.py does)
needs no pair masking of its own.

Each tile's products go through ``kernels.pair_products``: the f64
reference by default, the hand-written Hopper kernel under
``precision="mixed"`` on a card. The JAX package's ``gw.correlate`` span,
registry counters and cost-model attribution are not ported yet, so
``mfu_pct``, ``roofline_pct`` and ``bound`` are None.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..fitter import check_precision
from ..kernels.paircorr import pair_products


def correlation_sweep(z, w, fold, block=256, precision="f64",
                      device="cuda"):
    """Stream every unordered pulsar pair's (num, den) products
    through ``fold(a0, b0, num, den)`` in (block x block) tiles:
    ``num``/``den`` are host f64 arrays covering global pulsar rows
    ``a0:a0+num.shape[0]`` x cols ``b0:b0+num.shape[1]``, with
    invalid (a >= b) entries zeroed. The products run on ``device``.
    Returns the sweep stats dict {n_psr, n_cells, n_pairs, n_blocks,
    wall_s, pairs_per_s, flops, mfu_pct, roofline_pct, bound}."""
    check_precision(precision)
    dev = resolve_device(device)
    z = np.asarray(z, np.float64)
    w = np.asarray(w, np.float64)
    P, M = z.shape
    block = max(1, int(block))
    dtype = torch.float32 if precision == "mixed" else torch.float64
    n_pairs = P * (P - 1) // 2
    flops = 0
    n_blocks = 0
    t0 = time.perf_counter()
    # u in f64 on the host, then one upload (rounded to f32 in mixed,
    # as the JAX package rounds each tile)
    u_d = torch.as_tensor(w * z, device=dev).to(dtype)
    w_d = torch.as_tensor(w, device=dev).to(dtype)
    for a0 in range(0, P, block):
        a1 = min(a0 + block, P)
        ua, wa = u_d[a0:a1], w_d[a0:a1]
        for b0 in range(a0, P, block):
            b1 = min(b0 + block, P)
            num, den = pair_products(ua, wa, u_d[b0:b1], w_d[b0:b1],
                                     precision=precision)
            num = np.asarray(num.cpu().numpy(), np.float64)
            den = np.asarray(den.cpu().numpy(), np.float64)
            if b0 == a0:
                # diagonal tile: keep only a < b
                ii = np.arange(a0, a1)
                keep = ii[:, None] < ii[None, :]
                num = np.where(keep, num, 0.0)
                den = np.where(keep, den, 0.0)
            fold(a0, b0, num, den)
            flops += 4 * (a1 - a0) * (b1 - b0) * M
            n_blocks += 1
    wall_s = time.perf_counter() - t0
    return {"n_psr": P, "n_cells": M, "n_pairs": n_pairs,
            "n_blocks": n_blocks, "wall_s": wall_s,
            "pairs_per_s": n_pairs / wall_s if wall_s > 0 else None,
            "flops": flops, "mfu_pct": None, "roofline_pct": None,
            "bound": None}


def correlation_matrix(z, w, block=256, precision="f64", device="cuda"):
    """Materialize the full strict-upper-triangle (P, P) pair
    products — tests and small fleets only; real sweeps stay
    streaming. Returns (num, den, stats)."""
    P = np.asarray(z).shape[0]
    num = np.zeros((P, P))
    den = np.zeros((P, P))

    def fold(a0, b0, nb, db):
        num[a0:a0 + nb.shape[0], b0:b0 + nb.shape[1]] = nb
        den[a0:a0 + db.shape[0], b0:b0 + db.shape[1]] = db

    stats = correlation_sweep(z, w, fold, block=block, precision=precision,
                              device=device)
    return num, den, stats
