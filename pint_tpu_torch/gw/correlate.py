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
``precision="mixed"`` on a card. The sweep is one ``gw.correlate``
span; it counts its pairs and tiles in the registry (``gw.pairs``,
``gw.pair_blocks``) and attributes its own FLOPs and bytes through
``obs.costmodel`` on the platform of ``device`` (``mfu_pct``,
``roofline_pct``, ``bound``). The FLOPs are the JAX package's count,
4 x a x b x M per (a, b) tile (two products, a multiply and an add
each); the bytes are each tile's four operand slices read and its two
products written, at the element size the tier moves: 4 bytes under
``precision="mixed"`` (f32 operands and products), 8 in f64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..fitter import check_precision
from ..kernels.paircorr import pair_products
from ..obs import clock as obs_clock
from ..obs import costmodel, metricsreg
from ..obs import trace as obs_trace


def correlation_sweep(z, w, fold, block=256, precision="f64",
                      device="cuda"):
    """Stream every unordered pulsar pair's (num, den) products
    through ``fold(a0, b0, num, den)`` in (block x block) tiles:
    ``num``/``den`` are host f64 arrays covering global pulsar rows
    ``a0:a0+num.shape[0]`` x cols ``b0:b0+num.shape[1]``, with
    invalid (a >= b) entries zeroed. The products run on ``device``.
    Returns the sweep stats dict {n_psr, n_cells, n_pairs, n_blocks,
    wall_s, pairs_per_s, flops, bytes_accessed, mfu_pct, roofline_pct,
    bound, platform} (the module docstring says how the FLOPs and bytes
    are counted)."""
    check_precision(precision)
    dev = resolve_device(device)
    z = np.asarray(z, np.float64)
    w = np.asarray(w, np.float64)
    P, M = z.shape
    block = max(1, int(block))
    dtype = torch.float32 if precision == "mixed" else torch.float64
    esize = 4 if precision == "mixed" else 8
    n_pairs = P * (P - 1) // 2
    flops = 0
    bytes_accessed = 0
    n_blocks = 0
    with obs_trace.span("gw.correlate", n_psr=P, n_cells=M, block=block,
                        precision=precision) as sp:
        t0 = obs_clock.now()
        # u in f64 on the host, then one upload (rounded to f32 in
        # mixed, as the JAX package rounds each tile)
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
                ba, bb = a1 - a0, b1 - b0
                flops += 4 * ba * bb * M
                bytes_accessed += esize * (2 * (ba + bb) * M + 2 * ba * bb)
                n_blocks += 1
        wall_s = obs_clock.now() - t0
        metricsreg.REGISTRY.counter("gw.pairs").inc(n_pairs)
        metricsreg.REGISTRY.counter("gw.pair_blocks").inc(n_blocks)
        attr = costmodel.attribute(flops, bytes_accessed, wall_s=wall_s,
                                   platform=costmodel.platform_of(dev))
        stats = {"n_psr": P, "n_cells": M, "n_pairs": n_pairs,
                 "n_blocks": n_blocks, "wall_s": wall_s,
                 "pairs_per_s": n_pairs / wall_s if wall_s > 0 else None,
                 "flops": flops, "bytes_accessed": bytes_accessed,
                 "mfu_pct": attr["mfu_pct"],
                 "roofline_pct": attr["roofline_pct"],
                 "bound": attr["bound"], "platform": attr["platform"]}
        if obs_trace.enabled():
            sp.set(n_pairs=n_pairs, wall_s=round(wall_s, 6),
                   pairs_per_s=stats["pairs_per_s"],
                   mfu_pct=stats["mfu_pct"],
                   roofline_pct=stats["roofline_pct"],
                   bound=stats["bound"])
    return stats


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
