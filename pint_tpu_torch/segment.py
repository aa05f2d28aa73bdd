"""Segment reductions: the port's ``jax.ops.segment_sum``/``segment_max``.

``segment_sum`` adds each segment's rows in a fixed order on either
device, so a fit repeats bitwise, as the JAX package's does: on the CPU
``index_add_`` adds in row order; on CUDA ``index_add_`` adds with
atomics in an order that changes from run to run (on an H100 none of
five repeats of a 460,800 x 90 f64 sum into 100 segments matched the
first), so the sum there is ``index_put_(accumulate=True)``, which sorts
the ids and adds each segment's rows in one fixed order (all five
repeats matched). Where
segments are block-aligned — the packed layout keys every Q-row block
to one slot — ``block_segment_sum`` reduces inside each block first,
which leaves ~Q-fold fewer rows to sort.
"""

from __future__ import annotations


def segment_sum(x, seg, n_seg):
    """out[s] = sum of x[i] over i with seg[i] == s; out has n_seg rows."""
    out = x.new_zeros((n_seg,) + tuple(x.shape[1:]))
    if x.is_cuda:
        return out.index_put_((seg,), x, accumulate=True)
    return out.index_add_(0, seg, x)


def segment_max(x, seg, n_seg):
    """out[s] = max of x[i] over seg[i] == s; empty segments are -inf."""
    out = x.new_full((n_seg,) + tuple(x.shape[1:]), float("-inf"))
    idx = seg.reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    return out.scatter_reduce_(0, idx, x, "amax", include_self=True)


def block_segment_sum(x, block_seg, n_seg, block):
    """segment_sum over rows whose segment ids are constant on each
    ``block``-row chunk (``block_seg`` gives one id per chunk)."""
    xb = x.reshape((x.shape[0] // block, block) + tuple(x.shape[1:]))
    return segment_sum(xb.sum(dim=1), block_seg, n_seg)
