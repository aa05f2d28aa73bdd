"""Cost-model-driven shape planner for ragged PTA batches.

The pow2 bucket ladder burns ~37% of Gram/GLS FLOPs on padding at the
670k-TOA fleet scale (BENCH measured_670k_padding_ratio 1.366) and
cold-compiles one program per bucket. This module plans shapes the way
LLM serving stacks plan sequence packing:

- **Segment packing**: several small pulsars share one padded row.
  Each pulsar occupies a contiguous, quantum-aligned *segment* of the
  row; the GLS math stays per-pulsar via segment-summed Grams and
  per-segment eigh solves (parallel/pta.py packed path,
  kernels/seggram.py).
- **Ladder optimization**: an exhaustive search over candidate width
  ladders minimizes padded area subject to a compile budget (number of
  distinct compiled programs), instead of blindly doubling.

A :class:`ShapePlan` is pure host-side geometry — which pulsar goes in
which row of which bucket, at which offset — plus a stable
``signature()``. The planner never touches device arrays.

(Host numpy copied from the JAX package's ``parallel/shapeplan.py``;
``pow2_width`` wraps the port's ``serve/batcher.py::pow2_bucket``.)
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field

__all__ = [
    "Segment", "PlanRow", "PlanBucket", "ShapePlan",
    "align_up", "ladder_width", "plan_shapes", "pow2_width",
    "PACK_GEOMETRY_VERSION",
]

DEFAULT_QUANTUM = 256
DEFAULT_MAX_PACK = 8
DEFAULT_COMPILE_BUDGET = 4
# Version of the PACKED-BATCH GEOMETRY itself, the JAX package's value:
# bumped whenever the layout a ShapePlan produces for the SAME inputs
# changes. On-disk artifacts derived from packed state stamp it into
# their identity (store/packstore.py::store_identity) so a geometry
# change invalidates them visibly. v3 marks the append-capable store
# revision: base entries may carry delta segments chained beside them
# (store/deltas.py).
PACK_GEOMETRY_VERSION = 3
# below this, vector lanes go idle and per-program overhead dominates
DEFAULT_MIN_WIDTH = 1024
# candidate-pool size for the ladder search: subsets of <= budget
# widths from <= _POOL candidates keeps the search a few thousand
# ladders even with the quantum ladder multiplying it out
_POOL = 20

# finer segment quanta the planner may refine to when the caller's
# quantum is coarser: every entry is a multiple of 32, so the packed
# path's gcd-derived block size and the 32-aligned ECORR epoch
# quantum stay compatible (parallel/pta.py::stack_packed)
_QUANTUM_LADDER = (128, 96, 64, 32)
# relative cost penalty for finer quanta, x(1 + _QUANTUM_PENALTY/q):
# the block-factorized Gram stores + segment-sums one (K, K) block
# per q rows next to the 2 K^2 multiply-adds per row, an overhead
# share of ~1/(2q); doubled to 1/q to also cover the intermediate's
# memory traffic. A finer quantum must buy its padding back first.
_QUANTUM_PENALTY = 1.0


def pow2_width(n, floor=256):
    """Smallest power-of-two >= n, starting at ``floor`` (the legacy
    ladder): the port's serve/batcher.py::pow2_bucket, so fleet buckets
    and the pow2 convention cannot desynchronize."""
    from ..serve.batcher import pow2_bucket

    return pow2_bucket(n, floor)


def align_up(n, quantum):
    """Round ``n`` up to a multiple of ``quantum`` (minimum one)."""
    n = max(1, int(n))
    q = int(quantum)
    return ((n + q - 1) // q) * q


def ladder_width(n, widths, floor=256):
    """Smallest ladder width >= n; pow2 fallback above the ladder."""
    for w in sorted(widths):
        if w >= n:
            return int(w)
    return pow2_width(n, floor)


@dataclass(frozen=True)
class Segment:
    """One pulsar's quantum-aligned span inside a packed row."""

    index: int   # pulsar position in the planner's input order
    n_toas: int  # real TOA count
    width: int   # aligned segment width (>= n_toas)


@dataclass(frozen=True)
class PlanRow:
    """One padded row: an ordered tuple of segments. The final
    segment absorbs the row tail when the packer widens it to the
    bucket width, so tail padding stays attached to a real pulsar."""

    segments: tuple

    @property
    def used(self):
        return sum(s.width for s in self.segments)

    @property
    def n_toas(self):
        return sum(s.n_toas for s in self.segments)


@dataclass(frozen=True)
class PlanBucket:
    """All rows that share one compiled program shape (width)."""

    width: int
    rows: tuple

    @property
    def n_slots(self):
        return max(len(r.segments) for r in self.rows)

    @property
    def padded_area(self):
        return self.width * len(self.rows)

    @property
    def real_area(self):
        return sum(r.n_toas for r in self.rows)

    def indices(self):
        """Pulsar indices in row-major, slot order."""
        return [s.index for r in self.rows for s in r.segments]

    def renumbered(self):
        """Copy with segment indices replaced by their position in
        ``indices()`` order — the order a packer (stack_packed)
        receives the bucket's pulsars."""
        pos = 0
        rows = []
        for r in self.rows:
            segs = []
            for s in r.segments:
                segs.append(Segment(pos, s.n_toas, s.width))
                pos += 1
            rows.append(PlanRow(tuple(segs)))
        return PlanBucket(self.width, tuple(rows))


@dataclass(frozen=True)
class ShapePlan:
    """The planner's output: buckets plus the knobs that produced
    them. Immutable; ``signature()`` is stable across processes."""

    buckets: tuple
    counts: tuple
    quantum: int = DEFAULT_QUANTUM
    max_pack: int = DEFAULT_MAX_PACK
    compile_budget: int = DEFAULT_COMPILE_BUDGET
    _sig: str = field(default="", compare=False)

    @property
    def n_programs(self):
        return len(self.buckets)

    @property
    def widths(self):
        return tuple(sorted({b.width for b in self.buckets}))

    @property
    def padded_area(self):
        return sum(b.padded_area for b in self.buckets)

    @property
    def real_area(self):
        return sum(b.real_area for b in self.buckets)

    @property
    def padding_ratio(self):
        real = self.real_area
        return float(self.padded_area) / real if real else 1.0

    def indices(self):
        """Every pulsar index, bucket-major (must cover the input
        exactly once — property-tested)."""
        return [i for b in self.buckets for i in b.indices()]

    def width_for(self, n):
        """Serve-side slot width for a single request of ``n`` TOAs:
        smallest planned width that fits, pow2 above the ladder."""
        return ladder_width(n, self.widths)

    def signature(self):
        """Stable short hash of the full geometry, for executable
        cache keys and bench metadata."""
        if self._sig:
            return self._sig
        h = hashlib.blake2s(digest_size=8)
        h.update(repr((self.quantum, self.max_pack,
                       self.compile_budget)).encode())
        for b in self.buckets:
            h.update(repr((b.width,
                           tuple(tuple((s.index, s.width)
                                       for s in r.segments)
                                 for r in b.rows))).encode())
        sig = "plan-" + h.hexdigest()
        object.__setattr__(self, "_sig", sig)
        return sig


def _ffd_pack(segs, width, max_pack):
    """First-fit-decreasing bin packing of segments into rows of
    ``width`` with at most ``max_pack`` segments per row. ``segs`` is
    a list of (seg_width, index, n_toas), pre-sorted descending."""
    rows = []      # list of [remaining, [Segment, ...]]
    for sw, idx, n in segs:
        placed = False
        for row in rows:
            if row[0] >= sw and len(row[1]) < max_pack:
                row[1].append(Segment(idx, n, sw))
                row[0] -= sw
                placed = True
                break
        if not placed:
            rows.append([width - sw, [Segment(idx, n, sw)]])
    return [PlanRow(tuple(r[1])) for r in rows]


# relative cost of one extra evaluation slot per row: the packed path
# evaluates phase + the parameter jacobian once per slot over the
# whole row — cheap next to the K^2-per-TOA Gram but not free. With
# the x-independent slot work hoisted out of the iteration loop
# (parallel/pta.py packed hoist) the residual marginal cost is the
# per-iteration phase/jacobian alone; 0.08 is its measured share.
_SLOT_COST = 0.08
# the planner's padding target: among ladders at or under this ratio
# the slot-overhead cost decides; a ladder over it only wins when no
# compliant ladder exists. 1.05 is the fused-pipeline acceptance
# bound at the 670k fleet scale (ERRORBUDGET.md padded-FLOP budget).
DEFAULT_PADDING_TARGET = 1.05


def _evaluate_ladder(widths, segs_desc, max_pack):
    """Pack every pulsar under a fixed ladder; returns
    (cost, padded_area, buckets). Each pulsar joins the smallest
    ladder width that fits its aligned segment, then FFD packs within
    the width class. Cost = padded area inflated by the per-slot
    evaluation overhead."""
    widths = sorted(widths)
    classes = {w: [] for w in widths}
    for sw, idx, n in segs_desc:
        for w in widths:
            if w >= sw:
                classes[w].append((sw, idx, n))
                break
        else:  # pragma: no cover - ladders always include the max seg
            classes[widths[-1]].append((widths[-1], idx, n))
    buckets = []
    area = 0
    cost = 0.0
    for w in widths:
        if not classes[w]:
            continue
        rows = _ffd_pack(classes[w], w, max_pack)
        bucket = PlanBucket(w, tuple(rows))
        buckets.append(bucket)
        area += w * len(rows)
        cost += w * len(rows) * (1.0 + _SLOT_COST * (bucket.n_slots - 1))
    return cost, area, tuple(buckets)


def _candidate_widths(seg_widths, quantum, min_width):
    """<= _POOL candidate widths: quantiles of the aligned segment
    distribution plus power-of-two-ish pack targets, always including
    the max (every ladder must fit the largest pulsar)."""
    distinct = sorted({max(w, min_width) for w in seg_widths})
    top = distinct[-1]
    pool = {top, min_width}
    # quantile sample of the distribution
    if len(distinct) > 1:
        for k in range(1, _POOL - 2):
            pool.add(distinct[(k * (len(distinct) - 1)) // (_POOL - 2)])
    # pack targets: multiples of the median give small pulsars rows
    # they can genuinely share
    med = distinct[len(distinct) // 2]
    for mult in (2, 3, 4):
        cand = align_up(min(mult * med, top), quantum)
        pool.add(cand)
    pool = sorted(pool)
    if len(pool) > _POOL:
        # keep endpoints, thin the middle
        keep = {pool[0], pool[-1]}
        for k in range(1, _POOL - 1):
            keep.add(pool[(k * (len(pool) - 1)) // (_POOL - 1)])
        pool = sorted(keep)
    return pool


def plan_shapes(counts, quantum=DEFAULT_QUANTUM, max_pack=DEFAULT_MAX_PACK,
                compile_budget=DEFAULT_COMPILE_BUDGET,
                min_width=DEFAULT_MIN_WIDTH,
                padding_target=DEFAULT_PADDING_TARGET):
    """Plan a packed bucket layout for ``counts`` TOA counts.

    Exhaustive search over ladders of <= ``compile_budget`` widths
    drawn from a small candidate pool; each ladder is scored by its
    FFD-packed padded area plus a per-slot evaluation overhead, with
    ``padding_target`` as a soft ceiling: ladders padding worse than
    the target lose to any compliant ladder regardless of slot count.

    ``quantum`` is the COARSEST alignment the caller accepts: the
    search also tries the finer entries of ``_QUANTUM_LADDER`` below
    it (each cost-penalized by x(1 + _QUANTUM_PENALTY/q) for its
    block-bookkeeping overhead) and keeps the overall winner — the
    compile budget is unchanged, only the segment alignment inside
    the same number of programs gets finer. Explicitly fine quanta
    (e.g. test fixtures at 16) see a single-entry ladder and behave
    exactly as before. Deterministic for fixed inputs.
    """
    counts = [int(c) for c in counts]
    if not counts or min(counts) < 1:
        raise ValueError("counts must be a non-empty list of positive ints")
    if compile_budget < 1:
        raise ValueError("compile_budget must be >= 1")
    max_pack = max(1, int(max_pack))
    best = None  # ((over_target, cost, n_widths, n_rows), buckets)
    for q in [int(quantum)] + [m for m in _QUANTUM_LADDER
                               if m < int(quantum)]:
        cand = _plan_for_quantum(counts, q, max_pack, compile_budget,
                                 min_width, padding_target)
        if best is None or cand[0] < best[0]:
            best = cand
    return ShapePlan(buckets=best[1], counts=tuple(counts),
                     quantum=int(quantum), max_pack=max_pack,
                     compile_budget=int(compile_budget))


def _plan_for_quantum(counts, quantum, max_pack, compile_budget,
                      min_width, padding_target):
    """One quantum's ladder search: ((over, cost, n_widths, n_rows),
    buckets) for the best ladder at this alignment, with the cost
    already carrying the finer-quantum penalty so plan_shapes can
    compare candidates across quanta directly."""
    segs = sorted(
        ((max(align_up(n, quantum), 1), i, n)
         for i, n in enumerate(counts)),
        key=lambda t: (-t[0], t[1]))
    seg_widths = [s[0] for s in segs]
    pool = _candidate_widths(seg_widths, quantum, min_width)
    top = max(max(seg_widths), min_width)
    rest = [w for w in pool if w != top]
    real = sum(counts)
    penalty = 1.0 + _QUANTUM_PENALTY / quantum
    best = None
    for k in range(0, min(compile_budget, len(rest) + 1)):
        for combo in itertools.combinations(rest, k):
            cost, area, buckets = _evaluate_ladder(
                combo + (top,), segs, max_pack)
            n_rows = sum(len(b.rows) for b in buckets)
            over = area > padding_target * real
            key = (over, cost * penalty, len(buckets), n_rows)
            if best is None or key < best[0]:
                best = (key, buckets)
    return best
