"""PTA batch fitting in torch (counterpart of the JAX package's
``parallel/pta.py``): stack many pulsars' prepared models into one
batch and run the noise-marginalised GLS refit over all of them at once.

What the JAX package writes per pulsar (or per packed row) and
``jax.vmap``s, the port writes once with the batch dimension spelled
out. ``torch.func.vmap`` is used only around the pure phase, sigma,
noise-basis and jacobian evaluations of the timing model — never around
a kernel call: the packed program hands all rows of a bucket to ONE
kernel launch, with segment ids ``row * S + slot``.

Three programs, as in the JAX package:

- :meth:`PTABatch._build_gls_packed` — the shape-planned layout where
  several pulsars share a padded row (``stack_packed``); fused and
  classic, f64 and mixed. Under ``precision="mixed"`` it runs the two
  hand-written kernels (kernels/fusedgls.py, kernels/seggram.py).
- :meth:`PTABatch._build_gls` — one pulsar per row: analytically
  marginalised sparse ECORR (with the noise hoist), or the dense solve
  over every basis column (``ecorr_mode="dense"``, overlapping ECORR
  masks, or no ECORR).
- :meth:`PTABatch._build_wls` — the column-normalised SVD step for
  structures without correlated noise (``PTAFleet.fit`` method "wls",
  or "auto" on such a bucket).

``precision="auto"`` times one warm mixed and one warm f64 fit of a
bucket structure and keeps the faster (:meth:`PTABatch._resolve_precision`).

:meth:`PTAFleet.gw_stage` runs the GW detection stage (``gw/``) on the
fitted fleet: :meth:`PTABatch.gw_arrays` evaluates post-fit residuals
in both layouts, the packed one through the packed fit's own slot
machinery (:meth:`PTABatch._slots`).

The fleet executor (:meth:`PTAFleet.fit` with ``pipeline=True``,
:meth:`PTAFleet.precompile`, :func:`fleet_aot_compile`,
:func:`fleet_pipeline_metrics`) keeps each bucket's programs in
``PTABatch._fns``, keyed as the JAX package keys its compiled
executables. On the card a program is captured into CUDA graphs
(``graphs.py``: the eighs and SVDs run eagerly between them); a fit is
split into a dispatch that queues the device work and a finalize that
pulls once, so a fleet can dispatch every bucket before it pulls any.
With ``obs.fitquality.enable()`` each finalize records the fit-quality
probes of its bucket from the host arrays it has already pulled
(:meth:`PTABatch._record_quality`; ``PTABatch.quality``,
``PTAFleet.fit_quality``). ``PTAFleet(store=)`` builds each bucket
store-first from a ``store.PackStore``.

``PTABatch(mesh=)`` over a 1-D "pulsar" mesh (``parallel/mesh.py``)
with more than one non-empty shard builds a ``sharded.ShardedBatch``,
which splits the pulsars into one child batch per mesh device.

Spans (``obs.trace``, off by default; the JAX package's names):
``fleet.host_prep`` per bucket build and ``fleet.pack`` for a wait on a
deferred one, ``fleet.fit`` around a fleet fit, ``fleet.dispatch`` per
bucket on the pipelined path, ``fleet.execute`` per bucket finalize,
``fleet.compile`` around the program builds (``phase="trace"``) and
each capture (``phase="xla"``), and ``gw.stage``. Worker threads join
their caller's trace by ``trace_id``. Every program built for the AOT
split carries its cost (:meth:`PTABatch._program_cost`), which
``fleet.execute`` attributes against the card's roofline
(``obs.costmodel``). Spans read the host clock only: a traced fit is
bitwise the untraced one, and with tracing off no attribute is built.
"""

from __future__ import annotations

import math
import os
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from .. import DTYPE, autodiff, fitter, graphs, gw, resolve_device
from ..fitter import (_mtv, _mv, check_precision, gls_eigh_refine,
                      gls_eigh_solve, gls_fused_normal, gls_gram, gls_whiten,
                      relres_failed, seg_gls_eigh_refine, seg_gls_norm,
                      seg_gls_whiten, stack_noise_bases, wls_step)
from ..kernels.fusedgls import fused_segment_gls
from ..kernels.seggram import segment_gram
from ..models.noise import EcorrNoise
from ..models.timing_model import _overlay_params, host_to_device
from ..obs import clock as obs_clock
from ..obs import fitquality as obs_fitq
from ..obs import trace as obs_trace
from ..segment import block_segment_sum, segment_sum
from ..toa import TOABatch

_EXCLUDE_KEYS = ("T_ld", "pepoch_day", "pepoch_sec")
_STATIC_KEYS = ("orb_mode_fb", "planet_shapiro", "obliquity",
                "tropo_on", "ifunc_mode", "fdjump_orders")
_PAD_SIGMA = 1e30


def _is_static(key, value):
    """Control-flow config (bools/strs/known keys) stays Python scalars."""
    return key in _STATIC_KEYS or isinstance(value, (bool, str))


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _pull(*tensors):
    """f64 device tensors -> numpy arrays through ONE device->host copy
    (the finalize's single pull)."""
    host = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


# precision="auto" verdicts per (structure, shapes, fit options), kept
# for the process (PTABatch._resolve_precision)
_PRECISION_AUTO_CACHE = {}


def _uniform_ecorr(preps):
    """One ECORR representation across a batch: pulsars with
    overlapping masks pack the dense U, disjoint ones the O(n) epoch
    index (models/noise.py::EcorrNoise.pack); a mixed batch densifies
    the sparse ones, as the JAX package does."""
    if (any("ecorr_U" in p.prep for p in preps)
            and any("ecorr_eidx" in p.prep for p in preps)):
        for p in preps:
            if "ecorr_eidx" in p.prep:
                p.prep["ecorr_U"] = EcorrNoise.dense_U(p.prep)
                del p.prep["ecorr_eidx"]


# prep arrays with no TOA axis: per-column and per-parameter vectors
# (a noise basis's frequencies, ECORR's epoch owners, SWX powers, IFUNC
# nodes, FB reference values, glitch epochs, DDK's sky axes)
_NO_TOA_KEYS = ("ecorr_owner", "swx_p", "ifunc_sortidx", "ifunc_mjd",
                "FB_ref", "glitch_pepoch_mjd", "ddk_east", "ddk_north")
# 2-D prep arrays laid out (k, n_toa): the per-parameter TOA masks and
# the piecewise-spindown offsets; every other 2-D per-TOA array is an
# (n_toa, k) basis (noise Fourier bases, ECORR's dense U, positions)
_TOA_LAST_KEYS = ("pw_dts",)


def _toa_axis(key):
    """The TOA axis of a prep array, from its known layout (None: it
    has none)."""
    if key.endswith("_freqs") or key in _NO_TOA_KEYS:
        return None
    return 1 if key.endswith("_masks") or key in _TOA_LAST_KEYS else 0


def _toa_dim_pad(arr, n_toa, n_max, toa_axis=0):
    """Pad this pulsar's TOA dimension to ``n_max`` (1-D per-TOA arrays
    repeat their last value; a 2-D array pads with zeros along
    ``toa_axis``). The caller takes the axis from the array's layout —
    :func:`_toa_axis` — never from which dimension happens to equal
    ``n_toa``: an (n, k) basis with n == k is padded along n, and a
    k-vector of basis frequencies with k == n not at all."""
    a = _np(arr)
    if n_toa == n_max or toa_axis is None:
        return a
    if a.ndim == 1 and a.shape[0] == n_toa:
        a = np.concatenate([a, np.repeat(a[-1:], n_max - n_toa, axis=0)])
    elif a.ndim == 2 and a.shape[toa_axis] == n_toa:
        pad = [(0, 0), (0, 0)]
        pad[toa_axis] = (0, n_max - n_toa)
        a = np.pad(a, pad)
    return a


def _pad_fields(batch, n, n_pad):
    """TOABatch fields padded from n to n_pad TOAs: the _PAD_SIGMA
    sentinel error (padded rows vanish from every whitened reduction),
    every other per-TOA column repeats its last value."""
    fields = {}
    for name in TOABatch._fields:
        a = _np(getattr(batch, name))
        if n_pad != n:
            if name == "error_us":
                a = np.concatenate([a, np.full(n_pad - n, _PAD_SIGMA)])
            elif a.ndim == 3:  # planet (n_planets, n, 3)
                a = np.concatenate(
                    [a, np.repeat(a[:, -1:], n_pad - n, axis=1)], axis=1)
            else:
                a = np.concatenate(
                    [a, np.repeat(a[-1:], n_pad - n, axis=0)], axis=0)
        fields[name] = a
    return fields


def _pad_to(a, shape):
    out = np.zeros(shape, dtype=np.asarray(a).dtype)
    sl = tuple(slice(0, s) for s in np.asarray(a).shape)
    out[sl] = np.asarray(a)
    return out


def _pad_single(prepared, n_pad):
    """One pulsar's (batch fields, prep arrays, static) with TOA dims
    padded to n_pad rows (epoch index -1 on padded rows)."""
    n = prepared.batch.n_toas
    static, arrays = {}, {}
    for k, v in prepared.prep.items():
        if k in _EXCLUDE_KEYS:
            continue
        if _is_static(k, v):
            static[k] = v
        elif k == "ecorr_eidx":
            arrays[k] = np.concatenate(
                [_np(v), np.full(n_pad - n, -1, dtype=np.int64)])
        else:
            arrays[k] = _toa_dim_pad(v, n, n_pad, _toa_axis(k))
    return _pad_fields(prepared.batch, n, n_pad), arrays, static


def stack_prepared(preps, pad_toas=None):
    """Stack same-structure PreparedTimings (numpy out).

    ``pad_toas`` forces the padded TOA axis to exactly that length
    (>= the batch max count). Returns (params, prep, batch_fields,
    static, n_toas).
    """
    _uniform_ecorr(preps)
    n_max = max(p.batch.n_toas for p in preps)
    if pad_toas is not None:
        if int(pad_toas) < n_max:
            raise ValueError(f"pad_toas={pad_toas} is below the batch "
                             f"max TOA count {n_max}")
        n_max = int(pad_toas)
    n_toas = np.array([p.batch.n_toas for p in preps])
    params = {}
    for k in preps[0].params0:
        arrs = [np.atleast_1d(_np(p.params0[k])) for p in preps]
        klen = max(a.shape[0] for a in arrs)
        params[k] = np.stack([_pad_to(a, (klen,)) for a in arrs])
        if _np(preps[0].params0[k]).ndim == 0:
            params[k] = params[k][:, 0]
    padded = [_pad_single(p, n_max) for p in preps]
    static = dict(padded[0][2])
    for k, v in static.items():
        if not all(np.all(pd[2][k] == v) for pd in padded):
            raise ValueError(f"prep[{k}] must be uniform across the PTA batch")
    prep = {}
    for k in padded[0][1]:
        arrs = [pd[1][k] for pd in padded]
        shape = tuple(max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim))
        if k == "ecorr_owner":
            # pad with -1 so padded epochs get zero weight
            prep[k] = np.stack([np.concatenate(
                [a, np.full(shape[0] - a.shape[0], -1, dtype=a.dtype)])
                for a in arrs])
        else:
            prep[k] = np.stack([_pad_to(a, shape) for a in arrs])
    fields = {name: np.stack([pd[0][name] for pd in padded])
              for name in TOABatch._fields}
    return params, prep, fields, static, n_toas


def stack_packed(preps, bucket, e_quantum=32):
    """Pack same-structure PreparedTimings into the segment-packed
    layout of a shapeplan PlanBucket (numpy out) — the JAX package's
    ``stack_packed``, same layout:

    - TOA-dim leaves are COMBINED: each row concatenates its members'
      padded segments; params and non-TOA prep leaves are SLOT-STACKED
      (R, S, ...), short rows repeating slot 0.
    - prep["_pack_block_slot"] (R, W/Q) maps each Q-row block to its
      slot (Q = gcd of all segment widths).
    - With sparse ECORR, prep["ecorr_eidx"] holds row-global epoch ids
      (members offset by e_quantum-aligned spans), prep["ecorr_owner"]
      the per-slot (NE,) owner vector (-1 off-slot), and
      prep["_pack_eblock_slot"] (R, NE/Qe) keys epoch blocks by slot.

    Returns (params, prep, batch_fields, static, n_toas, pack).
    """
    _uniform_ecorr(preps)
    W = int(bucket.width)
    rows = bucket.rows
    R = len(rows)
    S = max(len(r.segments) for r in rows)
    Q = math.gcd(W, *[s.width for r in rows for s in r.segments])
    layout = []  # per row: [[prep_index, pad_width], ...]
    for r in rows:
        segs = [[s.index, s.width] for s in r.segments]
        segs[-1][1] += W - r.used  # the last member absorbs the row tail
        layout.append(segs)
    n_psr = len(preps)
    if sorted(i for r in layout for i, _ in r) != list(range(n_psr)):
        raise ValueError("plan bucket must cover the prepared pulsars "
                         "exactly once (indices 0..n-1)")
    sparse_ecorr = "ecorr_eidx" in preps[0].prep
    padded = {i: _pad_single(preps[i], w) for r in layout for i, w in r}

    # classify prep keys once (member 0): an axis equal to the member's
    # own pad width marks a combined (TOA-dim) leaf
    i0, w0 = layout[0][0]
    combined_keys, slot_keys = set(), set()
    for k, a in padded[i0][1].items():
        if k in ("ecorr_eidx", "ecorr_owner"):
            continue
        if (a.ndim == 1 and a.shape[0] == w0) or (a.ndim == 2 and w0 in a.shape):
            combined_keys.add(k)
        else:
            slot_keys.add(k)
    info2d = {}
    for k in combined_keys:
        a0 = padded[i0][1][k]
        if a0.ndim == 2:
            taxis = 0 if a0.shape[0] == w0 else 1
            kax = 1 - taxis
            kmax = max(padded[i][1][k].shape[kax] for r in layout for i, _ in r)
            info2d[k] = (taxis, kax, kmax)
    slot_shapes = {}
    for k in slot_keys:
        shapes = [padded[i][1][k].shape for r in layout for i, _ in r]
        slot_shapes[k] = tuple(max(s[d] for s in shapes)
                               for d in range(len(shapes[0])))

    # row-global epoch numbering in e_quantum-aligned spans
    NE = 0
    epoch_info = {}
    if sparse_ecorr:
        for r in layout:
            eoff = 0
            for i, _ in r:
                k_i = int(_np(preps[i].prep["ecorr_owner"]).shape[0])
                espan = -(-k_i // int(e_quantum)) * int(e_quantum)
                epoch_info[i] = (eoff, k_i, espan)
                eoff += espan
            NE = max(NE, eoff)

    static = dict(padded[i0][2])
    prep_rows, batch_rows = [], []
    for r in layout:
        comb = {}
        for k in combined_keys:
            parts = [padded[i][1][k] for i, _ in r]
            if parts[0].ndim == 1:
                comb[k] = np.concatenate(parts)
            else:
                taxis, kax, kmax = info2d[k]
                shaped = []
                for a in parts:
                    tgt = list(a.shape)
                    tgt[kax] = kmax
                    shaped.append(_pad_to(a, tuple(tgt)))
                comb[k] = np.concatenate(shaped, axis=taxis)
        for k in slot_keys:
            vals = [_pad_to(padded[i][1][k], slot_shapes[k]) for i, _ in r]
            vals += [vals[0]] * (S - len(vals))
            comb[k] = np.stack(vals)
        if sparse_ecorr:
            eparts, owners = [], []
            for i, _ in r:
                eoff, k_i, _ = epoch_info[i]
                e = padded[i][1]["ecorr_eidx"]
                eparts.append(np.where(e >= 0, e + eoff, -1).astype(np.int64))
                ow = np.full(NE, -1, dtype=np.int64)
                ow[eoff:eoff + k_i] = _np(preps[i].prep["ecorr_owner"])
                owners.append(ow)
            owners += [np.full(NE, -1, dtype=np.int64)] * (S - len(owners))
            comb["ecorr_eidx"] = np.concatenate(eparts)
            comb["ecorr_owner"] = np.stack(owners)
            ebs = np.zeros(NE // int(e_quantum), dtype=np.int64)
            for s_i, (i, _) in enumerate(r):
                eoff, _, espan = epoch_info[i]
                ebs[eoff // int(e_quantum):(eoff + espan) // int(e_quantum)] = s_i
            comb["_pack_eblock_slot"] = ebs
        elif "ecorr_owner" in preps[i0].prep:
            # dense-U bucket: the owner stays local per slot (the
            # columns are shared across slots; each slot's rows carry
            # its own U)
            kU = max(int(_np(p.prep["ecorr_owner"]).shape[0]) for p in preps)
            owners = []
            for i, _ in r:
                ow = np.full(kU, -1, dtype=np.int64)
                o = _np(preps[i].prep["ecorr_owner"])
                ow[:o.shape[0]] = o
                owners.append(ow)
            owners += [np.full(kU, -1, dtype=np.int64)] * (S - len(owners))
            comb["ecorr_owner"] = np.stack(owners)
        bs = np.zeros(W // Q, dtype=np.int64)
        off = 0
        for s_i, (i, w) in enumerate(r):
            bs[off // Q:(off + w) // Q] = s_i
            off += w
        comb["_pack_block_slot"] = bs
        prep_rows.append(comb)
        batch_rows.append({
            name: np.concatenate([padded[i][0][name] for i, _ in r],
                                 axis=1 if padded[r[0][0]][0][name].ndim == 3
                                 else 0)
            for name in TOABatch._fields})

    slot_param_keys = set(slot_keys)
    if "ecorr_owner" in preps[i0].prep:
        slot_param_keys.add("ecorr_owner")
    prep = {k: np.stack([pr[k] for pr in prep_rows]) for k in prep_rows[0]}
    fields = {name: np.stack([br[name] for br in batch_rows])
              for name in TOABatch._fields}
    params = {}
    for k in preps[0].params0:
        arrs = [np.atleast_1d(_np(p.params0[k])) for p in preps]
        klen = max(a.shape[0] for a in arrs)
        rows_np = []
        for r in layout:
            vals = [_pad_to(arrs[i], (klen,)) for i, _ in r]
            vals += [vals[0]] * (S - len(vals))
            rows_np.append(np.stack(vals))
        out = np.stack(rows_np)  # (R, S, klen)
        if _np(preps[0].params0[k]).ndim == 0:
            out = out[:, :, 0]
        params[k] = out
    row_of = np.zeros(n_psr, dtype=np.int64)
    slot_of = np.zeros(n_psr, dtype=np.int64)
    for rr, r in enumerate(layout):
        for s_i, (i, _) in enumerate(r):
            row_of[i] = rr
            slot_of[i] = s_i
    n_toas = np.array([p.batch.n_toas for p in preps])
    pack = {"width": W, "quantum": Q, "e_quantum": int(e_quantum),
            "n_rows": R, "n_slots": S, "n_epochs": int(NE),
            "row_of": row_of, "slot_of": slot_of,
            "slot_keys": sorted(slot_param_keys)}
    return params, prep, fields, static, n_toas, pack


def pure_phase_fn(template_model, static):
    """(params, batch, prep) -> continuous phase of one pulsar; pure,
    so ``torch.func`` can vmap and differentiate it."""
    delay_comps = template_model.delay_components()
    phase_comps = template_model.phase_components()

    def phase(params, batch, prep):
        full_prep = {**prep, **static}
        d = torch.zeros_like(batch.tdb_sec)
        for c in delay_comps:
            d = d + c.delay(params, batch, full_prep, d)
        ph = torch.zeros_like(d)
        for c in phase_comps:
            ph = ph + c.phase(params, batch, full_prep, d)
        return ph

    return phase


def pure_sigma_fn(template_model, static):
    comps = [c for c in template_model.components.values()
             if getattr(c, "scale_sigma", None) is not None]

    def sigma_us(params, batch, prep):
        s = batch.error_us
        for c in comps:
            s = c.scale_sigma(params, batch, {**prep, **static}, s)
        return s

    return sigma_us


def _tensor_tree(tree):
    """The tensor leaves of a dict (what torch.func.vmap maps over)."""
    return {k: v for k, v in tree.items() if isinstance(v, torch.Tensor)}


def _slot_machinery(pack, shape, params, prep):
    """The packed layout's slot machinery (:meth:`PTABatch._slots`) of
    a batch of (R, W) = ``shape`` rows with pack metadata ``pack``, on
    the given params and prep (their device)."""
    S = int(pack["n_slots"])
    Q = int(pack["quantum"])
    slot_keys = frozenset(pack["slot_keys"])
    R, W = shape
    RS = R * S
    block_slot = prep["_pack_block_slot"]  # (R, W/Q)
    rows = torch.arange(R, device=block_slot.device)[:, None]
    owner = torch.repeat_interleave(block_slot, Q, dim=1)  # (R, W)
    bseg = (rows * S + block_slot).reshape(-1)  # global block segment
    gown = (rows * S + owner).reshape(-1)  # global per-TOA segment
    shared = {k: v for k, v in prep.items()
              if k not in slot_keys and not k.startswith("_pack_")}

    def osum(v):
        # per-TOA values (R*W, ...) -> per-segment sums (R*S, ...)
        return block_segment_sum(v, bseg, RS, Q)

    def slot_env(s):
        ps = {k: v[:, s] for k, v in params.items()}
        full = dict(shared)
        for k in slot_keys:
            full[k] = prep[k][:, s]
        return ps, full

    def combine(parts):
        # slot-major list of (R, W, ...) -> row combination by owner
        out = parts[0]
        for s in range(1, S):
            m = (owner == s).reshape(owner.shape
                                     + (1,) * (parts[s].ndim - 2))
            out = torch.where(m, parts[s], out)
        return out

    def resid(ph, sig, F0):
        # merged (R, W) phase and sigma, (R, S) F0 -> flat (R*W,)
        # residual seconds and sigma, per-segment weighted phase mean
        # removed
        frac = (ph - torch.floor(ph + 0.5)).reshape(-1)
        sig = sig.reshape(-1)
        wts = 1.0 / torch.square(sig)
        frac = frac - (osum(frac * wts) / osum(wts))[gown]
        return frac / F0.reshape(-1)[gown], sig

    return SimpleNamespace(S=S, Q=Q, R=R, W=W, RS=RS, rows=rows,
                           bseg=bseg, gown=gown, osum=osum,
                           slot_env=slot_env, combine=combine,
                           resid=resid)


def _batch_class(cls, mesh, n_psr):
    """``sharded.ShardedBatch`` when ``mesh`` splits ``n_psr`` pulsars
    into more than one non-empty shard, else ``cls``."""
    if cls is not PTABatch or mesh is None:
        return cls
    from .mesh import pulsar_slices

    if len(pulsar_slices(n_psr, mesh.axis_size("pulsar"))) <= 1:
        return cls
    from .sharded import ShardedBatch

    return ShardedBatch


def _mesh_device(mesh, device):
    """The device a batch lives on: the first of ``mesh`` (a 1-D
    "pulsar" mesh; a "toa" axis waits, ROADMAP §1 item 2) when given,
    else ``device``."""
    if mesh is None:
        return resolve_device(device)
    if mesh.axis_size("toa") > 1:
        raise NotImplementedError(
            "PTABatch on a mesh with a 'toa' axis waits with the 2-D "
            "(pulsar, toa) batch (ROADMAP §1 item 2); "
            "toa_shard.sharded_gls_fit shards one pulsar's TOAs")
    return resolve_device(mesh.devices.reshape(-1)[0])


class PTABatch:
    """Batched multi-pulsar GLS fitting; all models share component
    structure (see stack_prepared / stack_packed)."""

    # False when the ranks of a distributed batch disagree on the
    # analytic ECORR path (distributed.assemble_global_batch)
    _ecorr_marg_ok = None

    def __new__(cls, models=(), toas_list=None, pad_toas=None, plan=None,
                device="cuda", mesh=None):
        return object.__new__(_batch_class(cls, mesh, len(models)))

    def __init__(self, models, toas_list, pad_toas=None, plan=None,
                 device="cuda", mesh=None):
        """``plan`` (a shapeplan PlanBucket whose segment indices cover
        models/toas_list exactly once) switches to the segment-packed
        layout. Host packing runs in numpy; the stacked tree then moves
        to ``device`` in one pass. ``mesh`` (a 1-D "pulsar"
        ``mesh.Mesh``) shards the pulsars over its devices instead
        (``sharded.ShardedBatch``); packed plan batches take no mesh, as
        in the JAX package."""
        if plan is not None and mesh is not None:
            raise ValueError("packed plan batches do not support a "
                             "device mesh")
        if plan is not None and pad_toas is not None:
            raise ValueError("pad_toas and plan are mutually exclusive")
        self.device = _mesh_device(mesh, device)
        self.models = models
        self.template = models[0]
        self.preps = [m.prepare(t, device="cpu")
                      for m, t in zip(models, toas_list)]
        self._pack = None
        if plan is not None:
            (params, prep, fields, self.static, self.n_toas,
             self._pack) = stack_packed(self.preps, plan)
        else:
            (params, prep, fields, self.static,
             self.n_toas) = stack_prepared(self.preps, pad_toas=pad_toas)
        self._free_map = list(self.preps[0].free_param_map())
        self.mesh = mesh
        self._to_device(params, prep, fields)

    def _to_device(self, params, prep, fields, device=None):
        dev = self.device if device is None else device
        self.params = {k: torch.as_tensor(np.array(v, np.float64),
                                          dtype=DTYPE, device=dev)
                       for k, v in params.items()}
        self.prep = host_to_device(dict(prep), dev)
        self.batch = TOABatch(**{
            f: torch.as_tensor(np.array(fields[f], np.float64),
                               dtype=DTYPE, device=dev)
            for f in TOABatch._fields})
        self._x0_cache = None
        self._slot_cache = None
        self._fns = {}  # program key -> graphs.Program / GraphProgram
        self._costs = {}  # program key -> its cost record (AOT builds)
        self.diverged = np.zeros(0, dtype=np.int64)
        self.metrics = {}
        self.quality = None  # fitquality bucket summary when enabled

    @property
    def n_pulsars(self):
        if self._pack:
            return int(len(self._pack["row_of"]))
        return int(next(iter(self.params.values())).shape[0])

    def free_map(self):
        """Free-parameter layout of the template (uniform across batch)."""
        return self._free_map

    def pack_state(self):
        """Host-side numpy snapshot of the packed batch, in the JAX
        package's ``PTABatch.pack_state()`` format."""
        state = {
            "params": {k: _np(v) for k, v in self.params.items()},
            "prep": {k: _np(v) for k, v in self.prep.items()},
            "batch": {f: _np(getattr(self.batch, f))
                      for f in TOABatch._fields},
            "static": dict(self.static),
            "n_toas": np.asarray(self.n_toas),
            "free_map": list(self.free_map())}
        if self._pack:
            state["pack"] = dict(self._pack)
        return state

    @classmethod
    def from_packed(cls, template_model, state, device="cuda", mesh=None):
        """Rebuild a PTABatch from a ``pack_state()`` dict — this
        package's or the JAX package's — skipping host TOA prep.
        ``template_model`` provides the component structure. The host
        arrays it keeps are copies, so the state may be read-only views
        (a ``store.PackStore`` hit maps its file); the device tensors are
        copies anyway (``_to_device``). ``mesh`` shards the pulsars as
        in the constructor; a packed state takes none."""
        def own(tree):
            return {k: np.array(v) if isinstance(v, np.ndarray) else v
                    for k, v in tree.items()}

        if "pack" in state and mesh is not None:
            raise ValueError("packed plan batches do not support a "
                             "device mesh")
        n_psr = int(len(state["n_toas"]))
        self = object.__new__(_batch_class(cls, mesh, n_psr))
        self.device = _mesh_device(mesh, device)
        self.models = [template_model] * n_psr
        self.template = template_model
        self.preps = None
        self._pack = own(state["pack"]) if "pack" in state else None
        self._free_map = [tuple(x) for x in state["free_map"]]
        self.static = own(state["static"])
        self.n_toas = np.array(state["n_toas"])
        self.mesh = mesh
        self._to_device(state["params"], state["prep"], state["batch"])
        return self

    def _x0(self):
        """Start vectors from the packed params: (B, k), or (R, S, k)
        for a packed batch."""
        if self._x0_cache is None:
            vals = [self.params[key] if idx is None
                    else self.params[key][..., idx]
                    for (_, key, idx) in self.free_map()]
            self._x0_cache = torch.stack(vals, dim=-1)
        return self._x0_cache

    def _pulsar_vectors(self, x):
        """Per-pulsar vectors (n_psr, n_free) in original order as a
        device tensor in the fit's layout: (B, k), or scattered into
        the (R, S, k) packed start vectors for a packed batch."""
        x = torch.as_tensor(np.asarray(x, np.float64), dtype=DTYPE,
                            device=self.device)
        k = len(self.free_map())
        if tuple(x.shape) != (self.n_pulsars, k):
            raise ValueError(f"parameter vector shape {tuple(x.shape)} != "
                             f"({self.n_pulsars}, {k})")
        if self._pack:
            base = self._x0().clone()
            ro = torch.as_tensor(self._pack["row_of"], device=self.device)
            so = torch.as_tensor(self._pack["slot_of"], device=self.device)
            base[ro, so] = x
            x = base
        return x

    def set_start_vector(self, x):
        """Override the starting parameter vectors for the next fit
        (shape (n_psr, n_free), the layout of the fit results). A
        captured program copies the new vectors into its own input
        buffer at its next dispatch."""
        self._x0_cache = self._pulsar_vectors(x)

    def _pulsar_labels(self):
        """Per-pulsar display labels in original batch order: the PSR
        name when the model has one, the (global) batch index
        otherwise. A distributed batch holds only its rank's models,
        from ``_pulsar_offset`` on."""
        off = getattr(self, "_pulsar_offset", 0)
        return [getattr(m, "PSR", None) and m.PSR.value or f"#{off + i}"
                for i, m in enumerate(self.models)]

    def _record_quality(self, method, handle, x, chi2, covn,
                        relres=None):
        """Fit-quality probes over the finalize's already-pulled host
        arrays (no device interaction: the fit stays bitwise
        identical). dof is the design-matrix count: TOAs minus free
        params minus the offset column; noise amplitudes are
        marginalized, not subtracted."""
        n_free = int(np.asarray(x).shape[1])
        # a distributed batch probes only the rows its rank owns
        off = getattr(self, "_pulsar_offset", 0)
        labels = self._pulsar_labels()
        sl = slice(off, off + len(labels))
        dof = np.asarray(self.n_toas, np.float64).reshape(-1)[sl] - (n_free + 1)
        self.quality = obs_fitq.record_fit_batch(
            labels, np.asarray(chi2)[sl], dof, covn=np.asarray(covn)[sl],
            relres=None if relres is None else np.asarray(relres)[sl],
            method=method, precision=handle.get("precision", "f64"),
            maxiter=handle["maxiter"],
            fell_back=self.__dict__.pop("_fitq_fell_back", False),
            diverged=[i - off for i in self.diverged
                      if 0 <= i - off < len(labels)],
            source="pta." + method)

    def _overlay(self, params, x):
        return _overlay_params(x, params, tuple(self.free_map()))

    def _overlay_fn(self):
        """:meth:`_overlay` as a closure over the free map alone, for
        programs (which hold nothing of the batch that built them)."""
        fmap = tuple(self.free_map())

        def overlay(params, x):
            return _overlay_params(x, params, fmap)

        return overlay

    def _phase_fn(self):
        return pure_phase_fn(self.template, self.static)

    def _sigma_fn(self):
        return pure_sigma_fn(self.template, self.static)

    def _leaves(self):
        """The batch's device data as a program's arguments: (params,
        tensor prep, TOA fields), the tensors :meth:`shape_signature`
        walks. Every program in ``_fns`` computes on the data it is
        called with (``graphs.py``), so a program built on one batch
        runs any batch of the same signature."""
        return self.params, _tensor_tree(self.prep), self.batch

    def _resid_fn(self):
        """(p, batch, prep) -> (residual seconds, sigma us), each (B,
        n): every pulsar's phase residual with its weighted mean
        removed, over F0 — the JAX package's ``_resid_fn`` with the
        pulsar axis written out. Unpacked layout only (see
        :meth:`_slots` for the packed)."""
        vmap = torch.func.vmap
        phase_fn = self._phase_fn()
        sigma_fn = self._sigma_fn()

        def resid(p, batch, prep):
            ph = vmap(phase_fn)(p, batch, prep)
            frac = ph - torch.floor(ph + 0.5)
            sig = vmap(sigma_fn)(p, batch, prep)
            w = 1.0 / torch.square(sig)
            frac = frac - (torch.sum(frac * w, -1) / torch.sum(w, -1))[:, None]
            return frac / p["F"][:, 0, None], sig

        return resid

    def _slots(self):
        """The packed layout's slot machinery, shared by the packed GLS
        program and the GW residuals (:meth:`_gw_eval_packed`): global
        segment ids ``row * S + slot`` per Q-block (``bseg``) and per
        TOA (``gown``), per-segment sums (``osum``), one slot's params
        and prep over every row (``slot_env``), the owner-masked merge
        of per-slot (R, W, ...) evaluations (``combine``) and the
        residual seconds of merged phases (``resid``). Built once per
        batch on its own data (the pack and prep never change); the
        packed program builds it inside ``fit`` on the data it is
        called with (:func:`_slot_machinery`)."""
        if self._slot_cache is None:
            self._slot_cache = _slot_machinery(
                self._pack, tuple(self.batch.tdb_sec.shape), self.params,
                _tensor_tree(self.prep))
        return self._slot_cache

    def _noise_bw_fn(self, exclude_ecorr=False):
        """Pure (params, prep) -> (B, w_us2) of one pulsar, stacking
        every noise component's basis/weight pair; None if there is no
        correlated-noise component. exclude_ecorr skips EcorrNoise (the
        GLS programs marginalize it analytically)."""
        comps = [c for c in self.template.components.values()
                 if getattr(c, "basis_weight", None) is not None
                 and not (exclude_ecorr
                          and type(c).__name__ == "EcorrNoise")]
        if not comps:
            return None
        static = self.static

        def noise_bw(params, prep):
            full = {**prep, **static}
            Bs, ws = [], []
            for c in comps:
                B, w = c.basis_weight(params, full)
                if B.shape[1]:
                    Bs.append(B)
                    ws.append(w)
            if not Bs:
                return None
            return torch.cat(Bs, dim=1), torch.cat(ws)

        return noise_bw

    def _noise_params_free(self):
        """True when a free parameter feeds sigma or a noise basis (the
        hoist guard of both GLS programs)."""
        free_names = {n for n, _, _ in self.free_map()}
        noise = set()
        for c in self.template.components.values():
            if (getattr(c, "basis_weight", None) is not None
                    or getattr(c, "scale_sigma", None) is not None):
                noise.update(c.params)
        return bool(free_names & noise)

    def _marginalize(self, ecorr_mode):
        """True when the ECORR epochs are marginalized analytically:
        ``ecorr_mode="auto"`` on disjoint epochs. ``"dense"``,
        overlapping masks (only the dense U is packed) and zero epochs
        take the dense solve over every basis column instead."""
        if ecorr_mode not in ("auto", "dense"):
            raise ValueError(
                f"ecorr_mode must be 'auto' or 'dense', got {ecorr_mode!r}")
        if ("EcorrNoise" not in self.template.components
                or ecorr_mode == "dense" or self._ecorr_marg_ok is False):
            return False
        return bool("ecorr_eidx" in self.prep
                    and self.prep["ecorr_owner"].shape[-1] > 0)

    def _design_fn(self):
        """(x, p, params, batch, prep) -> (B, n, 1 + k) time design
        matrix of every pulsar: the offset column, then d(phase)/dx /
        F0 by jacfwd."""
        vmap = torch.func.vmap
        phase_fn = self._phase_fn()
        overlay = self._overlay_fn()

        def design(x, p, params, batch, prep):
            def phase_of(xv, ps, b, pr):
                return phase_fn(overlay(ps, xv), b, pr)

            M = vmap(autodiff.jacfwd(phase_of))(x, params, batch, prep)
            M = M / p["F"][:, 0, None, None]
            return torch.cat([torch.ones_like(M[..., :1]), M], dim=-1)

        return design

    # -- the WLS program --

    def _build_wls(self, maxiter=3, threshold=1e-12):
        """(program key, fit(x0, params, prep, batch) -> (x, chi2,
        (covn, norm))) for the whole batch — the JAX package's
        ``_build_wls`` with the pulsar axis written out:
        per iteration the column-normalized whitened SVD step
        (fitter.wls_step, batched) and chi2 at the linearization,
        |rw - Mw dx|^2. Unpacked batches only: the planner gives
        structures without correlated noise singleton rows."""
        if self._pack:
            raise RuntimeError(
                "WLS is not supported on packed plan batches; the "
                "planner gives WLS structures singleton rows "
                "(PTABatch(..., pad_toas=width)) instead")
        resid = self._resid_fn()
        design = self._design_fn()
        overlay = self._overlay_fn()

        def one_step(x, params, prep, batch):
            p = overlay(params, x)
            r, sig = resid(p, batch, prep)
            sigma_s = sig * 1e-6
            Mw = design(x, p, params, batch, prep) / sigma_s[..., None]
            rw = r / sigma_s
            dx, covn, norm = wls_step(Mw, rw, threshold)
            chi2 = torch.sum(torch.square(rw - _mv(Mw, dx)), dim=-1)
            return x - dx[..., 1:], chi2, (covn[..., 1:, 1:], norm[..., 1:])

        def fit(x0, params, prep, batch):
            x = x0
            for _ in range(maxiter):
                x, chi2, cov = one_step(x, params, prep, batch)
            return x, chi2, cov

        return ("wls", maxiter, threshold), fit

    def _dispatch(self, method, key, fit, **opts):
        """Run the bucket's program for ``key`` on this batch's start
        vectors and data WITHOUT pulling its results: the device work is
        queued (a captured program replays its graphs) and a handle
        returns for the finalize. The lazy path installs the eager
        ``fit`` under ``key`` on first use."""
        t0 = time.perf_counter()
        prog = self._fns.setdefault(key, graphs.Program(fit))
        x0 = self._x0()
        return {"method": method, "t0": t0, "replayed": prog.captured,
                "x0": x0, "out": prog(x0, *self._leaves()), **opts}

    def _dispatch_wls(self, maxiter=3, threshold=1e-12):
        """Dispatch the WLS program (see :meth:`_dispatch`); wls_fit ==
        finalize(dispatch)."""
        key, fit = self._build_wls(maxiter, threshold)
        return self._dispatch("wls", key, fit, maxiter=maxiter,
                              threshold=threshold)

    def _pull_rows(self, handle):
        """The finalize's one pull of a dispatched fit: host arrays (x,
        chi2, the program's extra outputs, x0) in per-pulsar order,
        concatenated over the ranks of a distributed batch
        (``distributed.assemble_global_batch``)."""
        x, chi2, rest = handle["out"]
        out = _pull(x, chi2, *rest, handle["x0"])
        if self._pack:
            # gather packed (rows, slots, ...) results back to per-pulsar
            # order before fault injection and divergence isolation
            ro, so = self._pack["row_of"], self._pack["slot_of"]
            out = [a[ro, so] for a in out]
        if getattr(self, "_world", None) is not None:
            from .distributed import gather_rows

            out = gather_rows(out)
        return out

    def _finalize_wls(self, handle):
        """Blocking half of the WLS fit: one pull, divergence isolation,
        metrics."""
        x, chi2, covn, norm, x0 = self._pull_rows(handle)
        cov = covn / (norm[:, :, None] * norm[:, None, :])
        chi2 = self._maybe_inject_divergence(chi2, "wls")
        x, chi2 = self._isolate_diverged(x0, x, chi2)
        self._record_metrics(handle)
        if obs_fitq.enabled():
            self._record_quality("wls", handle, x, chi2, covn)
        else:
            self.quality = None
        return x, chi2, cov

    def wls_fit(self, maxiter=3, threshold=1e-12):
        """Multi-pulsar WLS fit of the whole batch (see _build_wls).

        Returns numpy (x_fit (n_psr, n_free), chi2 (n_psr,), cov
        (n_psr, k, k)); diverged pulsars are reported via self.diverged
        and returned with their starting vectors."""
        return self._finalize_wls(self._dispatch_wls(maxiter, threshold))

    def _record_metrics(self, handle, **extra):
        self.metrics = {"method": handle["method"],
                        "device": str(self.device),
                        "fit_wall_s": time.perf_counter() - handle["t0"],
                        "replayed": handle["replayed"],
                        "maxiter": handle["maxiter"],
                        "n_pulsars": self.n_pulsars,
                        "n_toas_total": int(np.sum(self.n_toas)), **extra}

    def _maybe_inject_divergence(self, chi2, method):
        """Resilience hook: the armed ``solver_diverge`` fault point
        poisons the requested lanes' chi2 with NaN where a real solver
        blow-up would surface (before _isolate_diverged). One falsy
        check when nothing is armed."""
        from ..resilience import faultinject

        fault = faultinject.fire("solver_diverge", method=method)
        if not fault:
            return chi2
        chi2 = np.array(chi2, np.float64)
        for lane in fault.get("lanes", [0]):
            chi2[int(lane) % len(chi2)] = np.nan
        return chi2

    # -- the two GLS programs --

    def _build_gls(self, maxiter=2, threshold=1e-12, ecorr_mode="auto",
                   precision="f64", fused=None):
        """(program key, fit(x0, params, prep, batch) -> (x, chi2,
        (covn, norm, worst relres))) for the whole batch — the JAX
        package's ``_build_gls`` with the pulsar axis written out, keyed
        as it keys its
        executables. ECORR epochs are marginalized analytically
        (per-epoch Sherman-Morrison through segment sums); with every
        noise parameter frozen the x-independent blocks are hoisted out
        of the Gauss-Newton loop. ``ecorr_mode="dense"``, overlapping
        ECORR masks or no ECORR: the dense solve over the parameter and
        every basis column (ECORR's U and the red-noise Fourier
        columns), ``one_step_dense``."""
        if self._pack:
            return self._build_gls_packed(
                maxiter, threshold, ecorr_mode, precision,
                fused=True if fused is None else bool(fused))
        check_precision(precision)
        marginalize = self._marginalize(ecorr_mode)
        hoist = marginalize and not self._noise_params_free()
        vmap = torch.func.vmap
        sigma_fn = self._sigma_fn()
        noise_bw = self._noise_bw_fn(exclude_ecorr=marginalize)
        ecorr = (self.template.components["EcorrNoise"] if marginalize
                 else None)
        static = self.static
        Bn_ = self.batch.tdb_sec.shape[0]
        dev = self.device
        resid = self._resid_fn()
        design = self._design_fn()
        overlay = self._overlay_fn()

        def bases(p, prep):
            if noise_bw is None:
                return None, None
            return vmap(noise_bw)(p, prep)

        def epoch_sums(vals, e_idx, k):
            # (B, W, ...) -> (B, k, ...) per-pulsar epoch sums; rows
            # outside every epoch land in bucket k, dropped
            g = (torch.arange(Bn_, device=dev)[:, None] * (k + 1) + e_idx)
            out = segment_sum(vals.flatten(0, 1), g.reshape(-1),
                              Bn_ * (k + 1))
            return out.reshape((Bn_, k + 1) + vals.shape[2:])[:, :k]

        def epoch_setup(p, a, prep):
            eidx, w_us2 = vmap(lambda pp, pr: ecorr.epoch_index_weight(
                pp, {**pr, **static}))(p, prep)
            k = w_us2.shape[-1]
            e_idx = torch.where((eidx >= 0) & (eidx < k), eidx, k)
            s = epoch_sums(a * a, e_idx, k)
            w_s2 = w_us2 * 1e-12
            return e_idx, k, w_s2 / (1.0 + w_s2 * s)  # w=0 (padding) -> c=0

        def one_step_dense(x, params, prep, batch):
            p = overlay(params, x)
            r, sig = resid(p, batch, prep)
            sigma_s = sig * 1e-6
            Mfull, spi, nparam = stack_noise_bases(
                design(x, p, params, batch, prep), bases(p, prep))
            Mn, norm, q = gls_whiten(Mfull, sigma_s, spi)
            z = r / sigma_s
            A, b, rNr = gls_fused_normal(Mn, z, q, precision)
            if precision == "mixed":
                dxn, covn, relres = gls_eigh_refine(
                    A, b, lambda v: _mtv(Mn, _mv(Mn, v)) + (q * q) * v,
                    threshold)
            else:
                dxn, covn = gls_eigh_solve(A, b, threshold)
                relres = x.new_zeros(Bn_)
            chi2 = rNr - torch.sum(b * dxn, -1)
            return finish(x, dxn / norm, chi2, covn, norm, relres, nparam)

        def one_step_marg(x, params, prep, batch):
            p = overlay(params, x)
            r, sig = resid(p, batch, prep)
            sigma_s = sig * 1e-6
            Mfull, spi, nparam = stack_noise_bases(
                design(x, p, params, batch, prep), bases(p, prep))
            Mn, norm, q = gls_whiten(Mfull, sigma_s, spi)
            z = r / sigma_s
            a = 1.0 / sigma_s
            A0q, b0, rNr = gls_fused_normal(Mn, z, q, precision)
            e_idx, k, c = epoch_setup(p, a, prep)
            G = epoch_sums(Mn * a[..., None], e_idx, k)
            t = epoch_sums(z * a, e_idx, k)
            Gc = torch.sqrt(c)[..., None] * G
            bn = b0 - _mtv(G, c * t)
            rCr = rNr - torch.sum(c * torch.square(t), -1)
            if precision == "mixed":
                Gc32 = Gc.to(torch.float32)
                An = A0q - (Gc32.mT @ Gc32).to(torch.float64)
                dxn, covn, relres = gls_eigh_refine(
                    An, bn, lambda v: (_mtv(Mn, _mv(Mn, v))
                                       - _mtv(Gc, _mv(Gc, v)) + (q * q) * v),
                    threshold)
            else:
                dxn, covn = gls_eigh_solve(A0q - Gc.mT @ Gc, bn, threshold)
                relres = x.new_zeros(Bn_)
            chi2 = rCr - torch.sum(bn * dxn, -1)
            return finish(x, dxn / norm, chi2, covn, norm, relres, nparam)

        def precompute_marg(params, prep, batch):
            # x-independent pieces (sigma, whitened noise basis and its
            # Gram, epoch weights), evaluated at the packed params
            p = params
            sig = vmap(sigma_fn)(p, batch, prep)
            sigma_s = sig * 1e-6
            a = 1.0 / sigma_s
            B, spi_B, _ = stack_noise_bases(
                sigma_s.new_zeros(sigma_s.shape + (0,)), bases(p, prep))
            Bn, normB, qB = gls_whiten(B, sigma_s, spi_B)
            FtF = gls_gram(Bn, torch.zeros_like(qB), precision)
            e_idx, k, c = epoch_setup(p, a, prep)
            sc = torch.sqrt(c)
            GcB = sc[..., None] * epoch_sums(Bn * a[..., None], e_idx, k)
            return dict(sigma_s=sigma_s, a=a, Bn=Bn, qB=qB, normB=normB,
                        FtF=FtF, e_idx=e_idx, k=k, c=c, sc=sc, GcB=GcB,
                        GcBtGcB=GcB.mT @ GcB)

        def one_step_marg_hoisted(x, pre, params, prep, batch):
            p = overlay(params, x)
            r, _ = resid(p, batch, prep)
            sigma_s, a, k = pre["sigma_s"], pre["a"], pre["k"]
            M = design(x, p, params, batch, prep)
            nparam = M.shape[-1]
            Mn_p, normM, _ = gls_whiten(M, sigma_s, M.new_zeros(Bn_, nparam))
            z = r / sigma_s
            aug_p = torch.cat([Mn_p, z[..., None]], dim=-1)
            GpB = aug_p.mT @ pre["Bn"]
            Gpp = aug_p.mT @ aug_p
            b0 = torch.cat([Gpp[:, :nparam, nparam], GpB[:, nparam]], -1)
            rNr = Gpp[:, nparam, nparam]
            Gc_p = pre["sc"][..., None] * epoch_sums(Mn_p * a[..., None],
                                                      pre["e_idx"], k)
            t = epoch_sums(z * a, pre["e_idx"], k)
            ApB = GpB[:, :nparam]
            A0 = torch.cat([torch.cat([Gpp[:, :nparam, :nparam], ApB], -1),
                            torch.cat([ApB.mT, pre["FtF"]], -1)], -2)
            GcX = Gc_p.mT @ pre["GcB"]
            Gct = torch.cat([torch.cat([Gc_p.mT @ Gc_p, GcX], -1),
                             torch.cat([GcX.mT, pre["GcBtGcB"]], -1)], -2)
            q = torch.cat([M.new_zeros(Bn_, nparam), pre["qB"]], -1)
            norm = torch.cat([normM, pre["normB"]], -1)
            sct = pre["sc"] * t
            bn = b0 - torch.cat([_mtv(Gc_p, sct), _mtv(pre["GcB"], sct)], -1)
            rCr = rNr - torch.sum(pre["c"] * torch.square(t), -1)
            An = A0 - Gct + torch.diag_embed(q * q)
            if precision == "mixed":
                def matvec(v):
                    # exact f64 operator through the factored blocks
                    vp, vB = v[:, :nparam], v[:, nparam:]
                    u = _mv(Mn_p, vp) + _mv(pre["Bn"], vB)
                    A0v = torch.cat([_mtv(Mn_p, u), _mtv(pre["Bn"], u)], -1)
                    gv = _mv(Gc_p, vp) + _mv(pre["GcB"], vB)
                    Gcv = torch.cat([_mtv(Gc_p, gv), _mtv(pre["GcB"], gv)], -1)
                    return A0v - Gcv + (q * q) * v

                dxn, covn, relres = gls_eigh_refine(An, bn, matvec, threshold)
            else:
                dxn, covn = gls_eigh_solve(An, bn, threshold)
                relres = x.new_zeros(Bn_)
            chi2 = rCr - torch.sum(bn * dxn, -1)
            return finish(x, dxn / norm, chi2, covn, norm, relres, nparam)

        def finish(x, dx_all, chi2, covn, norm, relres, nparam):
            return (x - dx_all[..., 1:nparam], chi2,
                    (covn[..., 1:nparam, 1:nparam], norm[..., 1:nparam],
                     relres))

        def fit(x0, params, prep, batch):
            x = x0
            worst = x0.new_zeros(Bn_)
            pre = precompute_marg(params, prep, batch) if hoist else None
            for _ in range(maxiter):
                if hoist:
                    x, chi2, (covn, norm, relres) = one_step_marg_hoisted(
                        x, pre, params, prep, batch)
                elif marginalize:
                    x, chi2, (covn, norm, relres) = one_step_marg(
                        x, params, prep, batch)
                else:
                    x, chi2, (covn, norm, relres) = one_step_dense(
                        x, params, prep, batch)
                worst = torch.maximum(worst, relres)
            return x, chi2, (covn, norm, worst)

        return ("gls", maxiter, threshold, marginalize, precision,
                hoist), fit

    def _build_gls_packed(self, maxiter=2, threshold=1e-12,
                          ecorr_mode="auto", precision="f64", fused=True):
        """(program key, fit(x0, params, prep, batch)) for the
        segment-packed layout — the JAX package's ``_build_gls_packed``
        over ALL rows at once: x0 (R, S, k). The slot machinery
        (:func:`_slot_machinery`) is built inside ``fit`` from the prep it
        is given.

        Each slot evaluates phase/design/noise with ITS params over the
        whole row (torch.func.vmap over rows); foreign rows are masked
        out before any reduction. Every per-segment reduction keys on the
        global segment id ``row * S + slot``, so each kernel runs as ONE
        launch over the bucket. ``fused=True`` assembles A0/b0/rNr in
        one pass (kernels/fusedgls.py: the Hopper kernel under
        precision="mixed", the f64 reference otherwise) and hoists the
        x-independent slot work when no noise parameter is free;
        ``fused=False`` is the classic f64 three-pass program. Under
        "mixed" the f32 Grams are only the refinement preconditioner:
        the right-hand sides stay exact f64 segment sums and the
        refinement matvec applies the exact f64 operator.
        """
        check_precision(precision)
        if precision != "f64" and not fused:
            raise ValueError(
                "packed plan batches are f64-only on the classic "
                "(fused=False) path; precision='mixed' needs the "
                "fused kernel program (fused=True)")
        marginalize = self._marginalize(ecorr_mode)
        noise_bw = self._noise_bw_fn(exclude_ecorr=marginalize)
        ecorr = (self.template.components["EcorrNoise"] if marginalize
                 else None)
        hoist = fused and not self._noise_params_free()
        vmap = torch.func.vmap
        phase_fn = self._phase_fn()
        sigma_fn = self._sigma_fn()
        S = int(self._pack["n_slots"])
        Q = int(self._pack["quantum"])
        R, W = self.batch.tdb_sec.shape
        RS = R * S
        Qe = int(self._pack["e_quantum"])
        static = self.static
        overlay = self._overlay_fn()
        pack = {k: self._pack[k] for k in ("n_slots", "quantum",
                                           "slot_keys")}

        def combine_noise(x, sl, batch):
            slot_env, combine = sl.slot_env, sl.combine
            sigs, Bs, spis = [], [], []
            w_ec = None
            for s in range(S):
                ps, full = slot_env(s)
                p = overlay(ps, x[:, s])
                sigs.append(vmap(sigma_fn)(p, batch, full))
                bw = ((vmap(noise_bw)(p, full) if noise_bw is not None
                       else None) or (None, None))
                B_s, spiB_s, _ = stack_noise_bases(
                    batch.tdb_sec.new_zeros((R, W, 0)), bw)
                Bs.append(B_s)
                spis.append(spiB_s)
                if marginalize:
                    _, wec_s = vmap(lambda pp, pr: ecorr.epoch_index_weight(
                        pp, {**pr, **static}))(p, full)
                    # disjoint global epoch spans: the per-slot weight
                    # vectors sum to the row's
                    w_ec = wec_s if w_ec is None else w_ec + wec_s
            return combine(sigs), combine(Bs), torch.stack(spis, 1), w_ec

        def combine_design(x, sl, batch):
            slot_env, combine = sl.slot_env, sl.combine
            phs, Ms, f0s = [], [], []
            for s in range(S):
                ps, full = slot_env(s)
                p = overlay(ps, x[:, s])
                phs.append(vmap(phase_fn)(p, batch, full))

                def phase_of(xv, pp, b, pr):
                    return phase_fn(overlay(pp, xv), b, pr)

                M_s = vmap(autodiff.jacfwd(phase_of))(x[:, s], ps, batch,
                                                        full)
                Ms.append(M_s / p["F"][:, 0, None, None])
                f0s.append(p["F"][:, 0])
            M = combine(Ms)
            M = torch.cat([torch.ones_like(M[..., :1]), M], dim=-1)
            return combine(phs), M, torch.stack(f0s, 1)

        def one_step(x, noise, sl, prep, batch):
            rows, bseg, gown, osum = sl.rows, sl.bseg, sl.gown, sl.osum
            sig, B, spiB, w_ec = noise
            ph, M, F0 = combine_design(x, sl, batch)
            nparam = M.shape[-1]
            Mfull = (torch.cat([M, B], dim=-1) if B.shape[-1] else M)
            K = Mfull.shape[-1]
            Mfull = Mfull.reshape(R * W, K)
            spi = torch.cat([spiB.new_zeros((R, S, nparam)), spiB],
                            dim=-1).reshape(RS, K)
            r, sig = sl.resid(ph, sig, F0)
            sigma_s = sig * 1e-6
            if fused:
                winv = 1.0 / sigma_s
                norm, q = seg_gls_norm(Mfull, sigma_s, spi, gown, RS, Q)
                # pre-normalized raw design: the kernel whitens by the
                # winv column in-tile, so P * winv == Mn up to rounding
                P = Mfull / norm[gown]
                A0, b0, rNr = fused_segment_gls(P, r, winv, bseg, RS, Q,
                                                precision=precision)
                Mn = P * winv[:, None]
                z = r * winv
                if precision == "mixed":
                    # the f32 kernel Gram is only the preconditioner;
                    # the RHS stays exact f64
                    b0 = osum(Mn * z[:, None])
                    rNr = osum(z * z)
            else:
                Mn, norm, q = seg_gls_whiten(Mfull, sigma_s, spi, gown, RS, Q)
                z = r / sigma_s
                b0 = osum(Mn * z[:, None])
                rNr = osum(z * z)
                A0 = segment_gram(Mn, bseg, RS, Q, precision=precision)
            if marginalize:
                a = 1.0 / sigma_s
                NE = w_ec.shape[-1]
                eidx = prep["ecorr_eidx"]  # (R, W) row-global epoch ids
                e_idx = torch.where((eidx >= 0) & (eidx < NE), eidx, NE)
                ge = (rows * (NE + 1) + e_idx).reshape(-1)

                def esum_toa(v):
                    out = segment_sum(v, ge, R * (NE + 1))
                    out = out.reshape((R, NE + 1) + v.shape[1:])[:, :NE]
                    return out.reshape((R * NE,) + v.shape[1:])

                s_e = esum_toa(a * a)
                G = esum_toa(Mn * a[:, None])
                t_e = esum_toa(z * a)
                w_s2 = w_ec.reshape(-1) * 1e-12
                c = w_s2 / (1.0 + w_s2 * s_e)  # w=0 (pad) -> c=0
                Gc = torch.sqrt(c)[:, None] * G
                ebseg = (rows * S + prep["_pack_eblock_slot"]).reshape(-1)
                geown = torch.repeat_interleave(ebseg, Qe)

                def esum(v):
                    return block_segment_sum(v, ebseg, RS, Qe)

                D = segment_gram(Gc, ebseg, RS, Qe, precision=precision)
                bn = b0 - esum((c * t_e)[:, None] * G)
                rCr = rNr - esum(c * torch.square(t_e))
                An = A0 - D + torch.diag_embed(q * q)
            else:
                An = A0 + torch.diag_embed(q * q)
                bn, rCr = b0, rNr
            if precision == "mixed":
                def matvec(v):
                    # exact f64 normal operator for all segments at once
                    # via owner-masked O(n k) products
                    u = torch.sum(Mn * v[gown], dim=1)
                    Av = osum(Mn * u[:, None]) + (q * q) * v
                    if marginalize:
                        gv = torch.sum(Gc * v[geown], dim=1)
                        Av = Av - esum(Gc * gv[:, None])
                    return Av

                dxn, covn, relres = seg_gls_eigh_refine(An, bn, matvec,
                                                        threshold)
            else:
                dxn, covn = gls_eigh_solve(An, bn, threshold)
                relres = bn.new_zeros(RS)
            dx_all = (dxn / norm).reshape(R, S, K)
            chi2 = (rCr - torch.sum(bn * dxn, dim=1)).reshape(R, S)
            return (x - dx_all[..., 1:nparam], chi2,
                    (covn[:, 1:nparam, 1:nparam].reshape(
                        R, S, nparam - 1, nparam - 1),
                     norm[:, 1:nparam].reshape(R, S, nparam - 1),
                     relres.reshape(R, S)))

        def fit(x0, params, prep, batch):
            sl = _slot_machinery(pack, (R, W), params, prep)
            x = x0
            worst = x0.new_zeros((R, S))
            noise = combine_noise(x0, sl, batch) if hoist else None
            for _ in range(maxiter):
                x, chi2, (covn, norm, relres) = one_step(
                    x, noise if hoist else combine_noise(x, sl, batch), sl,
                    prep, batch)
                worst = torch.maximum(worst, relres)
            return x, chi2, (covn, norm, worst)

        return (("gls", maxiter, threshold, marginalize, precision,
                 "packed-fused" if fused else "packed", hoist), fit)

    def gls_fit(self, maxiter=2, threshold=1e-12, ecorr_mode="auto",
                precision="f64", fused=None):
        """Multi-pulsar GLS fit of the whole batch (see _build_gls /
        _build_gls_packed). ``precision="mixed"`` runs the Gram products
        in f32 — the hand-written kernels on a packed batch on the card —
        and recovers f64 accuracy by refinement; if any pulsar's
        refinement fails to contract the batch is refit in f64 with a
        warning. ``precision="auto"`` takes the measured faster mode of
        this bucket structure (:meth:`_resolve_precision`).

        Returns numpy (x_fit (n_psr, n_free), chi2 (n_psr,), cov
        (n_psr, k, k)); diverged pulsars are reported via self.diverged
        and returned with their starting vectors.
        """
        return self._finalize_gls(self._dispatch_gls(
            maxiter, threshold, ecorr_mode, precision, fused=fused))

    def _dispatch_gls(self, maxiter=2, threshold=1e-12, ecorr_mode="auto",
                      precision="f64", fused=None):
        """Dispatch the GLS program (see :meth:`_dispatch`); gls_fit ==
        finalize(dispatch). Resolves precision="auto" first."""
        precision = self._resolve_precision(precision, maxiter, threshold,
                                            ecorr_mode, fused)
        key, fit = self._build_gls(maxiter, threshold, ecorr_mode, precision,
                                   fused=fused)
        return self._dispatch("gls", key, fit, maxiter=maxiter,
                              threshold=threshold, ecorr_mode=ecorr_mode,
                              precision=precision, fused=fused)

    def _finalize_gls(self, handle):
        """Blocking half of the GLS fit: one pull, the mixed->f64 guard,
        divergence isolation, metrics."""
        x, chi2, covn, norm, relres, x0 = self._pull_rows(handle)
        if handle["precision"] == "mixed" and relres_failed(relres):
            # the f32 preconditioner failed to contract for >= 1 pulsar:
            # redo the batch in f64 — correctness first
            warnings.warn(
                f"mixed-precision GLS refinement did not converge "
                f"(max rel resid {float(np.max(relres)):.2e}); "
                "refitting in f64")
            if obs_fitq.enabled():
                # count the fallback at the decision; flag the f64
                # re-run's probes so the ledger shows both
                obs_fitq.FITQ.note_fallback(self._pulsar_labels())
                self._fitq_fell_back = True
            out = self.gls_fit(maxiter=handle["maxiter"],
                               threshold=handle["threshold"],
                               ecorr_mode=handle["ecorr_mode"],
                               precision="f64", fused=handle["fused"])
            self.metrics["refit_f64"] = True
            self.metrics["relres_max"] = float(np.max(relres))
            return out
        cov = covn / (norm[:, :, None] * norm[:, None, :])
        chi2 = self._maybe_inject_divergence(chi2, "gls")
        x, chi2 = self._isolate_diverged(x0, x, chi2)
        self._record_metrics(
            handle, precision=handle["precision"],
            relres_max=float(np.max(relres)) if len(relres) else 0.0,
            refit_f64=False)
        if obs_fitq.enabled():
            self._record_quality("gls", handle, x, chi2, covn,
                                 relres=relres)
        else:
            self.quality = None
        return x, chi2, cov

    @staticmethod
    def _precision_verdict(timings, mixed_failed):
        """The decision rule behind precision="auto": f64 wins when the
        mixed probe's refinement diagnostic failed (a mode that would
        fall back at once is never faster) or when the timed warm run
        says f64 is at least as fast; ties go to f64. Mixed has to earn
        its place with a strictly faster measured run."""
        if mixed_failed:
            return "f64"
        return "f64" if timings["f64"] <= timings["mixed"] else "mixed"

    def _resolve_precision(self, precision, maxiter=2, threshold=1e-12,
                           ecorr_mode="auto", fused=None):
        """Resolve precision="auto" to the measured winner of "f64" and
        "mixed" for this bucket structure: each program runs once to
        warm up and once timed (host clock after a device
        synchronize), and the faster wins unless the mixed run's
        refinement diagnostic failed. The verdict is cached for the
        process, keyed on (structure, shapes, fit options), and kept
        with its timings in ``self.precision_auto``; both programs stay
        in the program table. Explicit "f64" and "mixed" pass through."""
        check_precision(precision, allow_auto=True)
        if precision != "auto":
            return precision
        if self._pack and fused is not None and not fused:
            # the classic packed program is f64-only
            return "f64"
        key = (self.structure_key(self.template), self.shape_signature(),
               maxiter, threshold, ecorr_mode, fused)
        choice = _PRECISION_AUTO_CACHE.get(key)
        if choice is not None:
            return choice
        x0 = self._x0()
        data = self._leaves()
        timings = {}
        mixed_failed = False
        for mode in ("f64", "mixed"):
            pkey, fit = self._build_gls(maxiter, threshold, ecorr_mode, mode,
                                        fused=fused)
            prog = self._fns.setdefault(pkey, graphs.Program(fit))
            out = prog(x0, *data)  # warm-up
            if mode == "mixed":
                mixed_failed = relres_failed(_np(out[2][2]))
            self._sync()
            t0 = time.perf_counter()
            prog(x0, *data)
            self._sync()
            timings[mode] = time.perf_counter() - t0
        choice = _PRECISION_AUTO_CACHE.setdefault(
            key, self._precision_verdict(timings, mixed_failed))
        self.precision_auto = {"choice": choice, "f64_s": timings["f64"],
                               "mixed_s": timings["mixed"],
                               "mixed_relres_failed": mixed_failed}
        return choice

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the program table: build, key, capture --

    def _build_method(self, method, maxiter, threshold, ecorr_mode,
                      precision, fused=None):
        """(program key, fit) of ``method`` with its maxiter default
        (gls: 2, wls: 3), for program_key and aot_lower."""
        if method == "gls":
            maxiter = 2 if maxiter is None else maxiter
            return self._build_gls(maxiter, threshold, ecorr_mode,
                                   precision, fused=fused)
        if method == "wls":
            if precision != "f64":
                raise ValueError(
                    "precision applies to the GLS path only; WLS has "
                    "no mixed-precision mode")
            maxiter = 3 if maxiter is None else maxiter
            return self._build_wls(maxiter, threshold)
        raise ValueError(f"aot_compile: unknown method {method!r}")

    def program_key(self, method="gls", maxiter=None, threshold=1e-12,
                    ecorr_mode="auto", precision="f64", fused=None):
        """The ``_fns`` key the given fit options build: ``key in
        batch._fns`` says whether the program is installed."""
        return self._build_method(method, maxiter, threshold, ecorr_mode,
                                  precision, fused=fused)[0]

    def _program_ready(self, key):
        """True when ``key``'s program needs no capture before its
        dispatch: captured on the card, installed at all on the CPU."""
        prog = self._fns.get(key)
        return prog is not None and (prog.captured
                                     or self.device.type != "cuda")

    def _program_cost(self, method, maxiter, ecorr_mode="auto"):
        """The cost record of this batch's ``method`` program
        (``obs.costmodel.normal_equations_cost``), from its shapes
        alone: its lanes (pulsars, or the R x S segments of a packed
        batch) over every padded TOA row, k = offset + free parameters
        (+ the noise basis columns the GLS solve carries; marginalized
        ECORR epochs are not columns), each input tensor read once and
        x, chi2 and the covariance written once. The same at every
        precision and whichever kernel does the work."""
        from ..obs import costmodel

        if maxiter is None:
            maxiter = 2 if method == "gls" else 3
        n_free = len(self.free_map())
        k = 1 + n_free
        if method == "gls":
            skip_ecorr = self._marginalize(ecorr_mode)
            for c in self.template.components.values():
                if getattr(c, "basis_weight", None) is None or (
                        skip_ecorr and isinstance(c, EcorrNoise)):
                    continue
                k += c.basis_columns(self.prep)
        lanes = (int(self._pack["n_rows"]) * int(self._pack["n_slots"])
                 if self._pack else self.n_pulsars)
        x0 = self._x0()
        in_bytes = x0.numel() * x0.element_size() + sum(
            t.numel() * t.element_size()
            for t in graphs._data_leaves(self._leaves()))
        out_bytes = lanes * (n_free + 1 + n_free * n_free) * 8
        return costmodel.normal_equations_cost(
            self.batch.tdb_sec.numel(), lanes, k, maxiter, in_bytes,
            out_bytes)

    def aot_lower(self, method="gls", maxiter=None, threshold=1e-12,
                  ecorr_mode="auto", precision="f64", fused=None,
                  trace_id=None):
        """Build one fit program without running it
        (``fitter.aot_lower`` times the build; ``trace_id`` joins a
        pool thread's ``aot.trace`` span to its caller's trace) and
        record its cost on it (:meth:`_program_cost`). Returns {key,
        method, lowered, trace_s}; :meth:`_aot_backend_compile`
        captures it."""
        low = fitter.aot_lower(self._build_method, method, maxiter,
                               threshold, ecorr_mode, precision, fused,
                               trace_id=trace_id)
        key, fit = low["lowered"]
        fit.cost = self._program_cost(method, maxiter, ecorr_mode)
        return {"key": key, "method": method, "lowered": fit,
                "trace_s": low["trace_s"]}

    def _aot_backend_compile(self, low):
        """Capture an :meth:`aot_lower` handle at this batch's start
        vectors and data (``fitter.aot_backend_compile``: CUDA graphs on
        the card, the eager program on the CPU), install it in the
        program table, record its cost in ``_costs`` (keyed like
        ``_fns``, for execute-time roofline attribution) and return the
        info dict. Runs on the caller's thread."""
        info = fitter.aot_backend_compile(low["lowered"], self._x0(),
                                          *self._leaves(),
                                          label=str(low["key"]))
        self._fns[low["key"]] = info.pop("compiled")
        self._costs[low["key"]] = {
            "flops": info.get("flops"),
            "bytes_accessed": info.get("bytes_accessed"),
            "memory": info.get("memory")}
        return {"method": low["method"], "trace_s": low["trace_s"], **info}

    def aot_compile(self, method="gls", maxiter=None, threshold=1e-12,
                    ecorr_mode="auto", precision="f64", fused=None):
        """Build and capture one fit program (aot_lower, then
        _aot_backend_compile): the next wls_fit/gls_fit with the same
        options replays it. Returns {trace_s, backend_compile_s, flops,
        bytes_accessed, memory, captured, pieces, ...}; the cost fields
        are the program's recorded counts (:meth:`_program_cost`)."""
        return self._aot_backend_compile(self.aot_lower(
            method, maxiter, threshold, ecorr_mode, precision,
            fused=fused))

    def shape_signature(self):
        """Hashable fingerprint of every array's (shape, dtype) across
        (params, prep, batch): with structure_key, what makes two
        batches run the same programs (ECORR epoch counts and param
        vector lengths that the structure key cannot see)."""
        leaves = ([self.params[k] for k in sorted(self.params)]
                  + [self.prep[k] for k in sorted(self.prep)]
                  + list(self.batch))
        return tuple((tuple(getattr(v, "shape", np.shape(v))),
                      str(getattr(v, "dtype", type(v).__name__)))
                     for v in leaves)

    def _isolate_diverged(self, x0, x, chi2):
        """Per-pulsar fault isolation: a diverged pulsar (non-finite
        chi2 or params) gets its starting vector back and is reported in
        self.diverged; the other pulsars are unaffected."""
        x = np.array(x, np.float64)
        chi2 = np.asarray(chi2, np.float64)
        bad = ~np.isfinite(chi2) | ~np.isfinite(x).all(axis=1)
        self.diverged = np.flatnonzero(bad)
        if bad.any():
            # out-of-rank pulsars of a distributed batch by global index
            off = getattr(self, "_pulsar_offset", 0)
            names = self._pulsar_labels()
            labels = [names[i - off] if 0 <= i - off < len(names)
                      else f"#{i}" for i in self.diverged]
            warnings.warn(
                f"PTA batch: {bad.sum()}/{len(bad)} pulsars diverged "
                f"({labels}); their parameter "
                "vectors were restored to the pre-fit values")
            x[bad] = np.asarray(x0, np.float64)[bad]
        return x, chi2

    # -- GW detection inputs --

    def time_residuals(self):
        """(n_psr, n_toa_max) residual seconds at the batch's params, and
        the (numpy) validity mask. The program is kept in ``_fns`` under
        ``("resid",)`` like the fit programs, eager, and runs on the data
        it is given (a serve slot's cached table reuses it). Unpacked
        batches only, as in the JAX package."""
        if self._pack:
            raise RuntimeError("time_residuals is not supported on packed "
                               "plan batches (serve lanes use regular "
                               "ladder-width batches)")
        key = ("resid",)
        if key not in self._fns:
            resid_fn = self._resid_fn()

            def resid(params, prep, batch):
                return resid_fn(params, batch, prep)[0]

            self._fns[key] = graphs.Program(resid)
        r = self._fns[key](*self._leaves())
        mask = np.arange(r.shape[1])[None, :] < np.asarray(self.n_toas)[:, None]
        return r, mask

    def phases(self):
        """(n_psr, n_toa_max) continuous pulse phase and the validity
        mask — the phase-predict surface of the serve engine (polyco-style
        evaluation at the request's TOAs, through the full timing model).
        Kept in ``_fns`` under ``("phase",)`` like :meth:`time_residuals`.
        Unpacked batches only, as in the JAX package."""
        if self._pack:
            raise RuntimeError("phases is not supported on packed plan "
                               "batches (serve lanes use regular "
                               "ladder-width batches)")
        key = ("phase",)
        if key not in self._fns:
            phase_fn = torch.func.vmap(self._phase_fn())

            def phase(params, prep, batch):
                return phase_fn(params, batch, prep)

            self._fns[key] = graphs.Program(phase)
        ph = self._fns[key](*self._leaves())
        mask = np.arange(ph.shape[1])[None, :] < np.asarray(self.n_toas)[:, None]
        return ph, mask

    def _gw_eval_packed(self, x):
        """Packed-plan half of :meth:`gw_arrays`: scatter the per-pulsar
        fitted vectors x (n_psr, n_free) into the (R, S, k) packed
        layout, then evaluate residual seconds and sigma over every row
        with the packed fit's slot machinery (:meth:`_slots`): per-slot
        evaluation, owner-masked merge, per-segment weighted phase mean.
        Dummy slots own no TOA, so their NaN segment means are never
        read. Returns (R, W) tensors."""
        sl = self._slots()
        vmap = torch.func.vmap
        phase_fn = self._phase_fn()
        sigma_fn = self._sigma_fn()
        xp = self._pulsar_vectors(x)
        phs, sigs, f0s = [], [], []
        for s in range(sl.S):
            ps, full = sl.slot_env(s)
            p = self._overlay(ps, xp[:, s])
            phs.append(vmap(phase_fn)(p, self.batch, full))
            sigs.append(vmap(sigma_fn)(p, self.batch, full))
            f0s.append(p["F"][:, 0])
        r, sig = sl.resid(sl.combine(phs), sl.combine(sigs),
                          torch.stack(f0s, 1))
        return r.reshape(sl.R, sl.W), sig.reshape(sl.R, sl.W)

    def gw_arrays(self, x):
        """Post-fit per-pulsar arrays for the GW detection stage
        (``gw/``): residual seconds evaluated at the FITTED parameter
        vectors ``x`` (n_psr, n_free), per-TOA sigma (us), TDB MJDs and
        the validity mask — all (n_psr, n_toa_max) host numpy in
        original pulsar order, for unpacked and segment-packed batches
        alike (each pulsar's contiguous span is gathered back out of its
        packed row)."""
        n_toas = np.asarray(self.n_toas).reshape(-1)
        mjd = _np(self.batch.tdb_day) + _np(self.batch.tdb_sec) / 86400.0
        with torch.no_grad():
            if self._pack:
                r, sig = self._gw_eval_packed(x)
            else:
                xp = self._pulsar_vectors(x)
                r, sig = self._resid_fn()(self._overlay(self.params, xp),
                                          self.batch, _tensor_tree(self.prep))
        r, sig = _np(r), _np(sig)
        if not self._pack:
            mask = np.arange(r.shape[1])[None, :] < n_toas[:, None]
            return {"resid": r, "sigma_us": sig, "mjd": mjd, "mask": mask}
        Q = int(self._pack["quantum"])
        bs = _np(self.prep["_pack_block_slot"])
        P = len(n_toas)
        n_max = int(n_toas.max())
        out_r = np.zeros((P, n_max))
        out_s = np.ones((P, n_max))
        out_t = np.zeros((P, n_max))
        mask = np.arange(n_max)[None, :] < n_toas[:, None]
        for i, (r0, s0) in enumerate(zip(self._pack["row_of"],
                                         self._pack["slot_of"])):
            # segments are contiguous Q-quantum spans in the row
            start = int(np.flatnonzero(bs[r0] == s0)[0]) * Q
            n = int(n_toas[i])
            sl = slice(start, start + n)
            out_r[i, :n] = r[r0, sl]
            out_s[i, :n] = sig[r0, sl]
            out_t[i, :n] = mjd[r0, sl]
        return {"resid": out_r, "sigma_us": out_s, "mjd": out_t,
                "mask": mask}

    @staticmethod
    def structure_key(model):
        """Hashable model-structure signature: component set, free
        parameters and the par values that become static prep config
        (uniform within a batch, so part of the bucket key)."""
        comps = tuple(sorted(model.components))
        free = tuple(sorted(model.free_params))
        static_cfg = []
        for pname in ("PLANET_SHAPIRO", "ECL", "CORRECT_TROPOSPHERE",
                      "SIFUNC"):
            if pname in model.params:
                static_cfg.append((pname, getattr(model, pname).value))
        # FB-mode vs PB-mode orbits differ in the static orb_mode_fb
        if "FB0" in model.params:
            static_cfg.append(("FB0?", getattr(model, "FB0").value
                               is not None))
        return (comps, free, tuple(static_cfg))


def fleet_aot_compile(jobs, max_workers=None):
    """Build and capture many bucket programs. ``jobs`` is a list of
    (batch, kwargs), kwargs as :meth:`PTABatch.aot_compile` takes them
    (with "method"). The program builds (``aot_lower``, host prep of
    each batch's programs) run in a pool of
    ``max_workers`` threads; the captures then run serially on the
    caller's thread in job order. A capture is host launch work under
    the GIL, like the JAX package's serial trace phase, and captures in
    bucket order keep the shared graph pool's replays in capture order,
    so ``max_workers`` sizes only the build pool. Spans: one
    ``fleet.compile`` (``phase="trace"``) around the builds, whose pool
    threads' ``aot.trace`` spans join its trace, then one
    ``fleet.compile`` (``phase="xla"``) per capture on the caller's
    thread, holding its ``aot.backend_compile``. Returns (infos,
    wall_s): infos in job order, each the aot_compile info dict; wall_s
    the elapsed total, to compare with sum(trace_s +
    backend_compile_s)."""
    t0 = time.perf_counter()
    if not jobs:
        return [], 0.0
    workers = max_workers or min(len(jobs), os.cpu_count() or 1)
    with obs_trace.span("fleet.compile", phase="trace", n_jobs=len(jobs)):
        # pool threads: their aot.trace spans join this trace explicitly
        # (span stacks are thread-local)
        tid = obs_trace.current_trace_id()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            lowered = list(pool.map(
                lambda job: job[0].aot_lower(**job[1], trace_id=tid),
                jobs))
    infos = []
    for (batch, _), low in zip(jobs, lowered):
        with obs_trace.span("fleet.compile", phase="xla",
                            bucket=low["key"][0]) as sp:
            info = batch._aot_backend_compile(low)
            if obs_trace.enabled():
                sp.set(flops=info.get("flops"),
                       bytes_accessed=info.get("bytes_accessed"),
                       intensity_flops_per_byte=info.get(
                           "intensity_flops_per_byte"),
                       roofline_ceiling_flops=info.get(
                           "roofline_ceiling_flops"),
                       bound=info.get("bound"))
        infos.append(info)
    return infos, time.perf_counter() - t0


def fleet_pipeline_metrics(fleet, method="auto", maxiter=3, repeats=2,
                           max_workers=None, **kw):
    """Measured pipeline report for one fleet (the JAX package's keys):

    - fleet_compile_serial_s / fleet_compile_concurrent_s: the sum of
      trace_s + backend_compile_s over the programs that
      :meth:`PTAFleet.precompile` built and captured, and the wall of
      that precompile; None when every program was ready already;
    - fleet_fit_sequential_s / fleet_fit_pipelined_s: best of
      ``repeats`` warm fits through each executor path (host clock
      after a device synchronize);
    - fleet_pipeline_overlap_pct: 100 * (1 - pipelined / sequential);
    - fleet_pipeline_bitwise: the pipelined results identical to the
      sequential ones (np.array_equal on every x, chi2 and cov);
    - fleet_buckets: the number of buckets.
    """
    precision = kw.get("precision", "f64")
    pre_kw = {k: kw[k] for k in ("threshold", "ecorr_mode") if k in kw}
    infos, concurrent_s = fleet.precompile(
        method=method, maxiter=maxiter, max_workers=max_workers,
        precision=precision, **pre_kw)
    if infos:
        serial_s = sum(i["trace_s"] + i["backend_compile_s"] for i in infos)
    else:
        serial_s = concurrent_s = None
    xs_s, chi_s, cov_s = fleet.fit(method=method, maxiter=maxiter,
                                   pipeline=False, **kw)
    xs_p, chi_p, cov_p = fleet.fit(method=method, maxiter=maxiter,
                                   pipeline=True, **kw)
    bitwise = bool(
        np.array_equal(chi_s, chi_p)
        and all(np.array_equal(a, b) for a, b in zip(xs_s, xs_p))
        and all(np.array_equal(a, b) for a, b in zip(cov_s, cov_p)))

    def wall(pipeline):
        sync = (torch.cuda.synchronize if fleet.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        fleet.fit(method=method, maxiter=maxiter, pipeline=pipeline, **kw)
        sync()
        return time.perf_counter() - t0

    seq_s = pipe_s = float("inf")
    for _ in range(max(1, repeats)):
        seq_s = min(seq_s, wall(False))
        pipe_s = min(pipe_s, wall(True))
    return {
        "fleet_compile_serial_s": serial_s,
        "fleet_compile_concurrent_s": concurrent_s,
        "fleet_fit_sequential_s": seq_s,
        "fleet_fit_pipelined_s": pipe_s,
        "fleet_pipeline_overlap_pct": (100.0 * (1.0 - pipe_s / seq_s)
                                       if seq_s > 0 else 0.0),
        "fleet_pipeline_bitwise": bitwise,
        "fleet_buckets": len(fleet.group_indices),
    }


class PTAFleet:
    """Mixed-structure PTA fitting: bucket pulsars by model structure
    (and TOA count), one PTABatch per bucket, fit buckets sequentially
    or through the pipelined executor (``pipeline=True``)."""

    @staticmethod
    def optimal_split_bounds(counts, k):
        """Upper bounds (inclusive pad targets) of the <= k contiguous
        segments over sorted TOA counts that minimize the total padded
        area sum(len(segment) * max(segment)) — an exact O(n^2 k)
        dynamic program (the JAX package's ``optimal_split_bounds``)."""
        c = np.sort(np.asarray(counts, dtype=np.int64))
        n = len(c)
        if n == 0:
            return []
        k = min(int(k), n)  # segments beyond n are useless
        cost = np.full((n + 1, k + 1), np.inf)
        cost[0, 0] = 0.0
        back = np.zeros((n + 1, k + 1), dtype=np.int64)
        for i in range(1, n + 1):
            for j in range(1, k + 1):
                for p in range(i):
                    v = cost[p, j - 1] + (i - p) * c[i - 1]
                    if v < cost[i, j]:
                        cost[i, j] = v
                        back[i, j] = p
        j = int(np.argmin(cost[n, 1:])) + 1
        bounds = []
        i = n
        while j > 0:
            bounds.append(int(c[i - 1]))
            i = int(back[i, j])
            j -= 1
        return sorted(bounds)

    @classmethod
    def plan_groups(cls, models, toas_list, toa_bucket=None,
                    bucket_floor=256, plan_compile_budget=None,
                    plan_max_pack=None, plan_quantum=None,
                    plan_min_width=None):
        """Bucket assignment without building any PTABatch: (groups,
        build_kwargs, plans) — groups maps bucket key -> pulsar indices,
        build_kwargs the PTABatch kwargs (plan= / pad_toas=) a bucket
        needs, plans structure key -> ShapePlan (toa_bucket="plan")."""
        from . import shapeplan

        split_k = None
        if isinstance(toa_bucket, str) and toa_bucket.startswith("split"):
            try:
                split_k = int(toa_bucket[5:])
            except ValueError:
                split_k = 0
            if split_k < 1:
                raise ValueError(f"toa_bucket {toa_bucket!r}: 'split<k>' "
                                 f"needs a positive integer k")
        elif toa_bucket not in (None, "pow2", "plan"):
            raise ValueError(f"toa_bucket must be None, 'pow2', 'plan', "
                             f"or 'split<k>', got {toa_bucket!r}")
        plans, build_kwargs, groups = {}, {}, {}
        if toa_bucket == "plan":
            plan_kw = {}
            if plan_compile_budget is not None:
                plan_kw["compile_budget"] = int(plan_compile_budget)
            if plan_quantum is not None:
                plan_kw["quantum"] = int(plan_quantum)
            if plan_min_width is not None:
                plan_kw["min_width"] = int(plan_min_width)
            max_pack = (int(plan_max_pack) if plan_max_pack is not None
                        else shapeplan.DEFAULT_MAX_PACK)
            by_struct = {}
            for i, m in enumerate(models):
                by_struct.setdefault(PTABatch.structure_key(m), []).append(i)
            for skey, idxs in by_struct.items():
                tmpl = models[idxs[0]]
                # packing needs the per-segment GLS math: structures with
                # no correlated-noise basis get singleton rows
                packable = any(getattr(c, "basis_weight", None) is not None
                               for c in tmpl.components.values())
                plan = shapeplan.plan_shapes(
                    [len(toas_list[i]) for i in idxs],
                    max_pack=max_pack if packable else 1, **plan_kw)
                plans[skey] = plan
                for bucket in plan.buckets:
                    key = (skey, ("plan", bucket.width))
                    groups[key] = [idxs[j] for j in bucket.indices()]
                    if packable and any(len(r.segments) > 1
                                        for r in bucket.rows):
                        build_kwargs[key] = {"plan": bucket.renumbered()}
                    else:
                        build_kwargs[key] = {"pad_toas": bucket.width}
        else:
            split_bounds = {}
            if split_k is not None:
                by_struct = {}
                for m, t in zip(models, toas_list):
                    by_struct.setdefault(PTABatch.structure_key(m),
                                         []).append(len(t))
                split_bounds = {sk: cls.optimal_split_bounds(cs, split_k)
                                for sk, cs in by_struct.items()}
            for i, (m, t) in enumerate(zip(models, toas_list)):
                key = PTABatch.structure_key(m)
                if toa_bucket == "pow2":
                    key = (key, shapeplan.pow2_width(len(t), bucket_floor))
                elif split_k is not None:
                    for b in split_bounds[key]:
                        if len(t) <= b:
                            break
                    key = (key, b)
                groups.setdefault(key, []).append(i)
        return groups, build_kwargs, plans

    def __init__(self, models, toas_list, toa_bucket=None,
                 bucket_floor=256, pipeline=False, plan_compile_budget=None,
                 plan_max_pack=None, plan_quantum=None,
                 plan_min_width=None, store=None, device="cuda", mesh=None):
        """toa_bucket=None groups by model structure only (each batch
        pads to its own max TOA count); "pow2" also buckets pulsars by
        the next power of two >= their TOA count (from
        ``bucket_floor``), capping padding at 2x per pulsar;
        "split<k>" cuts each structure into at most k buckets at the
        thresholds of the minimum-padded-area program
        (:meth:`optimal_split_bounds`); "plan" uses the shape planner
        (shapeplan.plan_shapes), which packs small pulsars several to a
        row. Every bucket's batch lives on ``device``, or is sharded
        over ``mesh`` (a 1-D "pulsar" ``mesh.Mesh``; its first device is
        the fleet's), as in the JAX package: a packed plan bucket takes
        no mesh and raises.

        ``pipeline=True`` defers the bucket builds (host prep, then the
        move to the device) to a worker pool, so they overlap each other
        and whatever the caller does next, and makes :meth:`fit` default
        to the pipelined executor. Results are bitwise those of
        ``pipeline=False``: only the scheduling changes.

        ``store`` (a ``store.PackStore``) short-circuits the host prep:
        each bucket first consults the store under the fleet's content
        signature and, on a verified hit, rebuilds through
        :meth:`PTABatch.from_packed` straight from the mmap'd columns —
        the host chain never runs. Misses (cold store, stale signature,
        corrupt entry) fall back to live prep and write the fresh pack
        state back, so the next bring-up hits. The inline and the
        pipelined build take the same detour, and a store-built fleet
        fits bitwise as the live-built one (the store round-trips
        ``pack_state`` exactly)."""
        self.device = _mesh_device(mesh, device)
        self.mesh = mesh
        groups, build_kwargs, self.plans = self.plan_groups(
            models, toas_list, toa_bucket=toa_bucket,
            bucket_floor=bucket_floor,
            plan_compile_budget=plan_compile_budget,
            plan_max_pack=plan_max_pack, plan_quantum=plan_quantum,
            plan_min_width=plan_min_width)
        self.group_indices = groups
        self.pipeline = bool(pipeline)
        self._lock = threading.RLock()
        self.batches = {}
        self._batch_futures = {}
        self._prep_pool = None
        self.store = store
        self._store_sig = None
        if store is not None:
            from ..store import content_signature

            # one signature for the whole fleet, computed WITHOUT
            # running prep
            self._store_sig = content_signature(
                models, toas_list, plans=self.plans,
                toa_bucket=toa_bucket, bucket_floor=bucket_floor,
                plan_compile_budget=plan_compile_budget,
                plan_max_pack=plan_max_pack, plan_quantum=plan_quantum,
                plan_min_width=plan_min_width)

        def make(key):
            """Store-first bucket build: verified hit -> from_packed,
            else live prep (+ write-back)."""
            idxs = groups[key]
            if store is not None:
                state = store.load(self._store_sig, key)
                # a packed state takes no mesh: that bucket builds live
                # (and raises there, as in the JAX package)
                if state is not None and not ("pack" in state
                                              and mesh is not None):
                    return PTABatch.from_packed(models[idxs[0]], state,
                                                device=self.device,
                                                mesh=mesh)
            batch = PTABatch([models[i] for i in idxs],
                             [toas_list[i] for i in idxs],
                             device=self.device, mesh=mesh,
                             **build_kwargs.get(key, {}))
            if store is not None:
                store.put(self._store_sig, key, batch.pack_state())
            return batch

        if self.pipeline and len(groups) > 1:
            tid = obs_trace.current_trace_id()

            def build(key):
                # pool thread: join the constructor's trace explicitly
                # (span stacks are thread-local)
                with obs_trace.span("fleet.host_prep", trace_id=tid,
                                    bucket=key, n=len(groups[key])):
                    return make(key)

            self._prep_pool = ThreadPoolExecutor(
                max_workers=min(len(groups), os.cpu_count() or 1))
            for key in groups:
                self._batch_futures[key] = self._prep_pool.submit(build, key)
        else:
            for key in groups:
                with obs_trace.span("fleet.host_prep", bucket=key,
                                    n=len(groups[key])):
                    self.batches[key] = make(key)
        self.n = len(models)
        real = sum(len(t) for t in toas_list)
        if toa_bucket == "plan":
            padded = sum(p.padded_area for p in self.plans.values())
        else:
            padded = sum(len(idxs) * max(len(toas_list[i]) for i in idxs)
                         for idxs in groups.values())
        self.padding_ratio = padded / max(real, 1)

    def _resolve(self, key):
        """The bucket's PTABatch, waiting for its deferred build if it
        has not landed yet (the pop and the insert under one lock). The
        wait is the ``fleet.pack`` span; the build itself is the
        worker's ``fleet.host_prep``."""
        with self._lock:
            batch = self.batches.get(key)
            if batch is None:
                with obs_trace.span("fleet.pack", bucket=key):
                    batch = self._batch_futures.pop(key).result()
                self.batches[key] = batch
                if not self._batch_futures and self._prep_pool is not None:
                    self._prep_pool.shutdown(wait=False)
                    self._prep_pool = None
            return batch

    @classmethod
    def from_batches(cls, batches):
        """Wrap already-built PTABatches as a fleet (their device is the
        first one's); pulsar order is the concatenation of the
        batches' rows."""
        fleet = cls.__new__(cls)
        fleet.device = batches[0].device if batches else resolve_device(
            "cpu")
        fleet.mesh = None
        fleet.plans = {}
        fleet.pipeline = False
        fleet._lock = threading.RLock()
        fleet._batch_futures = {}
        fleet._prep_pool = None
        fleet.store = None
        fleet._store_sig = None
        fleet.batches = dict(enumerate(batches))
        fleet.group_indices = {}
        start = 0
        for k, b in fleet.batches.items():
            fleet.group_indices[k] = list(range(start, start + b.n_pulsars))
            start += b.n_pulsars
        fleet.n = start
        real = sum(int(n) for b in batches for n in np.ravel(b.n_toas))
        padded = sum(int(np.prod(b.batch.tdb_sec.shape)) for b in batches)
        fleet.padding_ratio = padded / max(real, 1)
        return fleet

    @staticmethod
    def _use_gls(batch, method):
        if method not in ("auto", "gls", "wls"):
            raise ValueError(f"method must be 'auto', 'gls' or 'wls', "
                             f"got {method!r}")
        return (method == "gls"
                or (method == "auto" and batch._noise_bw_fn() is not None))

    @staticmethod
    def _scatter(xs, chi2s, covs, idxs, x, chi2, cov):
        """One bucket's stacked results into the per-pulsar lists."""
        for j, i in enumerate(idxs):
            xs[i], chi2s[i], covs[i] = x[j], chi2[j], cov[j]

    def fit(self, method="auto", maxiter=3, pipeline=None, max_workers=None,
            **kw):
        """Fit every bucket; returns per-pulsar lists (x, chi2, cov) in
        the original pulsar order. method: "wls", "gls", or "auto" (gls
        when the bucket has correlated-noise components, wls
        otherwise); ``**kw`` goes to the bucket's fit.

        ``pipeline=True`` (default: the fleet's own flag) runs the
        pipelined executor (:meth:`_fit_pipelined`): every bucket's
        program is captured (cold ones, in bucket order, on the card)
        and DISPATCHED before any result is pulled, then the buckets are
        finalized in the sequential path's order, so results —
        fault-injection schedules and mixed->f64 refits included — are
        bitwise those of ``pipeline=False``. ``max_workers`` sizes the
        pool that builds the cold programs (see :func:`fleet_aot_compile`).
        The whole fit is one ``fleet.fit`` span.
        """
        if pipeline is None:
            pipeline = self.pipeline
        with obs_trace.span("fleet.fit", n_psr=self.n,
                            n_buckets=len(self.group_indices),
                            method=method, pipeline=bool(pipeline)):
            if not pipeline:
                return self._fit_sequential(method, maxiter, **kw)
            return self._fit_pipelined(method, maxiter, max_workers, **kw)

    @staticmethod
    def _annotate_execute(sp, batch, use_gls, maxiter, bkw, wall_s,
                          pkey=None):
        """Roofline attribution of one bucket's execute span: look up
        the program's cost record in ``batch._costs`` (recorded when the
        program was built for the AOT split) and attach mfu_pct /
        roofline ceiling / bound on the platform of the batch's device.
        Called only when tracing is enabled; never raises — attribution
        is telemetry, the fit result is not. A program installed lazily
        (no AOT build) has no record and stays unattributed."""
        try:
            from ..obs import costmodel

            if pkey is None:
                pkey = batch.program_key(
                    **PTAFleet._program_options(use_gls, maxiter, bkw))
            cost = getattr(batch, "_costs", {}).get(pkey)
            if not cost:
                return
            attr = costmodel.attribute(
                cost.get("flops"), cost.get("bytes_accessed"),
                wall_s=wall_s, platform=costmodel.platform_of(batch.device))
            sp.set(wall_s=round(wall_s, 6),
                   program=str(pkey),
                   flops=attr["flops"],
                   bytes_accessed=attr["bytes_accessed"],
                   intensity_flops_per_byte=attr[
                       "intensity_flops_per_byte"],
                   roofline_ceiling_flops=attr["roofline_ceiling_flops"],
                   roofline_pct=attr["roofline_pct"],
                   mfu_pct=attr["mfu_pct"],
                   bound=attr["bound"], platform=attr["platform"])
            if attr.get("nominal"):
                sp.set(nominal=True)
        except Exception:
            pass

    def _fit_sequential(self, method, maxiter, **kw):
        xs = [None] * self.n
        chi2s = np.zeros(self.n)
        covs = [None] * self.n
        self.diverged = []
        self.fit_metrics = {}
        self.fit_quality = {}
        for key, idxs in self.group_indices.items():
            batch = self._resolve(key)
            use_gls = self._use_gls(batch, method)
            fit = batch.gls_fit if use_gls else batch.wls_fit
            with obs_trace.span("fleet.execute", bucket=key,
                                n=len(idxs)) as sp:
                traced = obs_trace.enabled()
                t0 = obs_clock.now() if traced else None
                x, chi2, cov = fit(maxiter=maxiter, **kw)
                if traced:
                    # the fit ends with its one pull: the wall covers
                    # the bucket's device work
                    self._annotate_execute(sp, batch, use_gls, maxiter,
                                           kw, obs_clock.now() - t0)
                    if batch.quality:
                        sp.set(**batch.quality)
            self._scatter(xs, chi2s, covs, idxs, x, chi2, cov)
            self.diverged.extend(idxs[j] for j in batch.diverged)
            self.fit_metrics[key] = batch.metrics
            if batch.quality:
                self.fit_quality[key] = batch.quality
        return xs, chi2s, covs

    @staticmethod
    def _program_options(use_gls, maxiter, bkw):
        """aot_compile/program_key options of one bucket's fit."""
        opts = {"method": "gls" if use_gls else "wls", "maxiter": maxiter,
                "threshold": bkw.get("threshold", 1e-12)}
        if use_gls:
            opts.update(ecorr_mode=bkw.get("ecorr_mode", "auto"),
                        precision=bkw.get("precision", "f64"),
                        fused=bkw.get("fused"))
        return opts

    def _fit_pipelined(self, method, maxiter, max_workers, **kw):
        """The pipelined executor, in four steps:

        1. plan: resolve each bucket (waiting for its deferred build),
           validate its kwargs as its fit would (the same TypeError as
           the sequential path, before anything is dispatched), resolve
           ``precision="auto"`` and name its program;
        2. capture the cold programs in bucket order
           (:func:`fleet_aot_compile`; on the card a failed capture
           raises, there is no eager fallback);
        3. dispatch every bucket: each replays its program and returns
           without a pull (the eager eighs between its graphs still wait
           for the device);
        4. finalize in bucket order, the sequential path's, so the
           fault-injection sequence and every result match it bitwise.
        """
        from ..resilience import faultinject

        xs = [None] * self.n
        chi2s = np.zeros(self.n)
        covs = [None] * self.n
        plan = []
        for key, idxs in self.group_indices.items():
            batch = self._resolve(key)
            use_gls = self._use_gls(batch, method)
            bkw = dict(kw)
            allowed = ({"threshold", "ecorr_mode", "precision", "fused"}
                       if use_gls else {"threshold"})
            extra = set(bkw) - allowed
            if extra:
                raise TypeError(
                    f"{'gls' if use_gls else 'wls'}_fit() got unexpected "
                    f"keyword arguments {sorted(extra)}")
            if use_gls and bkw.get("precision") == "auto":
                bkw["precision"] = batch._resolve_precision(
                    "auto", maxiter, bkw.get("threshold", 1e-12),
                    bkw.get("ecorr_mode", "auto"), fused=bkw.get("fused"))
            opts = self._program_options(use_gls, maxiter, bkw)
            plan.append((key, idxs, batch, use_gls, bkw, opts))
        cold = [(key, batch, opts) for key, _, batch, _, _, opts in plan
                if not batch._program_ready(batch.program_key(**opts))]
        infos, _ = fleet_aot_compile([(b, o) for _, b, o in cold],
                                     max_workers=max_workers)
        self.compile_infos = {key: info
                              for (key, _, _), info in zip(cold, infos)}
        handles = []
        for bi, (key, idxs, batch, use_gls, bkw, opts) in enumerate(plan):
            # a straggling device delays THIS bucket's dispatch; the
            # finalize order stays, so results stay bitwise; the
            # payload's "lane" pins which bucket straggles
            fault = faultinject.fire("straggler_delay", bucket=bi)
            if fault and int(fault.get("lane", bi)) == bi:
                time.sleep(float(fault.get("delay_s", 0.0)))
            with obs_trace.span("fleet.dispatch", bucket=bi, n=len(idxs)):
                if use_gls:
                    h = batch._dispatch_gls(
                        maxiter, opts["threshold"], opts["ecorr_mode"],
                        opts["precision"], fused=opts["fused"])
                else:
                    h = batch._dispatch_wls(maxiter, opts["threshold"])
            handles.append((key, idxs, batch, use_gls, h, opts))
        self.diverged = []
        self.fit_metrics = {}
        self.fit_quality = {}
        for key, idxs, batch, use_gls, h, opts in handles:
            fin = batch._finalize_gls if use_gls else batch._finalize_wls
            with obs_trace.span("fleet.execute", bucket=key,
                                n=len(idxs)) as sp:
                x, chi2, cov = fin(h)
                if obs_trace.enabled():
                    # a dispatch only queues (and waits on its eighs):
                    # the wall runs from the bucket's dispatch to the
                    # end of its finalize's pull, so it covers the
                    # bucket's device work (and any wait behind earlier
                    # buckets: the MFU is a lower bound)
                    self._annotate_execute(sp, batch, use_gls, maxiter,
                                           {}, obs_clock.now() - h["t0"],
                                           pkey=batch.program_key(**opts))
                    if batch.quality:
                        sp.set(**batch.quality)
            self._scatter(xs, chi2s, covs, idxs, x, chi2, cov)
            self.diverged.extend(idxs[j] for j in batch.diverged)
            self.fit_metrics[key] = batch.metrics
            if batch.quality:
                self.fit_quality[key] = batch.quality
        return xs, chi2s, covs

    def precompile(self, method="auto", maxiter=3, max_workers=None,
                   threshold=1e-12, ecorr_mode="auto", precision="f64"):
        """Build and capture every bucket's fit program that is not
        ready yet (:func:`fleet_aot_compile`), in bucket order, after
        every deferred build has landed. precision="auto" captures BOTH
        GLS modes per bucket, so the runtime probe and the fit replay
        either way. Returns (infos, wall_s); infos also land in
        self.compile_infos."""
        batches = [(key, self._resolve(key)) for key in self.group_indices]
        jobs = []
        for key, batch in batches:
            if self._use_gls(batch, method):
                modes = (("f64", "mixed") if precision == "auto"
                         else (precision,))
                for mode in modes:
                    kwargs = {"method": "gls", "maxiter": maxiter,
                              "threshold": threshold,
                              "ecorr_mode": ecorr_mode, "precision": mode}
                    if not batch._program_ready(batch.program_key(**kwargs)):
                        jobs.append((batch, kwargs))
            else:
                kwargs = {"method": "wls", "maxiter": maxiter,
                          "threshold": threshold}
                if not batch._program_ready(batch.program_key(**kwargs)):
                    jobs.append((batch, kwargs))
        infos, wall_s = fleet_aot_compile(jobs, max_workers=max_workers)
        self.compile_infos = dict(enumerate(infos))
        return infos, wall_s

    def free_maps(self):
        """Per-pulsar free-parameter maps in original order."""
        out = [None] * self.n
        for key, idxs in self.group_indices.items():
            fmap = self._resolve(key).free_map()
            for i in idxs:
                out[i] = fmap
        return out

    def gw_stage(self, xs=None, method="auto", maxiter=3,
                 lattice_days=30.0, orf="hd", n_scrambles=0,
                 scramble_mode="sky", seed=0, precision="f64",
                 block=256, positions=None, lattice=None, **kw):
        """End-to-end GW detection stage over this fleet (the ``gw/``
        pipeline), on the fleet's device: fit every bucket (skipped when
        the fitted per-pulsar vectors ``xs`` are supplied; ``method``,
        ``maxiter`` and ``**kw`` go to :meth:`fit`), assemble post-fit
        residual/weight arrays and sky positions, regrid onto a common
        ``lattice_days`` epoch lattice, and run the Hellings–Downs
        optimal statistic over all pulsar pairs, its pair products in
        ``precision``. ``n_scrambles > 0`` additionally calibrates
        significance with that many seeded ``scramble_mode`` null draws
        ("sky" or "phase"). ``positions`` (n, 3) overrides model
        astrometry. ``lattice`` (a caller-held GWLattice, e.g. kept
        current by ``gw.regrid_append``) skips the fit/assemble/regrid
        front half. Returns the optimal-statistic dict (amp2 / snr /
        pair sweep stats) plus lattice shape and, when scrambling, the
        ``null`` block with its p-value. The stage is one ``gw.stage``
        span."""
        with obs_trace.span("gw.stage", n_psr=self.n, orf=orf,
                            n_scrambles=n_scrambles,
                            incremental=lattice is not None):
            if lattice is not None:
                lat = lattice
            else:
                if xs is None:
                    xs, _, _ = self.fit(method=method, maxiter=maxiter, **kw)
                inputs = gw.assemble(self, xs, positions=positions)
                lat = gw.regrid(inputs, lattice_days=lattice_days)
            out = gw.optimal_statistic(lat, orf=orf, precision=precision,
                                       block=block, device=self.device)
            out["n_pulsars"] = lat.n_pulsars
            out["n_cells"] = lat.n_cells
            if n_scrambles:
                out["null"] = gw.scramble_null(
                    lat, n_draws=n_scrambles, seed=seed, mode=scramble_mode,
                    orf=orf, precision=precision, block=block,
                    snr_obs=out["snr"], device=self.device)
        return out
