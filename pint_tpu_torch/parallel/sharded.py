"""A PTABatch whose pulsars are split over a "pulsar" mesh, and on a
2-D ("pulsar", "toa") mesh whose TOAs are split too: what
``PTABatch(mesh=)`` and ``PTABatch.from_packed(mesh=)`` build when the
mesh holds more than one non-empty pulsar shard of the batch, or a
"toa" axis of more than one device (the JAX package's
``PTABatch(mesh=)``, one GSPMD program there).

The pulsars are split into contiguous shards (``mesh.pulsar_slices``),
one child batch per mesh row. A fit runs the same program on each
shard and its finalize concatenates the pulled rows in pulsar order,
so the mixed->f64 guard, fault injection, divergence isolation and the
probes (PTABatch's finalize, inherited) see the whole batch. Per-pulsar
fits do not couple, so no reduction crosses pulsar shards. The batch
keeps its stacked host data on the CPU (``pack_state``,
``shape_signature``); its program table holds one program per shard
under each key, so a serve slot's cached table reuses every shard's
program.

On a row of one device the child is an ordinary ``PTABatch``. On a
row of several (the 2-D mesh) it is a :class:`ToaRowBatch`: its
pulsars' padded TOA axis is cut into contiguous blocks, one per device
of the row (the JAX package's rule, ``mesh.py``'s ``shard_batch``: the
per-TOA leaves by their known layout, ``pta._toa_axis``; parameters and
per-column leaves whole on every block; a TOA count that does not
divide gives the first blocks one row more, where the JAX package would
replicate). ``PTABatch``'s unpacked WLS and GLS programs are written
over such block lists (one block for an ordinary batch): per-TOA work
(phase, the ``jacfwd`` design, sigma, the noise bases, the ECORR epoch
index) runs on each block's device, and every cross-TOA reduction is a
per-block partial summed in block order on the first block's device
(``mesh.ordered_sum``/``ordered_max`` through ``toa_shard.py``'s
``weighted_mean`` and ``_global_colnorms``): the weighted phase mean,
the column norms, MᵀN⁻¹M, MᵀN⁻¹r and rᵀN⁻¹r, the ECORR epoch sums and
the red-noise FᵀN⁻¹F. The solve runs there. The batched design is the
phase jacobian over F0 with an offset column, pointwise per TOA, so
the mean's chain rule of ``toa_shard._Shards`` is not needed. WLS over
several blocks keeps its SVD numerics through a QR per block: the SVD
of the R factors stacked in block order has the tall design's singular
values and right vectors, and the stacked Qᵀr the projected residuals
(``fitter.wls_svd_solve``). A row whose blocks share one card (the
logical lanes of a mesh of one device) captures its programs as an
ordinary batch does; a row over several cards runs them eagerly, since
a CUDA graph records one device's stream (``graphs.capturable``).

No kernel lies on this path: K1/K2 run only in packed plan buckets,
which take no mesh (``ValueError``, as in the JAX package).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..toa import TOABatch
from .mesh import Mesh, pulsar_slices
from .pta import PTABatch, _tensor_tree
from .toa_shard import _split


class ShardedBatch(PTABatch):
    """PTABatch over the pulsar shards of ``self.mesh`` (module
    docstring). Only the entry points that touch the device delegate to
    the shards; the rest is PTABatch's."""

    def _to_device(self, params, prep, fields, device=None):
        """Keep the stacked host tree on the CPU and build one child
        batch per shard on its mesh device."""
        super()._to_device(params, prep, fields, device=torch.device("cpu"))
        n_p = self.mesh.axis_size("pulsar")
        self._shard_slices = pulsar_slices(len(np.ravel(self.n_toas)), n_p)
        self._shards = []
        for sl, row in zip(self._shard_slices,
                           self.mesh.devices.reshape(n_p, -1)):
            shard = _row_batch(self.template, row, {
                "params": {k: np.asarray(v)[sl] for k, v in params.items()},
                "prep": {k: v[sl] if isinstance(v, np.ndarray) else v
                         for k, v in prep.items()},
                "batch": {f: np.asarray(fields[f])[sl]
                          for f in TOABatch._fields},
                "static": self.static,
                "n_toas": np.asarray(self.n_toas)[sl],
                "free_map": self._free_map})
            shard.models = self.models[sl]
            self._shards.append(shard)

    def set_start_vector(self, x):
        x = np.asarray(x, np.float64)
        for sl, shard in zip(self._shard_slices, self._shards):
            shard.set_start_vector(x[sl])

    def _on_shards(self, key, call):
        """``call(shard)`` on every shard in order, each with its own
        program under ``key`` from this batch's table (one program per
        shard, installed by the shard's first call); returns the calls'
        results."""
        progs = self._fns.get(key)
        if not isinstance(progs, list):
            progs = [None] * len(self._shards)
        outs = []
        for i, shard in enumerate(self._shards):
            shard._fns = {} if progs[i] is None else {key: progs[i]}
            outs.append(call(shard))
            progs[i] = shard._fns.get(key)
        self._fns[key] = progs
        return outs

    def _dispatch_shards(self, method, key, call, **opts):
        """Every shard's program queued in shard order, one handle per
        shard (:meth:`PTABatch._dispatch`'s handle otherwise)."""
        t0 = time.perf_counter()
        handles = self._on_shards(key, call)
        return {"method": method, "t0": t0,
                "replayed": all(h["replayed"] for h in handles),
                "shards": handles, **opts}

    def _dispatch_wls(self, maxiter=3, threshold=1e-12):
        return self._dispatch_shards(
            "wls", self.program_key("wls", maxiter, threshold),
            lambda s: s._dispatch_wls(maxiter, threshold),
            maxiter=maxiter, threshold=threshold)

    def _dispatch_gls(self, maxiter=2, threshold=1e-12, ecorr_mode="auto",
                      precision="f64", fused=None):
        precision = self._resolve_precision(precision, maxiter, threshold,
                                            ecorr_mode, fused)
        return self._dispatch_shards(
            "gls", self.program_key("gls", maxiter, threshold, ecorr_mode,
                                    precision, fused),
            lambda s: s._dispatch_gls(maxiter, threshold, ecorr_mode,
                                      precision, fused=fused),
            maxiter=maxiter, threshold=threshold, ecorr_mode=ecorr_mode,
            precision=precision, fused=fused)

    def _pull_rows(self, handle):
        parts = [s._pull_rows(h)
                 for s, h in zip(self._shards, handle["shards"])]
        return [np.concatenate(a) for a in zip(*parts)]

    def _resolve_precision(self, precision, maxiter=2, threshold=1e-12,
                           ecorr_mode="auto", fused=None):
        """The first shard's verdict, which every shard runs (same
        structure, same padded widths)."""
        choice = self._shards[0]._resolve_precision(
            precision, maxiter, threshold, ecorr_mode, fused)
        if precision == "auto":
            self.precision_auto = self._shards[0].precision_auto
        return choice

    def program_key(self, method="gls", maxiter=None, threshold=1e-12,
                    ecorr_mode="auto", precision="f64", fused=None):
        return self._shards[0].program_key(method, maxiter, threshold,
                                           ecorr_mode, precision, fused)

    def _program_ready(self, key):
        progs = self._fns.get(key)
        if not isinstance(progs, list):
            return False
        ready = []
        for p, shard in zip(progs, self._shards):
            shard._fns = {} if p is None else {key: p}
            ready.append(shard._program_ready(key))
        return all(ready)

    def aot_lower(self, method="gls", maxiter=None, threshold=1e-12,
                  ecorr_mode="auto", precision="f64", fused=None,
                  trace_id=None):
        lows = [s.aot_lower(method, maxiter, threshold, ecorr_mode,
                            precision, fused, trace_id=trace_id)
                for s in self._shards]
        return {"key": lows[0]["key"], "method": method, "lowered": lows,
                "trace_s": sum(low["trace_s"] for low in lows)}

    def _aot_backend_compile(self, low):
        """One program captured per shard; the info sums their walls and
        counts."""
        infos, progs = [], []
        for shard, low_s in zip(self._shards, low["lowered"]):
            infos.append(shard._aot_backend_compile(low_s))
            progs.append(shard._fns.pop(low_s["key"]))
        self._fns[low["key"]] = progs
        info = dict(infos[0])
        for name in ("trace_s", "backend_compile_s", "flops",
                     "bytes_accessed"):
            if all(i.get(name) is not None for i in infos):
                info[name] = sum(i[name] for i in infos)
        info["captured"] = all(i.get("captured") for i in infos)
        self._costs[low["key"]] = {
            "flops": info.get("flops"),
            "bytes_accessed": info.get("bytes_accessed"),
            "memory": info.get("memory")}
        return info

    def _concat_shards(self, key, method):
        """(values, mask) of an eager per-pulsar program: each shard's
        rows, gathered on the host in pulsar order."""
        outs = self._on_shards(key, method)
        return (torch.cat([v.cpu() for v, _ in outs]),
                np.concatenate([m for _, m in outs]))

    def time_residuals(self):
        return self._concat_shards(("resid",), PTABatch.time_residuals)

    def phases(self):
        return self._concat_shards(("phase",), PTABatch.phases)

    def gw_arrays(self, x):
        x = np.asarray(x, np.float64)
        parts = [s.gw_arrays(x[sl])
                 for sl, s in zip(self._shard_slices, self._shards)]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _row_batch(template, row, state):
    """The child batch of one mesh row: an ordinary PTABatch on a row
    of one device, a :class:`ToaRowBatch` over a row of several."""
    if len(row) == 1:
        return PTABatch.from_packed(template, state, device=row[0])
    return ToaRowBatch.from_packed(template, state,
                                   mesh=Mesh(row, axis_names=("toa",)))


class ToaRowBatch(PTABatch):
    """One pulsar shard of a 2-D mesh: its TOA axis split over the
    devices of ``self.mesh`` (a 1-D "toa" mesh, the row; module
    docstring). The stacked host data stays on the CPU (``pack_state``,
    ``shape_signature``, the cost counts); ``_parts`` holds each block's
    (params, tensor prep, TOA fields) on its device, the programs'
    arguments (``_leaves``: three lists, one entry per block). Start
    vectors and results live on the row's first device."""

    def _to_device(self, params, prep, fields, device=None):
        super()._to_device(params, prep, fields, device=torch.device("cpu"))
        blocks = _split(self.batch, _tensor_tree(self.prep),
                        int(self.batch.tdb_sec.shape[1]),
                        list(self.mesh.devices.reshape(-1)), lead=1,
                        even=False)
        self._parts = [({k: v.to(b.tdb_sec.device)
                         for k, v in self.params.items()}, pr, b)
                       for b, pr in blocks]

    def _leaves(self):
        return tuple(list(leaves) for leaves in zip(*self._parts))

    def _x0(self):
        if self._x0_cache is None:
            self._x0_cache = super()._x0().to(self.device)
        return self._x0_cache

    @staticmethod
    def _block_program(fit):
        """The row's leaves are already block lists."""
        return fit

    def _resid_program(self):
        resid = self._blocks_resid_fn()

        def program(params, prep, batches):
            rows = [r for _, r, _ in resid(None, params, prep, batches)]
            return torch.cat([r.to(rows[0].device) for r in rows], dim=1)

        return program

    def _phase_program(self):
        phase_fn = torch.func.vmap(self._phase_fn())

        def program(params, prep, batches):
            phs = [phase_fn(ps, b, pr)
                   for ps, pr, b in zip(params, prep, batches)]
            return torch.cat([ph.to(phs[0].device) for ph in phs], dim=1)

        return program

    def _gw_eval(self, x):
        blocks = self._blocks_resid_fn()(self._pulsar_vectors(x),
                                      *self._leaves())
        return tuple(torch.cat([a.to(self.device) for a in parts], dim=1)
                     for parts in zip(*[(r, s) for _, r, s in blocks]))
