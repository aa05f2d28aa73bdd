"""A PTABatch whose pulsars are split over a 1-D "pulsar" mesh: what
``PTABatch(mesh=)`` and ``PTABatch.from_packed(mesh=)`` build when the
mesh holds more than one non-empty shard of the batch (the JAX
package's ``PTABatch(mesh=)``, one sharded program there).

The pulsars are split into contiguous shards (``mesh.pulsar_slices``),
one unsharded child ``PTABatch`` per mesh device. A fit runs the same
program on each shard and its finalize concatenates the pulled rows in
pulsar order, so the mixed->f64 guard, fault injection, divergence
isolation and the probes (PTABatch's finalize, inherited) see the whole
batch. Per-pulsar fits do not couple, so no reduction crosses shards.
The batch keeps its stacked host data on the CPU (``pack_state``,
``shape_signature``); its program table holds one program per shard
under each key, so a serve slot's cached table reuses every shard's
program.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..toa import TOABatch
from .mesh import pulsar_slices
from .pta import PTABatch


class ShardedBatch(PTABatch):
    """PTABatch over the pulsar shards of ``self.mesh`` (module
    docstring). Only the entry points that touch the device delegate to
    the shards; the rest is PTABatch's."""

    def _to_device(self, params, prep, fields, device=None):
        """Keep the stacked host tree on the CPU and build one child
        batch per shard on its mesh device."""
        super()._to_device(params, prep, fields, device=torch.device("cpu"))
        self._shard_slices = pulsar_slices(len(np.ravel(self.n_toas)),
                                           self.mesh.axis_size("pulsar"))
        self._shards = []
        for sl, dev in zip(self._shard_slices, self.mesh.devices.reshape(-1)):
            shard = PTABatch.from_packed(self.template, {
                "params": {k: np.asarray(v)[sl] for k, v in params.items()},
                "prep": {k: v[sl] if isinstance(v, np.ndarray) else v
                         for k, v in prep.items()},
                "batch": {f: np.asarray(fields[f])[sl]
                          for f in TOABatch._fields},
                "static": self.static,
                "n_toas": np.asarray(self.n_toas)[sl],
                "free_map": self._free_map}, device=dev)
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
        return isinstance(progs, list) and all(
            p is not None and (p.captured or s.device.type != "cuda")
            for p, s in zip(progs, self._shards))

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
