"""Synchronous in-process serving engine: submit -> micro-batch ->
warm program -> result, with degradation, fault handling, and
per-request telemetry (the JAX package's ``serve/engine.py``).
scripts/pint_serve_bench.py drives it end-to-end; there is deliberately
no network layer — the batching/caching/degradation engine is the part
that transfers to a real serving stack.

Shape stability is the whole game. A flush pads the TOA axis to the
slot's pow2 bucket (PTABatch(pad_toas=...)) and the pulsar/lane axis
to max_batch by replicating the last request's (model, toas), so
every flush of a slot presents the executable cache with identical
shapes, and the slot's program — captured once as CUDA graphs on the
card (``graphs.GraphProgram``), eager on the CPU — runs every later
flush with no new capture. A cached program computes on the batch that
calls it: it copies that batch's tensors into the ones its graphs read
(``graphs.py``), so a warm slot fits the pulsars of the flush at hand,
never those it was captured on. Replicated lanes cost padded FLOPs, not
correctness: lanes are independent and extra-lane results are
discarded; padded TOA rows carry the 1e30-sigma sentinel
(stack_prepared) so they vanish from every whitened reduction.

Fault handling (pint_tpu_torch.resilience) is layered on the same
invariant. Lane independence means a poisoned request can only
corrupt its own lane's numbers, so: (1) non-finite TOA values/errors
are rejected at submit before they reach a slot; (2) a flush that
still produces non-finite per-lane results rejects exactly those
lanes and re-runs the healthy subset on the SAME warm program
(identical padded shapes -> no new capture); (3) a flush that dies with
an exception is retried with jittered backoff when transient, else
bisected so one pathological request cannot fail its co-batched
neighbors; (4) a slot that keeps failing or keeps recompiling trips a
circuit breaker and its traffic gets structured rejections instead of
hanging the engine; (5) everything feeds the HealthMonitor
(healthy -> degraded -> draining) exported via snapshot().

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: device lanes (``devices=``) and ``mesh=`` (§1 item 2,
multi-device); the write-ahead journal, the persisted executable cache,
the pack store and :meth:`ServeEngine.recover` (``durable_dir=``,
``excache_dir=``, ``store_dir=``: item 3's durability queue); the SLO
burn-rate monitor and the drift board (:meth:`attach_slo`,
:meth:`attach_fit_quality`: item 3's observability queue).
"""

from __future__ import annotations

import copy
import os
import threading
import time
import warnings

import numpy as np

from .. import resolve_device
from ..obs import reqlife as obs_reqlife
from ..obs import trace as obs_trace
from ..obs.recorder import RECORDER as _flight
from ..resilience import faultinject
from ..resilience.faultinject import FaultInjected
from ..resilience.health import HealthMonitor
from ..resilience.retry import BackoffPolicy, CircuitBreaker, with_retries
from . import policy
from .batcher import MicroBatcher
from .excache import ExecutableCache
from .metrics import ServeTelemetry
from .request import ServeResult
from .streaming import StreamingRefitter

MULTI_DEVICE_WAITS = ("waits with multi-device (ROADMAP §1 item 2: "
                      "parallel/mesh.py, fleetmesh.DeviceLane)")
DURABILITY_WAITS = ("waits with the durability queue (ROADMAP §1 item 3: "
                    "serve/journal.py, checkpoint.py, recovery.py's "
                    "save/restore, PersistentExecutableCache, "
                    "store/packstore.py)")
OBSERVABILITY_WAITS = ("waits with the observability queue (ROADMAP §1 "
                       "item 3: obs/slo.py's BurnRateMonitor, "
                       "obs/drift.py's DriftBoard)")


class ServeEngine:
    """In-process online timing service over PTABatch programs.

    clock: injectable monotonic-seconds callable (tests drive the
        flush timer, breaker cooldowns, and health transitions
        deterministically with a fake clock).
    sleep: injectable sleep for retry backoff and injected dispatch
        delays (tests pass the fake clock's advance).
    backoff / breaker / health: resilience policies; defaults are
        constructed on the engine's clock.
    device: where every batch and append lane of the engine lives (the
        card unless the caller asks for the CPU).
    """

    def __init__(self, max_batch=8, max_latency_s=0.05, max_queue=256,
                 cache_capacity=32, bucket_floor=256,
                 oversize_toas=policy.DEFAULT_OVERSIZE_TOAS,
                 mesh=None, clock=time.monotonic, sleep=time.sleep,
                 backoff=None, breaker=None, health=None,
                 bisect_depth=4, plan=None, devices=None,
                 durable_dir=None, excache_dir=None, store_dir=None,
                 reqlife=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(f"ServeEngine(mesh=) "
                                      f"{MULTI_DEVICE_WAITS}")
        if devices is not None:
            raise NotImplementedError(f"ServeEngine(devices=) "
                                      f"{MULTI_DEVICE_WAITS}")
        for name, val in (("durable_dir", durable_dir),
                          ("excache_dir", excache_dir),
                          ("store_dir", store_dir)):
            if val is not None:
                raise NotImplementedError(f"ServeEngine({name}=) "
                                          f"{DURABILITY_WAITS}")
        self.device = resolve_device(device)
        self.plan = plan  # optional shapeplan.ShapePlan width ladder
        self.batcher = MicroBatcher(max_batch=max_batch,
                                    max_latency_s=max_latency_s,
                                    bucket_floor=bucket_floor,
                                    plan=plan)
        self.max_queue = int(max_queue)
        self.cache = ExecutableCache(cache_capacity)
        # streaming refit lanes (serve.streaming): registered per
        # pulsar via register_append_lane, consumed by the "append"
        # request kind
        self.streaming = StreamingRefitter(clock=clock, device=self.device)
        self.telemetry = ServeTelemetry()
        self.oversize_toas = oversize_toas
        self.clock = clock
        self._sleep = sleep
        self.backoff = backoff or BackoffPolicy()
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.health = health or HealthMonitor(clock=clock)
        self.bisect_depth = int(bisect_depth)
        self.executables_compiled = 0
        # serializes the engine's own work (flushes, captures,
        # registrations); graphs.py's process lock orders its replays
        # against every other program's (another engine's, a fleet's)
        self._work_mutex = threading.RLock()
        # slot_key -> set of exec_keys seen: a second DISTINCT
        # executable for a slot is an unexpected recompile (shapes are
        # supposed to be pinned), counted and breaker-relevant
        self._slot_exec_keys = {}
        self._slot_recompiles = {}
        # request-lifecycle ledger (obs.reqlife): every submit mints a
        # trace id and records the full state machine. reqlife=None
        # follows PINT_TPU_REQLIFE (on unless "0"), False detaches,
        # and a LifecycleLedger instance gives the engine a private
        # ledger (benches/tests). All ledger work is host-side dict
        # bookkeeping — results stay bitwise identical either way.
        if reqlife is None:
            reqlife = os.environ.get("PINT_TPU_REQLIFE", "1") != "0"
        if reqlife is True:
            self.reqlife = obs_reqlife.REQLIFE
        elif reqlife is False:
            self.reqlife = None
        else:
            self.reqlife = reqlife

    # -- SLO burn-rate and fit-quality monitoring --------------------

    def attach_slo(self, specs=None, registry=None, recorder=None,
                   **slo_kw):
        """The JAX package's dual-window SLO burn-rate monitoring;
        raises: ``obs.slo.BurnRateMonitor`` is not ported yet."""
        raise NotImplementedError(f"ServeEngine.attach_slo "
                                  f"{OBSERVABILITY_WAITS}")

    def slo_check(self, t=None):
        """Ingest the current snapshot into the attached burn-rate
        monitor; None, as no monitor can be attached yet
        (:meth:`attach_slo`)."""
        return None

    def attach_fit_quality(self, board=None, slo=False, registry=None,
                           recorder=None, ledger=None, **board_kw):
        """The JAX package's drift board over committed fit lanes;
        raises: ``obs.drift.DriftBoard`` is not ported yet. The
        fit-quality probes themselves run on every flushed fit once
        ``obs.fitquality.enable()`` is on, and :meth:`snapshot` carries
        their ledger."""
        raise NotImplementedError(f"ServeEngine.attach_fit_quality "
                                  f"{OBSERVABILITY_WAITS}")

    # -- checkpointable engine state ---------------------------------

    STATE_KIND = "ServeEngineState"
    STATE_VERSION = 1

    def state_dict(self):
        """Versioned JSON-safe restartable state. In the JAX package
        that is the drift board's baselines; the port has no drift
        board yet (:meth:`attach_fit_quality`), so ``drift`` is None.
        Telemetry, caches, and programs are rebuildable and
        deliberately not carried."""
        return {"kind": self.STATE_KIND, "version": self.STATE_VERSION,
                "drift": None}

    def load_state_dict(self, state):
        if (state.get("kind") != self.STATE_KIND
                or state.get("version") != self.STATE_VERSION):
            raise ValueError(
                "not a %s v%d state: %r" % (
                    self.STATE_KIND, self.STATE_VERSION,
                    {k: state.get(k) for k in ("kind", "version")}))
        if state.get("drift") is not None:
            self.attach_fit_quality()

    # -- crash recovery ----------------------------------------------

    def recover(self, journal_dir=None, restore_state=True):
        """The JAX package's one-call crash recovery from a durable
        directory; raises: the journal it replays is not ported yet."""
        raise NotImplementedError(f"ServeEngine.recover {DURABILITY_WAITS}")

    # -- intake ------------------------------------------------------

    def _lc(self, req, state, t=None, reason=None, **attrs):
        """One lifecycle transition on the engine's clock (no-op when
        the ledger is detached)."""
        if self.reqlife is not None:
            self.reqlife.transition(
                req.request_id, state,
                t=self.clock() if t is None else t,
                reason=reason, **attrs)

    def submit(self, request):
        """Route one request. Returns a ServeResult handle, filled in
        when its slot flushes; a submit that fills a slot flushes it
        inline, and shed/spilled/rejected requests complete
        immediately."""
        res = ServeResult(request=request)
        now = self.clock()
        trace = None
        if self.reqlife is not None:
            trace = self.reqlife.submitted(
                request.request_id,
                tenant=getattr(request, "tenant", "anon"),
                kind=request.kind, t=now)
        request, fault = self._maybe_corrupt(request, res)
        if self.health.state == "draining":
            return self._reject(request, res, "draining", request.kind,
                                health_state="draining")
        screened = self._screen(request, res, now, trace,
                                injected=fault)
        if screened is None:
            return res
        key, routing = screened
        self._lc(request, "queued", t=now)
        admitted, full, depth = self.batcher.admit_bounded(
            key, request, res, now, max_queue=self.max_queue,
            trace=trace)
        if not admitted:
            # the depth check and the shed decision happen atomically
            # under the batcher's lock (admit_bounded) — two racing
            # submitters cannot both pass a stale depth check and
            # overfill the queue
            self._shed(request, res, "queue_full", kind=routing[0],
                       t=now, trace=trace, queue_depth=depth,
                       max_queue=self.max_queue)
            return res
        if full:
            self._flush(key)
        return res

    def _maybe_corrupt(self, request, res):
        """Intake fault hooks: ``toa_nan`` / ``toa_inf_error`` corrupt
        a deep copy of the request (callers never observe it). Returns
        the (possibly replaced) request and the fired payload."""
        fault = (faultinject.fire("toa_nan",
                                  request_id=request.request_id)
                 or faultinject.fire("toa_inf_error",
                                     request_id=request.request_id))
        if fault:
            request = self._corrupted(request, fault)
            res.request = request
        return request, fault

    def _screen(self, request, res, now, trace, injected=None):
        """Screening shared by the synchronous submit path and the
        async flusher: routing resolution, non-finite input rejection,
        streaming appends, oversize spill, breaker gate. Returns
        ``(slot_key, routing)`` for requests that should join a batch
        slot, or None when ``res`` was completed here (error /
        rejected / spilled / appended)."""
        try:
            routing = policy.resolve(request)
        except ValueError as e:
            res.status = "error"
            res.reason = str(e)
            self.telemetry.incr("errors")
            self.telemetry.record(request_id=request.request_id,
                                  kind=request.kind, status="error",
                                  reason=res.reason,
                                  tenant=getattr(request, "tenant",
                                                 "anon"), trace=trace)
            self.health.note_request("error")
            self._lc(request, "error", reason=res.reason)
            return None
        nv, ne = self._nonfinite_counts(request)
        if nv or ne:
            detail = {"nonfinite_values": nv, "nonfinite_errors": ne}
            if injected:
                detail["injected_point"] = injected["point"]
            self._reject(request, res, "nonfinite_input", routing[0],
                         **detail)
            return None
        if routing[0] == "append":
            # streaming appends execute immediately (never batched —
            # see AppendToasRequest)
            self.telemetry.incr("appends")
            with self._work_mutex:
                self._execute_append(request, res, routing, now,
                                     trace=trace)
            return None
        if policy.is_oversize(len(request.toas), self.oversize_toas):
            self.telemetry.incr("spilled_oversize")
            with self._work_mutex:
                self._execute_solo(request, res, routing, now,
                                   trace=trace)
            return None
        key = self.batcher.slot_key(request, routing)
        if not self.breaker.allow(key):
            self._reject(
                request, res, "circuit_open", routing[0],
                retry_after_s=round(self.breaker.retry_after_s(key), 3))
            return None
        return key, routing

    @staticmethod
    def _nonfinite_counts(request):
        """Non-finite entries in the request's TOA values and
        uncertainties. freq_mhz is deliberately NOT checked — infinite
        frequency is the legitimate encoding of barycentered TOAs."""
        sec = np.asarray(request.toas.sec, dtype=np.float64)
        err = np.asarray(request.toas.error_us, dtype=np.float64)
        nv = int(sec.size - np.count_nonzero(np.isfinite(sec)))
        ne = int(err.size - np.count_nonzero(np.isfinite(err)))
        return nv, ne

    @staticmethod
    def _corrupted(request, fault):
        """Apply a toa_nan / toa_inf_error injection to a DEEP COPY of
        the request's TOAs — callers (and the bench's shared fleet)
        must never observe the corruption."""
        toas = copy.deepcopy(request.toas)
        idx = int(fault.get("index", 0)) % max(1, len(toas))
        if fault["point"] == "toa_nan":
            toas.sec = np.array(toas.sec, dtype=np.float64, copy=True)
            toas.sec[idx] = np.nan
        else:
            toas.error_us = np.array(toas.error_us, dtype=np.float64,
                                     copy=True)
            toas.error_us[idx] = np.inf
        req = copy.copy(request)
        req.toas = toas
        return req

    def _shed(self, req, res, reason, kind=None, t=None, trace=None,
              **detail):
        """Complete ``res`` as a load shed (queue_full, admission
        backpressure/quota/throttle, intake overflow): structured
        rejection payload for the client, telemetry counter
        ``shed_<reason>``, health note, terminal lifecycle record."""
        res.status = "shed"
        res.reason = reason
        res.telemetry = policy.rejection(reason,
                                         request_id=req.request_id,
                                         **detail)
        self.telemetry.incr(f"shed_{reason}")
        self.telemetry.record(request_id=req.request_id, kind=kind,
                              status="shed", reason=reason,
                              tenant=getattr(req, "tenant", "anon"),
                              trace=trace)
        self.health.note_request("shed")
        self._lc(req, "shed", t=t, reason=reason)
        return res

    def _reject(self, req, res, reason, kind=None, **detail):
        """Complete ``res`` as a structured rejection (client keeps a
        machine-readable reason; telemetry and health see it)."""
        res.status = "rejected"
        res.reason = reason
        res.telemetry = policy.rejection(reason,
                                         request_id=req.request_id,
                                         **detail)
        self.telemetry.incr(f"rejected_{reason}")
        self.telemetry.record(request_id=req.request_id, kind=kind,
                              status="rejected", reason=reason,
                              tenant=getattr(req, "tenant", "anon"))
        self.health.note_request("rejected", reason)
        self._lc(req, "rejected", reason=reason)
        return res

    def poll(self, now=None):
        """Flush every slot whose oldest request has aged past the
        max-latency timer; call between submits from a serving loop.
        Returns the flushed slot keys."""
        now = self.clock() if now is None else now
        due = self.batcher.due(now)
        for key in due:
            self._flush(key)
        return due

    def drain(self):
        """Flush everything queued regardless of age (end of
        stream)."""
        for key in self.batcher.pending_keys():
            self._flush(key)

    def run_stream(self, requests, poll_every=1):
        """Convenience driver: submit each request, run the latency
        timer between submits, drain at the end. Returns the
        ServeResults in request order."""
        results = []
        for i, req in enumerate(requests):
            results.append(self.submit(req))
            if poll_every and (i + 1) % poll_every == 0:
                self.poll()
        self.drain()
        return results

    def prewarm(self, requests):
        """Warm-start prefill: run representative requests of the
        most common shapes through the normal flush path (capturing
        their programs into the cache), then reset latency records
        and cache counters so steady-state telemetry starts clean.
        Returns the number of executables compiled."""
        before = self.executables_compiled
        for res in self.run_stream(requests):
            if res.status in ("error", "rejected"):
                raise RuntimeError(f"prewarm request "
                                   f"{res.request.request_id} failed: "
                                   f"{res.reason}")
        self.telemetry.reset()
        self.cache.reset_counters()
        if self.reqlife is not None:
            # steady-state lifecycle accounting starts clean, like the
            # latency records and cache counters above
            self.reqlife.reset()
        return self.executables_compiled - before

    def snapshot(self):
        """JSON-safe service snapshot: telemetry aggregate + cache
        counters + health/breaker state + compile/queue state, the
        lifecycle census, and the fit-quality ledger when the probes
        are on."""
        snap = self.telemetry.snapshot(cache=self.cache,
                                       health=self.health,
                                       breaker=self.breaker)
        snap["executables_compiled"] = self.executables_compiled
        snap["queue_depth"] = self.batcher.depth()
        if self.reqlife is not None:
            snap["reqlife"] = self.reqlife.snapshot()
        from ..obs import fitquality as obs_fitq

        if obs_fitq.enabled():
            fq = obs_fitq.FITQ.snapshot()
            fq.pop("pulsars", None)  # gauge surface stays O(1)
            snap["fit_quality"] = fq
        return snap

    def export_metrics(self, registry=None, prefix="serve."):
        """Absorb this engine's full snapshot — request telemetry,
        cache counters, health, breaker census — into the obs metrics
        registry, from which ``obs.prometheus_text()`` renders one
        service-wide exposition. Pull-model: call at scrape/report
        time; the flush path never pushes."""
        reg = self.telemetry.export_to_registry(
            registry=registry, prefix=prefix, cache=self.cache,
            health=self.health, breaker=self.breaker)
        reg.absorb({"executables_compiled": self.executables_compiled,
                    "queue_depth": self.batcher.depth()}, prefix=prefix)
        if self.reqlife is not None:
            reg.absorb(self.reqlife.snapshot(),
                       prefix=prefix + "reqlife.")
        from ..obs import fitquality as obs_fitq

        if obs_fitq.enabled():
            obs_fitq.export_metrics(registry=reg)
        return reg

    # -- execution ---------------------------------------------------

    def _exec_key(self, slot_key, lanes, pta):
        """Full executable signature. When a shape plan is active its
        stable signature joins the key, so programs built under one
        plan's ladder never collide with another plan's (or the pow2
        ladder's) entries in a shared cache."""
        base = (slot_key, lanes, pta.shape_signature())
        if self.plan is not None:
            return base + (self.plan.signature(),)
        return base

    def _padded_batch(self, bucket, models, toas_list):
        """Lane-padded PTABatch on the engine's device for one slot
        flush: the pulsar/lane axis replicates the last (model, toas)
        up to max_batch — real data, so a padded lane's start vector
        and tensors are never uninitialised memory — and the TOA axis
        pads to the slot's bucket, so every flush of a slot presents
        the executable cache with identical shapes."""
        from ..parallel.pta import PTABatch

        lanes = self.batcher.max_batch
        n = len(models)
        models = models + [models[-1]] * (lanes - n)
        toas_list = toas_list + [toas_list[-1]] * (lanes - n)
        return PTABatch(models, toas_list, pad_toas=bucket,
                        device=self.device)

    def _stage(self, slots):
        """Lane-padded batches and exec keys of the slots whose program
        is not cached yet, for the prewarm paths: ``slots`` is a list of
        (slot_key, bucket, requests); returns (slot_key, exec_key, pta,
        kind, method, maxiter, precision) per cold slot."""
        staged = []
        for slot_key, bucket, reqs in slots:
            _, _, kind, method, maxiter, precision = slot_key
            reqs = reqs[:self.batcher.max_batch]
            pta = self._padded_batch(bucket, [r.model for r in reqs],
                                     [r.toas for r in reqs])
            exec_key = self._exec_key(slot_key, self.batcher.max_batch,
                                      pta)
            if self.cache.lookup(exec_key) is not None:
                continue
            staged.append((slot_key, exec_key, pta, kind, method,
                           maxiter, precision))
        return staged

    def _install(self, staged, max_workers):
        """Capture the staged fit slots' programs through the fleet
        executor's path (``fleet_aot_compile``: builds in a pool, every
        capture serial on this thread — a CUDA graph capture cannot run
        on several threads at once), run the resid/phase slots' eager
        programs once, and prefill the cache under the exec keys the
        lazy flush path would produce."""
        from ..parallel.pta import fleet_aot_compile

        jobs = []
        for _, _, pta, kind, method, maxiter, precision in staged:
            if kind == "fit":
                jobs.append((pta, {"method": method, "maxiter": maxiter,
                                   "precision": precision}))
            elif kind == "resid":
                pta.time_residuals()
            else:  # "phase"
                pta.phases()
        fleet_aot_compile(jobs, max_workers=max_workers)
        self.cache.prefill((exec_key, pta._fns)
                           for _, exec_key, pta, *_ in staged)
        for slot_key, exec_key, *_ in staged:
            self.executables_compiled += 1
            self._slot_exec_keys.setdefault(slot_key, set()).add(exec_key)
        self.telemetry.reset()
        self.cache.reset_counters()

    def prewarm_concurrent(self, requests, max_workers=None):
        """Concurrent prewarm: group representative requests by slot,
        build one lane-padded PTABatch per slot, then capture every fit
        slot's program through the path the fleet executor uses
        (parallel.pta.fleet_aot_compile: program builds in a pool of
        ``max_workers`` threads, the captures serial on the caller's
        thread, as a CUDA graph capture needs) instead of pushing each
        request through a serial flush. resid/phase slots are warmed by
        running their eager programs inline. The programs land in the
        cache under EXACTLY the exec keys the lazy flush path would
        produce — same slot key, same lane padding, same shape
        signature — so steady-state traffic dispatches warm with no new
        capture. Resets telemetry/cache counters like prewarm; returns
        the number of executables compiled."""
        slots = {}
        for req in requests:
            key = self.batcher.slot_key(req, policy.resolve(req))
            slots.setdefault(key, []).append(req)
        before = self.executables_compiled
        with self._work_mutex:
            staged = self._stage([(key, key[1], reqs)
                                  for key, reqs in slots.items()])
            self._install(staged, max_workers)
        return self.executables_compiled - before

    def prewarm_ladder(self, request, max_workers=None):
        """Capture one fit program per planned ladder width from a
        single representative request, so EVERY planned slot shape is
        warm before traffic arrives — not just the widths the prewarm
        sample happened to hit. Requires a shape plan; widths smaller
        than the representative request are skipped (nothing that
        size can pad into them). Returns the number of executables
        compiled; telemetry/cache counters are reset like prewarm."""
        from ..parallel.pta import PTABatch

        if self.plan is None:
            raise ValueError("prewarm_ladder requires a shape plan")
        kind, method, maxiter, precision = policy.resolve(request)
        if kind != "fit":
            raise ValueError("prewarm_ladder warms fit slots; got "
                             f"kind={kind!r}")
        skey = PTABatch.structure_key(request.model)
        before = self.executables_compiled
        with self._work_mutex:
            staged = self._stage([
                ((skey, int(w), kind, method, maxiter, precision), int(w),
                 [request])
                for w in self.plan.widths if w >= len(request.toas)])
            self._install(staged, max_workers)
        return self.executables_compiled - before

    def prefill_from_fleet(self, fleet, method="auto", maxiter=3,
                           precision="f64"):
        """Adopt an offline PTAFleet's already-built bucket program
        tables as serve cache entries, so a service starting next to a
        fleet job inherits its warm programs instead of capturing them
        again.

        An entry can only ever HIT when a flush reproduces the fleet
        batch's exact shapes: the engine's max_batch must equal the
        bucket's lane count and the slot bucket must equal the batch's
        padded TOA width (fleet buckets built with toa_bucket="pow2"
        and the same bucket_floor satisfy the latter by construction —
        the shared serve/batcher.py pow2_bucket convention). Shape
        mismatches just stay cache misses; nothing is ever served from
        a wrong-shape table. A hit runs the fleet's program on the
        flush's own pulsars (``graphs.py``), and the fleet's next fit
        copies its own data back in. Returns the number of entries
        inserted.
        """
        from ..parallel.pta import PTABatch

        entries = []
        for bkey in fleet.group_indices:
            batch = fleet._resolve(bkey)
            if not batch._fns:
                continue  # nothing built for this bucket yet
            use_gls = (method == "gls"
                       or (method == "auto"
                           and batch._noise_bw_fn() is not None))
            mname = "gls" if use_gls else "wls"
            lanes = batch.n_pulsars
            bucket = int(batch.batch.tdb_sec.shape[1])
            slot_key = (PTABatch.structure_key(batch.template), bucket,
                        "fit", mname, maxiter, precision)
            exec_key = (slot_key, lanes, batch.shape_signature())
            entries.append((exec_key, batch._fns))
            self._slot_exec_keys.setdefault(slot_key, set()).add(exec_key)
        return self.cache.prefill(entries)

    def _flush(self, key):
        with self._work_mutex, \
                obs_trace.span("serve.flush", slot=key) as fsp:
            entries = self.batcher.take(key)
            if not entries:
                return
            self.telemetry.incr("flushes")
            now = self.clock()
            # the flush trace id joins each delivered request's
            # lifecycle record to the serve.flush span (tracing on) or
            # at least to its co-flushed neighbors (tracing off)
            flush_trace = (obs_trace.current_trace_id()
                           or obs_trace.TRACER.new_trace_id())
            live = []
            for req, res, t_sub, tr in entries:
                if policy.expired(req, t_sub, now):
                    res.status = "shed"
                    res.reason = "deadline"
                    res.telemetry = policy.rejection(
                        "deadline", waited_s=now - t_sub,
                        deadline_s=req.deadline_s,
                        request_id=req.request_id)
                    self.telemetry.incr("shed_deadline")
                    self.telemetry.record(request_id=req.request_id,
                                          status="shed",
                                          reason="deadline",
                                          queue_wait_s=now - t_sub,
                                          tenant=getattr(req, "tenant",
                                                         "anon"),
                                          trace=tr)
                    self.health.note_request("shed")
                    self._lc(req, "shed", t=now, reason="deadline",
                             queue_wait_s=now - t_sub)
                else:
                    live.append((req, res, t_sub, tr))
            fsp.set(n_live=len(live), shed=len(entries) - len(live))
            if live:
                self._execute(key, live, flush_start=now,
                              flush_trace=flush_trace)
                self.health.note_flush(self.clock() - now)

    def _fail(self, live, kind, exc):
        reason = f"{type(exc).__name__}: {exc}"
        self.telemetry.incr("errors", len(live))
        for req, res, _, tr in live:
            res.status = "error"
            res.reason = reason
            self.telemetry.record(request_id=req.request_id, kind=kind,
                                  status="error", reason=reason,
                                  tenant=getattr(req, "tenant", "anon"),
                                  trace=tr)
            self.health.note_request("error")
            self._lc(req, "error", reason=reason)

    def _on_retry(self, attempt, exc, delay_s):
        self.telemetry.incr("retries")

    def _execute(self, slot_key, live, flush_start, depth=0,
                 flush_trace=None):
        """Fault-handling driver around one batched flush.

        - transient exceptions: retried with jittered backoff;
        - persistent exceptions: batch bisected (down to singletons)
          so only the pathological request(s) fail — then the breaker
          records the failure;
        - poisoned lanes (non-finite per-lane results): rejected with
          a structured reason, healthy subset re-run on the same warm
          program (lane independence + identical padded shapes
          guarantee no new capture and unchanged healthy results).
        """
        kind = slot_key[2]
        try:
            poisoned = with_retries(
                lambda: self._execute_batch(slot_key, live, flush_start,
                                            flush_trace=flush_trace),
                policy=self.backoff, sleep=self._sleep,
                on_retry=self._on_retry,
                trace_id=obs_trace.current_trace_id())
        except Exception as e:
            if len(live) > 1 and depth < self.bisect_depth:
                self.telemetry.incr("flush_bisects")
                _flight.note("serve_bisect", slot=str(slot_key),
                             depth=depth, n=len(live),
                             trace=obs_trace.current_trace_id(),
                             error=type(e).__name__)
                mid = len(live) // 2
                with obs_trace.span("serve.bisect", depth=depth,
                                    n=len(live)):
                    self._execute(slot_key, live[:mid], flush_start,
                                  depth + 1, flush_trace=flush_trace)
                    self._execute(slot_key, live[mid:], flush_start,
                                  depth + 1, flush_trace=flush_trace)
                return
            self._fail(live, kind, e)
            tripped = self.breaker.record_failure(slot_key)
            self.health.note_breakers(self.breaker.open_count(), tripped)
            return
        # don't let a routine success close a breaker that was
        # force-tripped (unexpected recompiles) moments ago
        if self.breaker.state(slot_key) != "open":
            self.breaker.record_success(slot_key)
        self.health.note_breakers(self.breaker.open_count())
        if poisoned:
            healthy = [ent for i, ent in enumerate(live)
                       if i not in poisoned]
            reason = ("solver_diverged" if kind == "fit"
                      else "nonfinite_result")
            for i in sorted(poisoned):
                req, res, _, _ = live[i]
                self.telemetry.incr("quarantined")
                self._reject(req, res, reason, kind, quarantined=True)
            if healthy:
                self._execute(slot_key, healthy, flush_start, depth,
                              flush_trace=flush_trace)

    def _execute_batch(self, slot_key, live, flush_start,
                       flush_trace=None):
        """One attempt at a batched flush. Commits results and returns
        an empty set on success; returns the set of poisoned live-lane
        indices (committing NOTHING) when per-lane results are
        non-finite; raises on structural/capture/dispatch failure."""
        _, bucket, kind, method, maxiter, precision = slot_key
        n_live = len(live)
        lanes = self.batcher.max_batch
        t0 = self.clock()
        with obs_trace.span("serve.pack", bucket=bucket, n=n_live):
            pta = self._padded_batch(
                bucket, [req.model for req, _, _, _ in live],
                [req.toas for req, _, _, _ in live])
        pack_s = self.clock() - t0
        if self.reqlife is not None:
            t_packed = self.clock()
            for req, _, _, _ in live:
                self._lc(req, "packed", t=t_packed)
        exec_key = self._exec_key(slot_key, lanes, pta)
        fns = self.cache.lookup(exec_key)
        cold = fns is None
        compile_s = 0.0
        if cold:
            fault = faultinject.fire("compile_fail", slot=str(slot_key))
            if fault:
                raise FaultInjected("compile_fail",
                                    retryable=fault.get("retryable",
                                                        True),
                                    detail=fault)
            if kind == "fit":
                # capture (on the card) so its cost is attributed to
                # this (cold) flush explicitly instead of smeared into
                # its execute time
                t0 = self.clock()
                with obs_trace.span("serve.compile", bucket=bucket,
                                    method=method):
                    pta.aot_compile(method, maxiter=maxiter,
                                    precision=precision)
                compile_s = self.clock() - t0
            self.executables_compiled += 1
            self.cache.insert(exec_key, pta._fns)
            seen = self._slot_exec_keys.setdefault(slot_key, set())
            if seen and exec_key not in seen:
                # shapes are pinned, so a second distinct executable
                # for a slot means the zero-recompile contract broke
                self.telemetry.incr("unexpected_recompiles")
                n = self._slot_recompiles.get(slot_key, 0) + 1
                self._slot_recompiles[slot_key] = n
                if n >= self.breaker.threshold:
                    tripped = self.breaker.trip(slot_key)
                    self.health.note_breakers(self.breaker.open_count(),
                                              tripped)
            seen.add(exec_key)
        else:
            # the cached table's programs run on this batch's data
            pta._fns = fns
            self._slot_exec_keys.setdefault(slot_key, set()).add(exec_key)

        fault = faultinject.fire("dispatch_slow", slot=str(slot_key))
        if fault:
            self._sleep(float(fault.get("delay_s", 0.25)))

        degraded = False
        t0 = self.clock()
        if self.reqlife is not None:
            for req, _, _, _ in live:
                self._lc(req, "executing", t=t0)
        with obs_trace.span("serve.run", kind=kind,
                            bucket=bucket, cold=cold):
            if kind == "fit":
                # the mixed->f64 fallback warns in the finalize, on the
                # host after the one pull, so a replayed program's
                # fallback is caught here too
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    if method == "gls":
                        x, chi2, cov = pta.gls_fit(maxiter=maxiter,
                                                   precision=precision)
                    else:
                        x, chi2, cov = pta.wls_fit(maxiter=maxiter)
                degraded = policy.mixed_fell_back(caught)
                # the fallback is accounted as degradation; everything
                # else (divergence reports etc.) is re-emitted
                for w in caught:
                    if policy.MIXED_FALLBACK_MARK not in str(w.message):
                        warnings.warn_explicit(w.message, w.category,
                                               w.filename, w.lineno)
                x, chi2, cov = (np.asarray(x), np.asarray(chi2),
                                np.asarray(cov))
                names = [n for n, _, _ in pta.free_map()]
                diverged = set(pta.diverged)
                poisoned = {i for i in range(n_live)
                            if i in diverged
                            or not (np.all(np.isfinite(x[i]))
                                    and np.isfinite(chi2[i]))}

                def value_of(i):
                    return {"x": x[i], "chi2": float(chi2[i]),
                            "cov": cov[i], "free_names": names}
            elif kind == "resid":
                r, _ = pta.time_residuals()
                r = r.cpu().numpy()
                poisoned = {i for i in range(n_live)
                            if not np.all(np.isfinite(
                                r[i, :len(live[i][0].toas)]))}

                def value_of(i):
                    return {"resid_s": r[i, :len(live[i][0].toas)]}
            else:  # "phase" (policy.resolve rejected everything else)
                ph, _ = pta.phases()
                ph = ph.cpu().numpy()
                poisoned = {i for i in range(n_live)
                            if not np.all(np.isfinite(
                                ph[i, :len(live[i][0].toas)]))}

                def value_of(i):
                    return {"phase": ph[i, :len(live[i][0].toas)]}
        execute_s = self.clock() - t0
        if poisoned:
            return poisoned
        if degraded:
            self.telemetry.incr("degraded_mixed", n_live)
        done = self.clock()
        for i, (req, res, t_sub, tr) in enumerate(live):
            res.status = "ok"
            res.value = value_of(i)
            rec = {"request_id": req.request_id, "kind": kind,
                   "status": res.status, "reason": res.reason,
                   "queue_wait_s": flush_start - t_sub,
                   "pack_s": pack_s, "compile_s": compile_s,
                   "execute_s": execute_s, "total_s": done - t_sub,
                   "lanes": lanes, "bucket": bucket, "cold": cold,
                   "degraded": degraded, "spilled": False,
                   "tenant": getattr(req, "tenant", "anon"),
                   "trace": tr}
            res.telemetry = rec
            self.telemetry.record(**rec)
            self.health.note_request("ok")
            self._lc(req, "delivered", t=done,
                     queue_wait_s=rec["queue_wait_s"],
                     execute_s=execute_s, bucket=bucket, cold=cold,
                     flush_trace=flush_trace)
        return set()

    def _execute_solo(self, request, res, routing, submitted_at,
                      trace=None):
        """Oversize spill: run unbatched, padded to the request's own
        TOA count (no bucket), so one monster request can't force a
        huge shared program shape. Runs eagerly (nothing is captured
        for a one-off shape) — acceptable because spills are the rare
        tail by construction."""
        from ..parallel.pta import PTABatch

        kind, method, maxiter, precision = routing
        live = [(request, res, submitted_at, trace)]
        t0 = self.clock()
        try:
            # deliberately unpadded: the spill path trades a per-shape
            # build for not inflating the shared bucket boundary
            pta = PTABatch([request.model], [request.toas],
                           device=self.device)
            pack_s = self.clock() - t0
            self._lc(request, "packed")
            degraded = False
            t0 = self.clock()
            self._lc(request, "executing", t=t0)
            if kind == "fit":
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    if method == "gls":
                        x, chi2, cov = pta.gls_fit(maxiter=maxiter,
                                                   precision=precision)
                    else:
                        x, chi2, cov = pta.wls_fit(maxiter=maxiter)
                degraded = policy.mixed_fell_back(caught)
                value = {"x": np.asarray(x)[0],
                         "chi2": float(np.asarray(chi2)[0]),
                         "cov": np.asarray(cov)[0],
                         "free_names": [n for n, _, _ in pta.free_map()]}
            elif kind == "resid":
                r, _ = pta.time_residuals()
                value = {"resid_s": r.cpu().numpy()[0, :len(request.toas)]}
            else:
                ph, _ = pta.phases()
                value = {"phase": ph.cpu().numpy()[0, :len(request.toas)]}
        except Exception as e:
            self._fail(live, kind, e)
            return
        execute_s = self.clock() - t0
        if degraded:
            self.telemetry.incr("degraded_mixed")
        res.status = "ok"
        res.value = value
        done = self.clock()
        rec = {"request_id": request.request_id, "kind": kind,
               "status": "ok", "reason": None, "queue_wait_s": 0.0,
               "pack_s": pack_s, "compile_s": None,
               "execute_s": execute_s,
               "total_s": done - submitted_at,
               "lanes": 1, "bucket": None, "cold": True,
               "degraded": degraded, "spilled": True,
               "tenant": getattr(request, "tenant", "anon"),
               "trace": trace}
        res.telemetry = rec
        self.telemetry.record(**rec)
        self.health.note_request("ok")
        self._lc(request, "delivered", t=done, queue_wait_s=0.0,
                 execute_s=execute_s, spilled=True)

    def register_append_lane(self, model, toas, precision="f64",
                             sentinel=None, prewarm=True):
        """Register one streaming append lane (serve.streaming) for
        ``model`` over its base TOA table, on the engine's device.
        ``prewarm`` is the JAX package's delta-store staging flag; the
        engine has no delta store yet (``store_dir=``), so there is
        nothing to stage. Returns the lane key."""
        with self._work_mutex:
            return self.streaming.register(model, toas,
                                           precision=precision,
                                           sentinel=sentinel)

    def _execute_append(self, request, res, routing, submitted_at,
                        trace=None):
        """Execute one streaming append: fold the request's TOAs into
        its registered lane, solve from the updated cached factor (K1′
        on the card for a mixed lane). Escalations (drift alarm, solver
        divergence, correlated-noise lanes) complete the request with a
        full-refit value and are counted — the lane is quarantined and
        rebuilt, not the request rejected."""
        from .streaming import lane_key as streaming_lane_key

        kind = routing[0]
        t0 = self.clock()
        self._lc(request, "executing", t=t0)
        try:
            value = self.streaming.append(request.model, request.toas,
                                          rid=request.request_id)
        except KeyError:
            self._reject(request, res, "lane_unregistered", kind,
                         lane=streaming_lane_key(request.model))
            return
        except Exception as e:
            self._fail([(request, res, submitted_at, trace)], kind, e)
            return
        execute_s = self.clock() - t0
        if value.get("escalated"):
            self.telemetry.incr("append_escalated")
            if value.get("escalation_reason") == "solver_diverge":
                self.telemetry.incr("quarantined")
        if value.get("replayed"):
            self.telemetry.incr("append_replayed")
        res.status = "ok"
        res.value = value
        done = self.clock()
        rec = {"request_id": request.request_id, "kind": kind,
               "status": "ok", "reason": None, "queue_wait_s": 0.0,
               "pack_s": 0.0, "compile_s": None,
               "execute_s": execute_s,
               "total_s": done - submitted_at,
               "lanes": 1, "bucket": None, "cold": False,
               "degraded": bool(value.get("escalated")),
               "spilled": False,
               "tenant": getattr(request, "tenant", "anon"),
               "trace": trace}
        res.telemetry = rec
        self.telemetry.record(**rec)
        self.health.note_request("ok")
        self._lc(request, "delivered", t=done, queue_wait_s=0.0,
                 execute_s=execute_s,
                 escalated=bool(value.get("escalated")))
