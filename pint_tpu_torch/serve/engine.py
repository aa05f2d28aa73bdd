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

Crash safety (``durable_dir=``): every accepted request is journaled
before it becomes visible to a flush (serve/journal.py, a CRC-framed
write-ahead log with one fsync per flush), every terminal outcome is
committed to the same log, and :meth:`ServeEngine.recover` of a fresh
process returns the committed results from the log and re-runs the
pending ones, bitwise as the dead process would have. The persisted
executable tier (``excache_dir=``, serve/excache.py) re-captures the
warm program tables before the first lookup, and the pack store and
the append-delta store (``store_dir=``) let a restarted process skip
the host chain. The named ``process_kill`` sites of
resilience/faultinject.py (``intake_append``, ``pre_commit``,
``mid_commit``, ``post_commit``, ``excache_store``, ``store_write``,
``append_delta_write``, ``flusher_take``) are where the SIGKILL matrix
of scripts/pint_serve_bench.py kills it.

Monitoring is opt-in and host-side: :meth:`attach_slo` feeds the
engine's snapshots to a dual-window burn-rate monitor (obs.slo), and
:meth:`attach_fit_quality` turns the fit-quality probes on and feeds
every committed fit lane to a drift board (obs.drift), whose baselines
ride :meth:`state_dict`. Neither touches a lane's numbers: a monitored
stream is bitwise the unmonitored one.

Multi-device: ``devices=`` makes each entry a
``parallel.fleetmesh.DeviceLane`` failure domain with its own health and
breaker. A slot routes to a lane by a crc32 of its key (stable across
processes), its batch is built on that lane's device, programs and the
zero-recapture contract are tracked per (slot, lane), and a lane lost to
``device_loss`` is quarantined and sheds its slots onto the next alive
lane, with a ``device_lost`` flight dump. ``mesh=`` (a 1-D "pulsar"
``parallel.mesh.Mesh``) shards every flush's lanes over the mesh's
devices (``PTABatch(mesh=)``) and puts the append lanes on its first
device. Entries may repeat a device: logical lanes on one card.
"""

from __future__ import annotations

import copy
import os
import threading
import time
import zlib

import numpy as np

from ..obs import reqlife as obs_reqlife
from ..obs import trace as obs_trace
from ..obs.recorder import RECORDER as _flight
from ..resilience import faultinject
from ..resilience.faultinject import FaultInjected
from ..resilience.health import HealthMonitor
from ..resilience.retry import BackoffPolicy, CircuitBreaker, with_retries
from . import policy
from .batcher import MicroBatcher
from .excache import ExecutableCache, PersistentExecutableCache
from .journal import RequestJournal
from .metrics import ServeTelemetry
from .request import ServeResult, ensure_request_counter_above
from .streaming import StreamingRefitter, lane_key as streaming_lane_key

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
    devices: optional device list; each becomes a DeviceLane (module
        docstring). devices=None keeps the single-device engine.
    mesh: optional 1-D "pulsar" mesh the flushes' lanes shard over;
        its first device replaces ``device``.
    durable_dir: opts in to crash safety — the write-ahead journal
        (``journal.log``), the persisted executable tier (``excache/``),
        the pack store (``store/``, with the append-delta store in
        ``store/deltas``) and the save/restore_serve_state snapshot
        (``state/``) all live under it, so :meth:`recover` of a fresh
        process needs exactly one path. ``excache_dir`` / ``store_dir``
        override those two locations (several processes may share warm
        programs while keeping private journals).
    """

    def __init__(self, max_batch=8, max_latency_s=0.05, max_queue=256,
                 cache_capacity=32, bucket_floor=256,
                 oversize_toas=policy.DEFAULT_OVERSIZE_TOAS,
                 mesh=None, clock=time.monotonic, sleep=time.sleep,
                 backoff=None, breaker=None, health=None,
                 bisect_depth=4, plan=None, devices=None,
                 durable_dir=None, excache_dir=None, store_dir=None,
                 reqlife=None, device="cuda"):
        from ..parallel.pta import _mesh_device

        self.mesh = mesh
        self.device = _mesh_device(mesh, device)
        self.plan = plan  # optional shapeplan.ShapePlan width ladder
        self.batcher = MicroBatcher(max_batch=max_batch,
                                    max_latency_s=max_latency_s,
                                    bucket_floor=bucket_floor,
                                    plan=plan)
        self.max_queue = int(max_queue)
        self.durable_dir = (None if durable_dir is None
                            else os.fspath(durable_dir))
        self.journal = (None if self.durable_dir is None
                        else RequestJournal(self.durable_dir))
        if excache_dir is None and self.durable_dir is not None:
            excache_dir = os.path.join(self.durable_dir, "excache")
        persistent = (None if excache_dir is None
                      else PersistentExecutableCache(excache_dir,
                                                     device=self.device))
        self.cache = ExecutableCache(cache_capacity,
                                     persistent=persistent)
        if persistent is not None:
            # re-capture the persisted program tables on a background
            # thread while the process does the rest of its bring-up:
            # by the first lookup the capture is (mostly) paid
            persistent.prewarm()
        # packed-TOA store: a restarted process rebuilds its batches
        # from mmap'd columns instead of re-running the host chain; its
        # CRC prewarm runs on its own thread, overlapping the re-capture
        if store_dir is None and self.durable_dir is not None:
            store_dir = os.path.join(self.durable_dir, "store")
        if store_dir is None:
            self.store = self.deltas = None
        else:
            from ..store import DeltaStore, PackStore

            self.store = PackStore(store_dir)
            self.store.prewarm()
            # append-delta segments live BESIDE the pack store (a
            # subdirectory its *.ptpk scan never sees)
            self.deltas = DeltaStore(os.path.join(store_dir, "deltas"))
        # streaming refit lanes (serve.streaming): registered per
        # pulsar via register_append_lane, consumed by the "append"
        # request kind; crash-persistent with a delta store
        self.streaming = StreamingRefitter(deltas=self.deltas, clock=clock,
                                           device=self.device, mesh=mesh)
        self.telemetry = ServeTelemetry()
        self.oversize_toas = oversize_toas
        self.clock = clock
        self._sleep = sleep
        self.backoff = backoff or BackoffPolicy()
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.health = health or HealthMonitor(clock=clock)
        self.bisect_depth = int(bisect_depth)
        self.executables_compiled = 0
        self.device_lanes = None
        if devices is not None:
            from ..parallel.fleetmesh import DeviceLane

            self.device_lanes = [DeviceLane(i, d, clock=clock)
                                 for i, d in enumerate(devices)]
        # serializes the engine's own work (flushes, captures,
        # registrations); graphs.py's process lock orders its replays
        # against every other program's (another engine's, a fleet's)
        self._work_mutex = threading.RLock()
        # slot_key -> set of exec_keys seen: a second DISTINCT
        # executable for a slot is an unexpected recompile (shapes are
        # supposed to be pinned), counted and breaker-relevant. With
        # device lanes the tracking key is (slot_key, lane_index): a
        # slot legitimately captures once per lane it lands on (a steal
        # after a device loss included), and only a second program on
        # the SAME lane breaks the contract.
        self._slot_exec_keys = {}
        self._slot_recompiles = {}
        self._slo_monitor = None  # attach_slo() opt-in
        self._fitq_board = None  # attach_fit_quality() opt-in
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

    # -- SLO burn-rate monitoring ------------------------------------

    def attach_slo(self, specs=None, registry=None, recorder=None,
                   **slo_kw):
        """Opt in to dual-window SLO burn-rate monitoring (obs.slo):
        every :meth:`export_metrics` (and explicit :meth:`slo_check`)
        feeds the engine snapshot to a BurnRateMonitor on this
        engine's clock; alert transitions flow through the flight
        recorder and the ``slo.*`` gauges ride the same Prometheus
        exposition as the serve counters. Returns the monitor."""
        from ..obs import slo as obs_slo

        self._slo_monitor = obs_slo.BurnRateMonitor(
            specs=(specs if specs is not None
                   else obs_slo.serve_slos(**slo_kw)),
            clock=self.clock, registry=registry, recorder=recorder)
        return self._slo_monitor

    def slo_check(self, t=None):
        """Ingest the current snapshot into the attached burn-rate
        monitor (no-op without attach_slo). Returns the per-SLO state
        list, or None when monitoring is not attached. The snapshot is
        taken before the monitor's lock: no engine or graph lock is
        ever held under it."""
        if self._slo_monitor is None:
            return None
        return self._slo_monitor.ingest(self.snapshot(), t=t)

    # -- fit-quality / drift monitoring ------------------------------

    def attach_fit_quality(self, board=None, slo=False, registry=None,
                           recorder=None, ledger=None, **board_kw):
        """Opt in to numerical-health monitoring: enables the
        fit-quality probes (obs.fitquality — every flushed fit then
        records chi2 z-scores, conditioning, and fallback flags in
        the process ledger) and feeds each committed fit lane's
        parameters/uncertainties/reduced-chi2 to a
        :class:`obs.drift.DriftBoard` across successive refits, so a
        drifting pulsar raises a ``fit_anomaly`` flight dump naming
        the probe and its baseline. With ``slo=True`` the fit_quality
        SLO pack joins the attached BurnRateMonitor (attaching one
        with the serve defaults first when none exists). The board's
        baselines ride :meth:`state_dict` checkpoints. Returns the
        board."""
        from ..obs import drift as obs_drift
        from ..obs import fitquality as obs_fitq

        obs_fitq.enable()
        self._fitq_board = (board if board is not None
                            else obs_drift.DriftBoard(
                                ledger=ledger, recorder=recorder,
                                **board_kw))
        if slo:
            if self._slo_monitor is None:
                self.attach_slo(registry=registry, recorder=recorder)
            self._slo_monitor.add_specs(obs_fitq.fit_quality_slos())
        return self._fitq_board

    @staticmethod
    def _fit_label(req):
        """Drift-series identity for one request's pulsar: the PSR
        name when the model carries one (successive refits of the same
        pulsar must land on the same sentinel), else the request id."""
        psr = getattr(req.model, "PSR", None)
        return getattr(psr, "value", None) or f"req:{req.request_id}"

    # -- checkpointable engine state ---------------------------------

    STATE_KIND = "ServeEngineState"
    STATE_VERSION = 1

    def state_dict(self):
        """Versioned JSON-safe restartable state: the drift board's
        per-(pulsar, probe) EWMA baselines (None without a board) —
        telemetry, caches, and programs are rebuildable and
        deliberately not carried. See obs.drift for the re-anchor
        contract (no alarm storm after a restore)."""
        return {"kind": self.STATE_KIND, "version": self.STATE_VERSION,
                "drift": (None if self._fitq_board is None
                          else self._fitq_board.state_dict())}

    def load_state_dict(self, state):
        if (state.get("kind") != self.STATE_KIND
                or state.get("version") != self.STATE_VERSION):
            raise ValueError(
                "not a %s v%d state: %r" % (
                    self.STATE_KIND, self.STATE_VERSION,
                    {k: state.get(k) for k in ("kind", "version")}))
        drift_state = state.get("drift")
        if drift_state is not None:
            if self._fitq_board is None:
                self.attach_fit_quality()
            self._fitq_board.load_state_dict(drift_state)

    # -- crash recovery ----------------------------------------------

    def recover(self, journal_dir=None, restore_state=True):
        """One-call crash recovery from a durable directory.

        Replays the write-ahead journal of a dead process: committed
        requests are returned as-is from their journal records (their
        results are NEVER re-emitted through the serve path), every
        uncommitted intake is re-submitted and re-run — bitwise as the
        dead process would have delivered it, because lanes are
        independent and the padded shapes are pinned — and the
        durable-state snapshot (breaker/health/fit-quality, see
        serve.recovery) is restored first so policy decisions resume
        where they stopped. The persisted executable tier makes the
        re-runs warm: their programs were re-captured during bring-up.

        Idempotent: a second recover() finds everything committed and
        replays nothing. Returns a report dict with ``committed`` (rid
        -> journal commit record), ``replayed`` (rid -> ServeResult),
        counts, ``torn_truncated`` bytes, and the replay wall.
        """
        if journal_dir is not None:
            journal_dir = os.fspath(journal_dir)
            if self.journal is None \
                    or self.journal.directory != journal_dir:
                self.durable_dir = journal_dir
                self.journal = RequestJournal(journal_dir)
                if self.cache.persistent is None:
                    self.cache.persistent = PersistentExecutableCache(
                        os.path.join(journal_dir, "excache"),
                        device=self.device)
                    self.cache.persistent.prewarm()
        if self.journal is None:
            raise ValueError("no journal to recover from: construct "
                             "the engine with durable_dir= or pass "
                             "journal_dir")
        t0 = self.clock()
        with obs_trace.span("serve.recover") as sp:
            rep = self.journal.replay()
            state_restored = False
            if restore_state:
                from .recovery import restore_serve_state

                state_restored = restore_serve_state(
                    self, self.durable_dir) is not None
            # fresh ids in this process must not collide with replayed
            # ones minted by the dead process
            max_id = -1
            for rec in rep.records:
                rid = rec.get("rid")
                if isinstance(rid, str) and rid.startswith("req-"):
                    try:
                        max_id = max(max_id, int(rid[4:]))
                    except ValueError:
                        pass
            if max_id >= 0:
                ensure_request_counter_above(max_id)
            self.journal.record_marker(
                "recover", n_committed=len(rep.committed),
                n_pending=len(rep.pending),
                torn_truncated=rep.torn_truncated)
            if self.reqlife is not None:
                # journal returns are terminal without touching the
                # serve path: ledger them as replayed_committed so
                # post-crash accounting separates them from live fits
                t_rec = self.clock()
                for rid, crec in rep.committed.items():
                    tele = (crec.get("telemetry")
                            if isinstance(crec, dict) else None) or {}
                    self.reqlife.submitted(
                        rid, tenant=tele.get("tenant", "anon"),
                        kind=tele.get("kind"), t=t_rec)
                    self.reqlife.transition(rid, "replayed_committed",
                                            t=t_rec)
            replayed = {}
            for rec in rep.pending:
                # pre-mark the id so every terminal outcome of the
                # replay — including a synchronous rejection — writes
                # a commit record and the request can't replay forever
                self.journal.note_intake(rec["rid"])
                if self.reqlife is not None:
                    req = rec["req"]
                    self.reqlife.submitted(
                        rec["rid"],
                        tenant=getattr(req, "tenant", "anon"),
                        kind=getattr(req, "kind", None),
                        t=self.clock())
                    # non-terminal marker: submit() re-anchors the
                    # machine and runs it to a live terminal state
                    self.reqlife.transition(rec["rid"], "re_executed",
                                            t=self.clock())
                replayed[rec["rid"]] = self.submit(rec["req"])
            self.drain()
            self.journal.sync()
            wall = self.clock() - t0
            sp.set(n_committed=len(rep.committed),
                   n_replayed=len(replayed),
                   torn_truncated=rep.torn_truncated,
                   state_restored=state_restored)
        _flight.dump("crash_recovery", source="serve",
                     journal_dir=self.journal.directory,
                     n_committed=len(rep.committed),
                     n_replayed=len(replayed),
                     torn_truncated=rep.torn_truncated,
                     state_restored=state_restored,
                     replay_wall_s=round(wall, 3),
                     trace=obs_trace.current_trace_id())
        return {"committed": rep.committed, "replayed": replayed,
                "n_committed": len(rep.committed),
                "n_replayed": len(replayed),
                "torn_truncated": rep.torn_truncated,
                "state_restored": state_restored,
                "replay_wall_s": wall}

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
        if self.journal is not None:
            # buffered WAL append BEFORE the queue admit: once the
            # entry is visible in a slot, a concurrent submitter's
            # inline flush may commit it immediately, and a commit
            # whose intake never reached the log would replay a
            # delivered request after a crash
            self.journal.record_intake(request)
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
            self._commit(request, res)
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
            self._commit(request, res)  # no-op unless intake journaled
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
            # see AppendToasRequest) with the spill path's durability
            # contract: intake journaled and synced BEFORE the work
            # runs, so a crash mid-append replays it exactly once
            # against the lane's delta chain
            self.telemetry.incr("appends")
            with self._work_mutex:
                self._journal_before_run(request)
                self._execute_append(request, res, routing, now,
                                     trace=trace)
                if self.journal is not None:
                    self.journal.sync()
            return None
        if policy.is_oversize(len(request.toas), self.oversize_toas):
            self.telemetry.incr("spilled_oversize")
            with self._work_mutex:
                self._journal_before_run(request)
                self._execute_solo(request, res, routing, now,
                                   trace=trace)
                if self.journal is not None:
                    self.journal.sync()
            return None
        key = self.batcher.slot_key(request, routing)
        if not self.breaker.allow(key):
            self._reject(
                request, res, "circuit_open", routing[0],
                retry_after_s=round(self.breaker.retry_after_s(key), 3))
            return None
        return key, routing

    def _journal_before_run(self, request):
        """Make an immediately-executed request's intake durable before
        its work runs (the async flusher has already journaled it —
        don't append a duplicate)."""
        if self.journal is not None:
            if not self.journal.has_intake(request.request_id):
                self.journal.record_intake(request)
            self.journal.sync()

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
        ``shed_<reason>``, health note, terminal lifecycle record.
        Does NOT journal-commit — callers that journaled the intake
        first must follow with :meth:`_commit`."""
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
        self._commit(req, res)  # no-op unless the intake was journaled
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
        lifecycle census, and the fit-quality ledger (with the drift
        board's census under ``fit_quality.drift``) when the probes or a
        board are on; with device lanes, a ``devices`` block with each
        lane's own health/breaker census."""
        snap = self.telemetry.snapshot(cache=self.cache,
                                       health=self.health,
                                       breaker=self.breaker,
                                       devices=self._lane_snapshots())
        snap["executables_compiled"] = self.executables_compiled
        snap["queue_depth"] = self.batcher.depth()
        if self.store is not None:
            snap["store"] = self.store.counters()
        if self.reqlife is not None:
            snap["reqlife"] = self.reqlife.snapshot()
        from ..obs import fitquality as obs_fitq

        if self._fitq_board is not None or obs_fitq.enabled():
            fq = obs_fitq.FITQ.snapshot()
            fq.pop("pulsars", None)  # gauge surface stays O(1)
            if self._fitq_board is not None:
                fq["drift"] = self._fitq_board.snapshot()
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
            health=self.health, breaker=self.breaker,
            devices=self._lane_snapshots())
        reg.absorb({"executables_compiled": self.executables_compiled,
                    "queue_depth": self.batcher.depth()}, prefix=prefix)
        if self.reqlife is not None:
            reg.absorb(self.reqlife.snapshot(),
                       prefix=prefix + "reqlife.")
        from ..obs import fitquality as obs_fitq

        if self._fitq_board is not None or obs_fitq.enabled():
            obs_fitq.export_metrics(registry=reg)
            if self._fitq_board is not None:
                reg.absorb(self._fitq_board.snapshot(),
                           prefix="fitq.drift.")
        if self._slo_monitor is not None:
            # scrape-time SLO evaluation: the monitor exports its
            # slo.* gauges into its own registry (the process REGISTRY
            # unless attach_slo was given one)
            self._slo_monitor.ingest(self.snapshot())
        return reg

    # -- execution ---------------------------------------------------

    def _lane_snapshots(self):
        return (None if self.device_lanes is None
                else [ln.snapshot() for ln in self.device_lanes])

    def _exec_key(self, slot_key, lanes, pta, dev_lane=None):
        """Full executable signature. When a shape plan is active its
        stable signature joins the key, so programs built under one
        plan's ladder never collide with another plan's (or the pow2
        ladder's) entries in a shared cache. A routed device lane joins
        it too: a program is captured on its lane's device, and a slot
        stolen onto another lane captures anew, as a second card
        would need."""
        base = (slot_key, lanes, pta.shape_signature())
        if dev_lane is not None:
            base = base + (("lane", dev_lane.index),)
        if self.plan is not None:
            return base + (self.plan.signature(),)
        return base

    def _route_lane(self, slot_key):
        """Deterministic slot -> device-lane routing: crc32 of the slot
        key picks the home lane (stable across processes and restarts),
        and dead/open/draining lanes are walked past in index order, so
        a quarantined device sheds its slots onto the next alive lane.
        None without device lanes or when no lane survives."""
        if not self.device_lanes:
            return None
        n = len(self.device_lanes)
        home = zlib.crc32(repr(slot_key).encode()) % n
        for step in range(n):
            lane = self.device_lanes[(home + step) % n]
            if lane.alive():
                return lane
        return None

    def _seen_key(self, slot_key, lane):
        """Zero-recapture tracking key: per (slot, lane) with device
        lanes, else the slot key itself."""
        return slot_key if lane is None else (slot_key, lane.index)

    def _padded_batch(self, bucket, models, toas_list, lane=None):
        """Lane-padded PTABatch for one slot flush, on the routed device
        lane's device (else the engine's, or sharded over its mesh): the
        pulsar/lane axis replicates the last (model, toas) up to
        max_batch — real data, so a padded lane's start vector and
        tensors are never uninitialised memory — and the TOA axis pads
        to the slot's bucket, so every flush of a slot presents the
        executable cache with identical shapes."""
        from ..parallel.pta import PTABatch

        lanes = self.batcher.max_batch
        n = len(models)
        models = models + [models[-1]] * (lanes - n)
        toas_list = toas_list + [toas_list[-1]] * (lanes - n)
        if lane is not None and self.mesh is None:
            return PTABatch(models, toas_list, pad_toas=bucket,
                            device=lane.device)
        return PTABatch(models, toas_list, pad_toas=bucket,
                        device=self.device, mesh=self.mesh)

    def _stage(self, slots):
        """Lane-padded batches and exec keys of the slots whose program
        is not cached yet, for the prewarm paths: ``slots`` is a list of
        (slot_key, bucket, requests); returns (slot_key, exec_key, pta,
        kind, method, maxiter, precision) per cold slot."""
        staged = []
        for slot_key, bucket, reqs in slots:
            _, _, kind, method, maxiter, precision = slot_key
            reqs = reqs[:self.batcher.max_batch]
            lane = self._route_lane(slot_key)
            pta = self._padded_batch(bucket, [r.model for r in reqs],
                                     [r.toas for r in reqs], lane=lane)
            exec_key = self._exec_key(slot_key, self.batcher.max_batch,
                                      pta, lane)
            if self.cache.lookup(exec_key) is not None:
                continue
            staged.append((self._seen_key(slot_key, lane), exec_key, pta,
                           kind, method, maxiter, precision))
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
        if self.cache.persistent is not None:
            for _, exec_key, pta, kind, method, maxiter, precision \
                    in staged:
                self.cache.persistent.stage(exec_key, pta, self._fit_programs(
                    pta, kind, method, maxiter, precision))
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
                    self._commit(req, res)
                else:
                    live.append((req, res, t_sub, tr))
            fsp.set(n_live=len(live), shed=len(entries) - len(live))
            if self.journal is not None:
                # group commit of every intake (and shed completion)
                # journaled since the last sync, BEFORE any execution:
                # a kill past this point can only lose uncommitted
                # work, which replay re-runs
                self.journal.sync()
                faultinject.fire_kill("intake_append", slot=str(key))
            if live:
                self._execute(key, live, flush_start=now,
                              flush_trace=flush_trace)
                self.health.note_flush(self.clock() - now)
            if self.journal is not None:
                # catch-all sync for completions recorded on failure /
                # quarantine paths (no-op when already clean)
                self.journal.sync()

    def _commit(self, req, res):
        """Journal a terminal completion for a journaled request — the
        durable delivery point. Only requests this process recorded an
        intake for are committed (submit-time rejections complete
        synchronously and never enter the journal); syncing is batched
        by the flush."""
        if self.journal is None \
                or not self.journal.has_intake(req.request_id):
            return
        self.journal.record_commit(req.request_id, res.status,
                                   value=res.value, reason=res.reason,
                                   telemetry=res.telemetry)

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
            self._commit(req, res)

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
        dev_lane = self._route_lane(slot_key)
        if self.device_lanes is not None:
            fault = faultinject.fire("device_loss", slot=str(slot_key))
            if (fault and dev_lane is not None
                    and int(fault.get("lane", dev_lane.index))
                    == dev_lane.index):
                # the routed device died: quarantine its lane and let
                # the crc32 walk shed this slot onto the next alive
                # lane — the flush proceeds there, no request fails
                dev_lane.quarantine()
                self.telemetry.incr("device_lost")
                lost_index = dev_lane.index
                dev_lane = self._route_lane(slot_key)
                _flight.dump(
                    "device_lost", source="serve", lane=lost_index,
                    fault_point="device_loss", slot=str(slot_key),
                    rerouted_lane=(None if dev_lane is None
                                   else dev_lane.index),
                    trace=obs_trace.current_trace_id())
            if dev_lane is None:
                from ..parallel.fleetmesh import DeviceLost

                raise DeviceLost(
                    f"no alive device lane for slot {slot_key!r} "
                    f"({len(self.device_lanes)} lanes quarantined)")
        seen_key = self._seen_key(slot_key, dev_lane)
        t0 = self.clock()
        with obs_trace.span("serve.pack", bucket=bucket, n=n_live):
            pta = self._padded_batch(
                bucket, [req.model for req, _, _, _ in live],
                [req.toas for req, _, _, _ in live], lane=dev_lane)
        pack_s = self.clock() - t0
        if self.reqlife is not None:
            t_packed = self.clock()
            for req, _, _, _ in live:
                self._lc(req, "packed", t=t_packed)
        exec_key = self._exec_key(slot_key, lanes, pta, dev_lane)
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
            if self.cache.persistent is not None:
                # what the persisted tier writes on the insert below
                self.cache.persistent.stage(exec_key, pta, self._fit_programs(
                    pta, kind, method, maxiter, precision))
            self.cache.insert(exec_key, pta._fns)
            seen = self._slot_exec_keys.setdefault(seen_key, set())
            if seen and exec_key not in seen:
                # shapes are pinned, so a second distinct executable
                # for a slot means the zero-recompile contract broke
                self.telemetry.incr("unexpected_recompiles")
                n = self._slot_recompiles.get(seen_key, 0) + 1
                self._slot_recompiles[seen_key] = n
                if n >= self.breaker.threshold:
                    tripped = self.breaker.trip(slot_key)
                    self.health.note_breakers(self.breaker.open_count(),
                                              tripped)
            seen.add(exec_key)
        else:
            # the cached table's programs run on this batch's data
            pta._fns = fns
            self._slot_exec_keys.setdefault(seen_key, set()).add(exec_key)

        fault = faultinject.fire("dispatch_slow", slot=str(slot_key))
        if fault:
            self._sleep(float(fault.get("delay_s", 0.25)))

        fell = set()
        t0 = self.clock()
        if self.reqlife is not None:
            for req, _, _, _ in live:
                self._lc(req, "executing", t=t0)
        with obs_trace.span("serve.run", kind=kind,
                            bucket=bucket, cold=cold):
            if kind == "fit":
                if method == "gls":
                    x, chi2, cov = pta.gls_fit(maxiter=maxiter,
                                               precision=precision)
                else:
                    x, chi2, cov = pta.wls_fit(maxiter=maxiter)
                # the live lanes whose mixed refinement fell back to f64:
                # the finalize decides per pulsar, so a request is
                # degraded by its own fit alone (padding lanes are none)
                fell = {i for i in pta.metrics.get("fell_back", ())
                        if i < n_live}
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
        if fell:
            self.telemetry.incr("degraded_mixed", len(fell))
        if kind == "fit" and self._fitq_board is not None:
            # drift sentinels over the lanes being COMMITTED (poisoned
            # attempts return above — a diverged lane is the
            # divergence probe's business, not a drift observation);
            # pure host post-processing of the arrays already pulled
            from ..obs import drift as obs_drift
            from ..obs import fitquality as obs_fitq

            t0 = self.clock()
            with np.errstate(invalid="ignore"):
                sig = np.sqrt(np.maximum(
                    np.diagonal(cov, axis1=-2, axis2=-1), 0.0))
            tid = obs_trace.current_trace_id()
            for i, (req, _, _, _) in enumerate(live):
                dof = max(1.0, len(req.toas) - x.shape[1] - 1)
                self._fitq_board.observe(
                    self._fit_label(req),
                    obs_drift.fit_drift_values(
                        x[i], sig[i], float(chi2[i]) / dof, names),
                    slot=str(slot_key), trace=tid)
            obs_fitq.FITQ.note_probe_wall(self.clock() - t0)
        done = self.clock()
        if self.journal is not None:
            # results computed but none committed yet: a kill here
            # re-runs the whole flush on recovery (bitwise — lane
            # independence)
            faultinject.fire_kill("pre_commit", slot=str(slot_key))
        for i, (req, res, t_sub, tr) in enumerate(live):
            res.status = "ok"
            res.value = value_of(i)
            rec = {"request_id": req.request_id, "kind": kind,
                   "status": res.status, "reason": res.reason,
                   "queue_wait_s": flush_start - t_sub,
                   "pack_s": pack_s, "compile_s": compile_s,
                   "execute_s": execute_s, "total_s": done - t_sub,
                   "lanes": lanes, "bucket": bucket, "cold": cold,
                   "degraded": i in fell, "spilled": False,
                   "tenant": getattr(req, "tenant", "anon"),
                   "trace": tr}
            res.telemetry = rec
            self.telemetry.record(**rec)
            self.health.note_request("ok")
            self._lc(req, "delivered", t=done,
                     queue_wait_s=rec["queue_wait_s"],
                     execute_s=execute_s, bucket=bucket, cold=cold,
                     flush_trace=flush_trace)
            self._commit(req, res)
        if self.journal is not None:
            # group commit: one fsync makes every completion of this
            # flush durable; past this point recovery re-emits them
            # from the journal instead of re-running anything
            self.journal.sync()
            faultinject.fire_kill("post_commit", slot=str(slot_key))
        return set()

    @staticmethod
    def _fit_programs(pta, kind, method, maxiter, precision):
        """{program key: aot_compile options} of a fit slot's program,
        what the persisted tier re-captures (None for resid/phase
        slots, whose programs run eagerly)."""
        if kind != "fit":
            return None
        opts = {"method": method, "maxiter": maxiter,
                "precision": precision}
        return {pta.program_key(**opts): opts}

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
            # pintlint: disable=serve-unpadded-batch
            pta = PTABatch([request.model], [request.toas],
                           device=self.device, mesh=self.mesh)
            pack_s = self.clock() - t0
            self._lc(request, "packed")
            degraded = False
            t0 = self.clock()
            self._lc(request, "executing", t=t0)
            if kind == "fit":
                if method == "gls":
                    x, chi2, cov = pta.gls_fit(maxiter=maxiter,
                                               precision=precision)
                else:
                    x, chi2, cov = pta.wls_fit(maxiter=maxiter)
                degraded = bool(pta.metrics.get("fell_back"))
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
        self._commit(request, res)

    def register_append_lane(self, model, toas, precision="f64",
                             sentinel=None, prewarm=True):
        """Register one streaming append lane (serve.streaming) for
        ``model`` over its base TOA table, on the engine's device.

        With a delta store, the lane's persisted chain is prewarm-
        staged in the background FIRST, so the disk verify overlaps
        the lane's registration; the chain is then replayed into the
        fresh state — a recovered process must call this for each lane
        BEFORE :meth:`recover`, so replayed append intakes find their
        lane. Returns the lane key."""
        if self.deltas is not None and prewarm:
            sig = StreamingRefitter._base_signature(model, toas)
            self.deltas.prewarm([(streaming_lane_key(model), sig)])
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
        self._commit(request, res)
