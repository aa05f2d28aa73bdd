"""Asynchronous continuous-batching front door over ServeEngine (the
JAX package's ``serve/frontdoor.py``).

The synchronous engine flushes inline on the submitter's thread, so a
single-threaded driver can never observe a saturated queue: every
batch-full submit drains the queue it just filled. This module
decouples intake from flush so overload is a real, measurable state:

- :class:`IntakeQueue` — a bounded, condition-signalled handoff
  between N submitter threads and one flusher worker. ``offer`` never
  blocks (full queue -> shed, that IS the backpressure signal);
  ``take`` marks the item in flight so ``idle()`` is exact and
  ``drain`` has no windows.
- :class:`AsyncServeEngine` — submit screens admission
  (serve.admission: tenant quota -> SLO throttle -> backpressure),
  journals the intake, and hands the request to the flusher. The
  flusher admits into the micro-batcher and flushes batch-full slots
  immediately; whenever the intake goes briefly quiet it flushes the
  partial slots too (continuous batching — a request arriving between
  flushes joins the next warm slot instead of waiting out a timer or a
  full batch).
  Partial flushes need no new capture by construction: every flush
  lane-pads to ``max_batch`` (ServeEngine._padded_batch), so batch
  composition never changes the program OR any lane's bits — async
  results are bitwise identical to the synchronous engine's on the
  same stream.
- A watchdog thread restarts a dead or stalled flusher
  (``flusher_stall`` / thread death -> supersede generation, spawn a
  replacement). The replacement serializes behind ``_work_mutex``, so
  a wedged-then-woken predecessor can never double-flush; slot takes
  pop atomically, so no request executes twice.

All device work runs on one thread at a time, the one holding the
engine's ``_work_mutex`` — the flusher's while traffic flows
(producers only enqueue) — so a watchdog restart never leaves two
threads flushing. Captured programs share one graph memory pool per
device; ``graphs.py`` runs their captures and replays one at a time in
the process, so a fleet fitting on the caller's thread, or a second
engine, cannot interleave with a flush either. The flusher makes the engine's device its current device
before anything else, since a slot's first capture happens inside a
flush on that thread.

Durability ordering under concurrency: the WAL intake is journaled
BEFORE the request becomes visible to any flusher, because the moment
it is visible it may complete and commit — a commit whose intake
never reached the log would replay a delivered request after a
crash. Sheds after that point journal a commit too (exactly-once
replay); admission sheds happen before journaling and complete
synchronously, like the sync engine's submit-time rejections — but
they still write a commit record when the request's intake is already
on the log (recover() pre-marks replayed intakes via
``journal.note_intake``), so a replay shed at admission can never
replay again.

Shutdown: :meth:`AsyncServeEngine.close` stops the intake, the flusher
drains what is left (journal-synced), and the watchdog exits. Crash
recovery is the inherited :meth:`ServeEngine.recover` — re-submits
ride the same intake/flusher path and ``drain`` blocks until every
replayed request reaches a terminal state.
"""

from __future__ import annotations

import threading
from collections import deque

from ..obs.recorder import RECORDER as _flight
from ..resilience import faultinject
from .admission import AdmissionController
from .engine import ServeEngine
from .request import ServeResult


class IntakeQueue:
    """Bounded thread-safe handoff queue between submitter threads and
    the flusher worker, with the bookkeeping the watchdog and drain
    logic need: a heartbeat, a flusher generation counter, and an
    in-flight count (incremented atomically WITH the dequeue, so
    ``idle()`` never reports idle while an item is in the flusher's
    hands). Every mutation holds ``_lock``."""

    def __init__(self, capacity):
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        # the condition shares _lock, so waiting and mutating happen
        # under the same monitor
        self._cv = threading.Condition(self._lock)
        self._items = deque()
        self.running = True
        self.heartbeat = 0.0
        self.generation = 0
        self.inflight = 0

    def depth(self):
        with self._lock:
            return len(self._items)

    def offer(self, item):
        """Non-blocking enqueue. Returns None on success, else the
        refusal cause decided inside the critical section:
        ``"stopped"`` when the intake no longer accepts work
        (shutdown) or ``"full"`` at capacity — so a stop() landing
        between the caller's is_running() screen and the offer is
        reported as shutdown, never misread as saturation."""
        with self._lock:
            if not self.running:
                return "stopped"
            if len(self._items) >= self.capacity:
                return "full"
            self._items.append(item)
            self._cv.notify()
            return None

    def take(self, timeout):
        """Dequeue one item (None on timeout/empty). The in-flight
        count increments inside the same critical section as the
        dequeue; the taker MUST pair every non-None return with
        :meth:`done_one`."""
        with self._lock:
            if not self._items and self.running:
                self._cv.wait(timeout)
            if not self._items:
                return None
            self.inflight += 1
            return self._items.popleft()

    def done_one(self):
        with self._lock:
            self.inflight -= 1
            self._cv.notify_all()

    def beat(self, t):
        """Flusher liveness heartbeat (engine clock seconds)."""
        with self._lock:
            self.heartbeat = float(t)

    def last_beat(self):
        with self._lock:
            return self.heartbeat

    def supersede(self):
        """Invalidate the current flusher generation (watchdog
        restart): the superseded flusher exits at its next loop-top
        generation check. Returns the new generation."""
        with self._lock:
            self.generation += 1
            return self.generation

    def generation_now(self):
        with self._lock:
            return self.generation

    def stop(self):
        """Stop accepting offers and wake every waiter (shutdown)."""
        with self._lock:
            self.running = False
            self._cv.notify_all()

    def is_running(self):
        with self._lock:
            return self.running

    def idle(self):
        """True when nothing is queued AND nothing is in the
        flusher's hands."""
        with self._lock:
            return not self._items and self.inflight == 0


class AsyncServeEngine(ServeEngine):
    """ServeEngine with the submit path split from the flush path.

    submit: lifecycle + fault intake hooks -> admission ladder ->
    WAL intake -> bounded intake queue. Returns immediately; the
    ServeResult handle completes when the flusher delivers (or at the
    shed/reject site).

    flusher worker: dequeue -> screening (routing / nonfinite /
    oversize / breaker, shared with the sync engine) -> micro-batch
    admit -> flush on batch-full, partial slots flushed on idle ticks
    (continuous batching). Also runs the periodic SLO check (every
    ``slo_check_interval_s`` once :meth:`attach_slo` has a monitor)
    that feeds admission throttling; it holds no lock while it reads
    the engine's snapshot, and the monitor's lock is innermost.

    watchdog: restarts a dead/stalled flusher under a new generation.

    The inherited ``run_stream`` / ``prewarm`` / ``recover`` work
    unchanged:
    ``poll`` is a no-op (the flusher owns timers) and ``drain`` blocks
    until intake + batcher are empty.
    """

    def __init__(self, *args, admission=None, flusher_poll_s=0.002,
                 stall_timeout_s=30.0, watchdog_poll_s=0.05,
                 slo_check_interval_s=1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.intake = IntakeQueue(self.max_queue)
        self.admission = (admission if admission is not None
                          else AdmissionController(clock=self.clock))
        self.flusher_poll_s = float(flusher_poll_s)
        self.stall_timeout_s = float(stall_timeout_s)
        self.watchdog_poll_s = float(watchdog_poll_s)
        self.slo_check_interval_s = float(slo_check_interval_s)
        self._last_slo_check = self.clock()
        # the card's index as the constructing thread sees it (a plain
        # "cuda" device names the current card), for the flusher thread
        self._card = None
        if self.device.type == "cuda":
            import torch

            self._card = (self.device.index if self.device.index is not None
                          else torch.cuda.current_device())
        # the engine's _work_mutex serializes a superseded flusher
        # against its replacement: the new worker blocks on it until the
        # old one's current operation finishes, so a stall that wakes up
        # can never double-flush
        self._stop_watchdog = threading.Event()
        self._flusher = None
        self.intake.beat(self.clock())
        self._start_flusher(self.intake.generation_now())
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, daemon=True,
            name="pint-serve-watchdog")
        self._watchdog.start()

    # -- intake ------------------------------------------------------

    def submit(self, request):
        """Admit one request into the front door. Never flushes on
        the caller's thread; sheds/rejections complete the handle
        immediately, everything else completes when the flusher
        delivers."""
        res = ServeResult(request=request)
        now = self.clock()
        trace = None
        if self.reqlife is not None:
            trace = self.reqlife.submitted(
                request.request_id,
                tenant=getattr(request, "tenant", "anon"),
                kind=request.kind, t=now)
        request, fault = self._maybe_corrupt(request, res)
        if not self.intake.is_running() \
                or self.health.state == "draining":
            return self._reject(request, res, "draining", request.kind,
                                health_state=self.health.state)
        decision = self.admission.decide(
            request, depth=self.intake.depth(),
            capacity=self.intake.capacity, now=now)
        if not decision.admit:
            # admission sheds complete before the WAL sees the
            # request, so a FRESH submit has nothing to commit — but
            # recover() pre-marks replayed intakes (note_intake)
            # before re-submitting through this path, and a replay
            # shed here without a commit record would replay again.
            # _commit is a no-op unless the intake is journaled.
            self._shed(request, res, decision.reason,
                       kind=request.kind, t=now, trace=trace,
                       **decision.detail)
            self._commit(request, res)
            return res
        forced = faultinject.fire("intake_overflow",
                                  request_id=request.request_id)
        if self.journal is not None:
            # WAL intake BEFORE the queue: see the module docstring —
            # visible work may commit immediately, and a commit
            # without its intake on disk replays a delivered request
            self.journal.record_intake(request)
        self._lc(request, "queued", t=now)
        refused = None
        if forced is None:
            refused = self.intake.offer((request, res, now, trace,
                                         fault))
            if refused is None:
                return res
            if refused == "stopped":
                # stop() landed between the is_running() screen above
                # and the offer: report the shutdown, not saturation —
                # the synchronous draining rejection the docstring
                # promises (committed: the intake is journaled)
                return self._reject(request, res, "draining",
                                    request.kind,
                                    health_state=self.health.state)
        detail = {"queue_depth": self.intake.depth(),
                  "capacity": self.intake.capacity}
        reason = "queue_full"
        if forced is not None:
            reason = "intake_overflow"
            detail["injected_point"] = forced["point"]
        self._shed(request, res, reason, kind=request.kind, t=now,
                   trace=trace, **detail)
        self._commit(request, res)  # journaled shed: exactly-once
        return res

    def poll(self, now=None):
        """No-op: the flusher worker owns the flush timers."""
        return []

    def drain(self):
        """Block until the intake queue, the flusher's hands, and the
        micro-batcher slots are all empty (the flusher's idle ticks
        flush partial slots within a poll interval). The check holds
        the flusher's work mutex: ``_flush`` empties a batcher slot
        BEFORE executing it, so without the mutex the predicate is
        (wrongly) true for the whole duration of an in-flight flush."""
        while True:
            with self._work_mutex:
                if self.intake.idle() \
                        and not self.batcher.pending_keys():
                    return
            self._sleep(self.flusher_poll_s)

    def close(self, drain=True):
        """Clean shutdown: optionally drain, stop the intake (new
        submits reject as draining), let the flusher finish its final
        sweep, stop the watchdog, and sync the journal."""
        if drain:
            self.drain()
        self.intake.stop()
        flusher = self._flusher
        if flusher is not None and flusher.is_alive():
            flusher.join(timeout=60.0)
        self._stop_watchdog.set()
        if self._watchdog is not None and self._watchdog.is_alive():
            self._watchdog.join(timeout=10.0)
        if self.journal is not None:
            self.journal.sync()

    # -- flusher worker ----------------------------------------------

    def _start_flusher(self, gen):
        th = threading.Thread(target=self._flusher_loop, args=(gen,),
                              daemon=True,
                              name=f"pint-serve-flusher-{gen}")
        self._flusher = th
        th.start()
        return th

    def _flusher_loop(self, gen):
        if self._card is not None:
            # a slot's first capture happens inside a flush on this
            # thread: make the engine's card its current device
            import torch

            torch.cuda.set_device(self._card)
        intake = self.intake
        while True:
            if intake.generation_now() != gen:
                return  # superseded by a watchdog restart
            stall = faultinject.fire("flusher_stall")
            if stall is not None:
                # wedge WITHOUT dequeuing — a stalled flusher must
                # never strand an item in its hands; the heartbeat
                # goes stale and the watchdog supersedes us
                self._sleep(float(stall.get("hang_s", 0.05)))
                continue
            intake.beat(self.clock())
            item = intake.take(timeout=self.flusher_poll_s)
            if item is not None:
                try:
                    with self._work_mutex:
                        self._handle(item)
                except Exception as exc:
                    # a _handle escape must not strand the dequeued
                    # request: without a terminal state its handle
                    # polls forever and its journaled intake replays.
                    # Complete it as an error and keep the flusher
                    # alive — one bad request is not a worker fault.
                    self._handle_crashed(item, exc)
                finally:
                    intake.done_one()
                continue
            with self._work_mutex:
                self._idle_tick()
            if not intake.is_running() and intake.idle() \
                    and not self.batcher.pending_keys():
                if self.journal is not None:
                    self.journal.sync()
                return

    def _handle(self, item):
        """Process one dequeued request on the flusher thread."""
        request, res, t_sub, trace, fault = item
        # the flusher-death leg of the SIGKILL matrix: die with the
        # item dequeued but nothing flushed — its journaled intake has
        # no commit, so recovery re-runs it exactly once
        faultinject.fire_kill("flusher_take", rid=request.request_id)
        screened = self._screen(request, res, t_sub, trace,
                                injected=fault)
        if screened is None:
            return
        key, _ = screened
        if self.batcher.admit(key, request, res, t_sub, trace=trace):
            self._flush(key)

    def _handle_crashed(self, item, exc):
        """Terminal backstop for an unexpected exception escaping
        :meth:`_handle` on the flusher thread: the dequeued request
        gets its error status, telemetry record, terminal lifecycle
        state, and journal commit, so no flusher bug can leave a
        request pending with drain() reporting quiescence."""
        request, res, _, trace, _ = item
        self.telemetry.incr("flusher_handle_errors")
        _flight.note("flusher_handle_error",
                     request_id=request.request_id, error=repr(exc))
        if res.done:
            # _handle completed the request before the exception
            # (e.g. a failure inside _flush after _fail ran): the
            # terminal state is already exactly-one, leave it be
            return
        reason = f"{type(exc).__name__}: {exc}"
        res.status = "error"
        res.reason = reason
        self.telemetry.incr("errors")
        self.telemetry.record(request_id=request.request_id,
                              kind=request.kind, status="error",
                              reason=reason,
                              tenant=getattr(request, "tenant",
                                             "anon"), trace=trace)
        self.health.note_request("error")
        self._lc(request, "error", reason=reason)
        self._commit(request, res)

    def _idle_tick(self):
        """Continuous batching: the intake went quiet, so flush every
        partial slot now — lane padding to max_batch keeps these
        flushes on the same warm programs as full ones. Also the
        home of the periodic SLO check feeding admission."""
        now = self.clock()
        if self._slo_monitor is not None \
                and now - self._last_slo_check \
                >= self.slo_check_interval_s:
            self._last_slo_check = now
            self.slo_check(t=now)
        for key in self.batcher.pending_keys():
            self._flush(key)

    # -- watchdog ----------------------------------------------------

    def _watchdog_loop(self):
        while not self._stop_watchdog.wait(self.watchdog_poll_s):
            flusher = self._flusher
            dead = flusher is None or not flusher.is_alive()
            if dead and not self.intake.is_running() \
                    and self.intake.idle() \
                    and not self.batcher.pending_keys():
                continue  # clean shutdown; nothing left to tend
            stalled = (self.clock() - self.intake.last_beat()
                       > self.stall_timeout_s)
            if dead or stalled:
                gen = self.intake.supersede()
                self.telemetry.incr("flusher_restarts")
                _flight.note("flusher_restart",
                             generation=gen, dead=dead,
                             stalled=stalled,
                             intake_depth=self.intake.depth())
                self._start_flusher(gen)

    # -- SLO / snapshot ----------------------------------------------

    def slo_check(self, t=None):
        """Burn-rate check that also feeds admission: tenants whose
        SLOs are alerting get throttled at the front door."""
        states = super().slo_check(t=t)
        if states is not None:
            self.admission.observe_slo(states, now=t)
        return states

    def snapshot(self):
        snap = super().snapshot()
        snap["admission"] = self.admission.snapshot()
        flusher = self._flusher
        snap["intake"] = {
            "depth": self.intake.depth(),
            "capacity": self.intake.capacity,
            "running": self.intake.is_running(),
            "generation": self.intake.generation_now(),
            "flusher_alive": bool(flusher is not None
                                  and flusher.is_alive()),
        }
        return snap
