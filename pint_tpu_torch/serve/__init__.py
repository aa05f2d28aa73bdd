"""pint_tpu_torch.serve — the online timing service layer (the JAX
package's ``serve/``).

Turns the offline batched fitting core (parallel/pta.py) into an
in-process serving engine: typed requests (fit / residuals / phase
predict / streaming append) are admitted into pow2-bucketed micro-batch
slots, flushed onto warm programs held in an LRU cache (captured once
as CUDA graphs on the card, each run on the data of the flush that
calls it), degraded gracefully under pressure (mixed->f64 fallback,
oversize spill, queue/deadline shedding), and accounted per-request in
telemetry snapshots. No network layer is included or required.

    from pint_tpu_torch.serve import ServeEngine, FitRequest

    eng = ServeEngine(max_batch=8, max_latency_s=0.02)  # on the card
    res = eng.submit(FitRequest(model, toas))
    eng.drain()                      # or poll() from a serving loop
    res.value["x"], res.telemetry    # results + per-request latencies
    eng.snapshot()                   # p50/p99 + cache/shed counters

Not ported yet (ROADMAP §1 item 3's durability queue): the write-ahead
journal (``journal.py``), ``PersistentExecutableCache`` and
``save_serve_state``/``restore_serve_state``.
"""

from .admission import (PRIORITY_BATCH, PRIORITY_HIGH, PRIORITY_NORMAL,
                        AdmissionController, AdmissionDecision)
from .batcher import MicroBatcher, pow2_bucket
from .engine import ServeEngine
from .excache import ExecutableCache
from .frontdoor import AsyncServeEngine, IntakeQueue
from .metrics import ServeTelemetry, percentile
from .recovery import result_digest
from .request import (AppendToasRequest, FitRequest,
                      PhasePredictRequest, ResidualRequest,
                      ServeResult, TimingRequest)
from .streaming import StreamingRefitter, lane_key

__all__ = [
    "ServeEngine", "AsyncServeEngine", "IntakeQueue",
    "AdmissionController", "AdmissionDecision",
    "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_BATCH",
    "MicroBatcher", "ExecutableCache", "ServeTelemetry",
    "result_digest",
    "percentile", "pow2_bucket", "TimingRequest", "FitRequest",
    "ResidualRequest", "PhasePredictRequest", "AppendToasRequest",
    "ServeResult", "StreamingRefitter", "lane_key",
]
