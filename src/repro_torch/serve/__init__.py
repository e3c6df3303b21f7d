"""Serving tier over the functional index core (``repro.serve``).

Layers, composing upward:

  * :mod:`repro_torch.serve.engine` -- the synchronous micro-batching
    :class:`Engine` (fixed padded micro-batches over one resident
    IndexState), the :class:`Ticket` request future, and background
    :class:`Compaction` handles.
  * :mod:`repro_torch.serve.async_engine` -- the SLO-aware background
    pump (:class:`AsyncEngine`): timeout-based flush, per-request
    deadlines, admission control, multi-tenant routing, latency
    percentiles, plus the fault-tolerance surface (retries, pump
    supervisor).
  * :mod:`repro_torch.serve.checkpoint` -- the one checkpoint surface
    (single-state ``.npz`` + multi-tenant archives, explicit version
    negotiation, corrupt-file hardening), file for file the reference's.
  * :mod:`repro_torch.serve.metrics` -- :class:`ServeMetrics` and
    :class:`LatencyHistogram`: request counters and latency percentiles.
  * :mod:`repro_torch.serve.retry` -- :class:`RetryPolicy`: exponential
    backoff with deterministic jitter for transient faults.
  * :mod:`repro_torch.serve.faults` -- deterministic fault injection
    (:class:`FaultPlan`) for chaos tests.
  * :mod:`repro_torch.serve.errors` -- the typed error tree.
"""

from repro_torch.serve import faults
from repro_torch.serve.async_engine import DEFAULT_TENANT, AsyncEngine
from repro_torch.serve.checkpoint import (ARCHIVE_VERSION, CHECKPOINT_VERSION,
                                          CheckpointError, load_state,
                                          save_state)
from repro_torch.serve.engine import Compaction, Engine, Ticket
from repro_torch.serve.errors import (AdmissionError, CompactionError,
                                      DeadlineExceeded, EngineClosed,
                                      EngineDegraded, RetriesExhausted,
                                      ServeError, ShardFault, TransientFault)
from repro_torch.serve.faults import FaultPlan, PumpFault
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics
from repro_torch.serve.retry import RetryPolicy

__all__ = [
    "Engine", "Ticket", "Compaction", "AsyncEngine", "DEFAULT_TENANT",
    "ServeMetrics", "LatencyHistogram",
    "ServeError", "AdmissionError", "DeadlineExceeded", "EngineClosed",
    "EngineDegraded", "TransientFault", "ShardFault", "RetriesExhausted",
    "CompactionError", "PumpFault", "FaultPlan", "RetryPolicy", "faults",
    "CheckpointError", "CHECKPOINT_VERSION", "ARCHIVE_VERSION",
    "save_state", "load_state",
]
