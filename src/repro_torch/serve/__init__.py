"""Serving tier over the functional index core (``repro.serve``).

Layers, composing upward:

  * :mod:`repro_torch.serve.engine` -- the synchronous micro-batching
    :class:`Engine` (fixed padded micro-batches over one resident
    IndexState), the :class:`Ticket` request future, and background
    :class:`Compaction` handles.
  * :mod:`repro_torch.serve.checkpoint` -- the one checkpoint surface
    (single-state ``.npz`` + multi-tenant archives, explicit version
    negotiation, corrupt-file hardening), file for file the reference's.
  * :mod:`repro_torch.serve.faults` -- deterministic fault injection
    (:class:`FaultPlan`) for chaos tests.
  * :mod:`repro_torch.serve.errors` -- the typed error tree.

The reference's async tier -- ``AsyncEngine`` and ``DEFAULT_TENANT``
(``async_engine.py``), ``ServeMetrics`` and ``LatencyHistogram``
(``metrics.py``), ``RetryPolicy`` (``retry.py``) and ``launch/serve.py``
-- is not ported yet and arrives with the async slice (ROADMAP.md §1).
"""

from repro_torch.serve import faults
from repro_torch.serve.checkpoint import (ARCHIVE_VERSION, CHECKPOINT_VERSION,
                                          CheckpointError, load_state,
                                          save_state)
from repro_torch.serve.engine import Compaction, Engine, Ticket
from repro_torch.serve.errors import (AdmissionError, CompactionError,
                                      DeadlineExceeded, EngineClosed,
                                      EngineDegraded, RetriesExhausted,
                                      ServeError, ShardFault, TransientFault)
from repro_torch.serve.faults import FaultPlan, PumpFault

__all__ = [
    "Engine", "Ticket", "Compaction",
    "ServeError", "AdmissionError", "DeadlineExceeded", "EngineClosed",
    "EngineDegraded", "TransientFault", "ShardFault", "RetriesExhausted",
    "CompactionError", "PumpFault", "FaultPlan", "faults",
    "CheckpointError", "CHECKPOINT_VERSION", "ARCHIVE_VERSION",
    "save_state", "load_state",
]
