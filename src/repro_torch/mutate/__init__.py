"""Streaming index mutation: delta buffer + tombstones + compaction
(``repro.mutate``).  See :mod:`repro_torch.mutate.delta` for the design
notes."""

from repro_torch.mutate.delta import (BRUTEFORCE_SPEC, IVF_SPEC,  # noqa: F401
                                      MUTABLE_ALGOS, DeltaFull,
                                      MutableBruteForce, MutableIVF, compact,
                                      delete, delta_fraction, insert,
                                      is_mutable, live_count, live_items)

__all__ = [
    "BRUTEFORCE_SPEC", "IVF_SPEC", "MUTABLE_ALGOS", "DeltaFull",
    "MutableBruteForce", "MutableIVF", "compact", "delete",
    "delta_fraction", "insert", "is_mutable", "live_count", "live_items",
]
