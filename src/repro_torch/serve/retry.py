"""Retry/backoff policy for transient serving faults
(``repro.serve.retry``).

The async pump applies a :class:`RetryPolicy` to every micro-batch whose
device call raises a :class:`~repro_torch.serve.errors.TransientFault` (e.g. an
injected or real shard crash): the batch is retried up to
``max_attempts`` with exponential backoff and *deterministic* jitter --
the jitter draw is keyed by ``(seed, ticket, attempt)``, so a replayed
fault schedule produces a bit-identical retry timeline instead of a
flaky one.

The budget is deadline-aware: a retry is only taken if at least one live
request in the batch could still meet its deadline after the backoff
sleep; otherwise the batch fails immediately with
:class:`~repro_torch.serve.errors.RetriesExhausted` (wrapping the last cause)
rather than burning the tail of every deadline on doomed attempts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.errors import TransientFault


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Max attempts + exponential backoff with deterministic jitter.

    ``max_attempts`` counts the first try: 3 means one try plus up to two
    retries; 1 disables retrying.  Backoff before retry ``a`` (1-based)
    is ``min(base_ms * multiplier**(a-1), max_ms)``, jittered uniformly
    by ``±jitter`` (fraction), with the draw keyed by
    ``(seed, token, a)``.
    """

    max_attempts: int = 3
    base_ms: float = 1.0
    multiplier: float = 2.0
    max_ms: float = 50.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if self.base_ms < 0 or self.max_ms < 0:
            raise ValueError("backoff times must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter={self.jitter} is a fraction in [0, 1]")

    def backoff_s(self, attempt: int, token: int = 0) -> float:
        """Seconds to sleep before retry ``attempt`` (1-based), for the
        request identified by ``token`` (the batch head's ticket seq)."""
        base = min(self.base_ms * self.multiplier ** (attempt - 1),
                   self.max_ms) / 1e3
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        u = float(np.random.default_rng(
            (self.seed, int(token), int(attempt))).random())
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, TransientFault)

    @classmethod
    def from_spec(cls, spec: str) -> "RetryPolicy":
        """Parse the CLI form: ``"attempts=4,base_ms=2,jitter=0.5"``."""
        kwargs = {}
        names = {"attempts": "max_attempts", "max_attempts": "max_attempts",
                 "base_ms": "base_ms", "multiplier": "multiplier",
                 "max_ms": "max_ms", "jitter": "jitter", "seed": "seed"}
        for item in filter(None, (p.strip() for p in spec.split(","))):
            key, sep, value = item.partition("=")
            if not sep or key.strip() not in names:
                raise ValueError(f"unknown retry knob {item!r}; known: "
                                 f"{sorted(set(names))}")
            field = names[key.strip()]
            kwargs[field] = (int(value) if field in ("max_attempts", "seed")
                             else float(value))
        return cls(**kwargs)
