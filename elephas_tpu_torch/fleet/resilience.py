"""Retry/backoff constants and the backoff step of the parameter client.

Copied into the port from ``elephas_tpu/fleet/resilience.py``
(host-only: no JAX): only what ``parameter/client.py`` imports, the
three parameter-plane retry constants and :func:`backoff_pause_s`. The
JAX module's ``RetryPolicy``, ``RetryBudget`` and ``CircuitBreaker``
and the serving fleet's constants serve the fleet router, the
disaggregated engine and the sharded parameter plane, which the port
does not have yet.
"""
import random
from typing import Optional

__all__ = ["backoff_pause_s", "RETRY_BACKOFF_BASE_S", "RETRY_BACKOFF_MAX_S",
           "RETRY_MAX_RETRIES"]

#: first backoff pause for a transient RPC failure (parameter-plane
#: clients; seed of the decorrelated-jitter sequence)
RETRY_BACKOFF_BASE_S = 0.2
#: ceiling on any single backoff pause (parameter-plane clients)
RETRY_BACKOFF_MAX_S = 5.0
#: per-request retry budget for point RPCs (parameter-plane clients:
#: 1 initial attempt + this many retries)
RETRY_MAX_RETRIES = 3

# process-wide jitter source for call sites that don't inject their
# own; intentionally unseeded (backoff jitter must differ across
# processes — determinism-seeking tests pass their own ``rng``)
_JITTER_RNG = random.Random()


def backoff_pause_s(prev_pause: float,
                    base: float = RETRY_BACKOFF_BASE_S,
                    cap: float = RETRY_BACKOFF_MAX_S,
                    rng: Optional[random.Random] = None) -> float:
    """One step of capped decorrelated-jitter backoff (AWS-style):
    ``min(cap, uniform(base, prev * 3))``. Unlike plain exponential+
    jitter this decorrelates concurrent clients quickly while keeping
    the expected pause growing geometrically. Pass ``prev_pause=0`` for
    the first retry."""
    rng = rng or _JITTER_RNG
    return min(cap, rng.uniform(base, max(base, prev_pause * 3.0)))
