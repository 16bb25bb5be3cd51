"""Retry with exponential backoff, deterministic jitter, and
per-exception-class policies (counterpart of
``paddle_tpu/resilience/retry.py``: the same delays for the same seed).

Design points:

- **Deterministic jitter.** Thundering-herd protection normally wants
  randomness, but a chaos suite wants replayability — so jitter comes
  from a ``random.Random(seed)`` owned by the decorated callable, and
  two runs with the same seed produce the same delay sequence.  Seed it
  per host (e.g. ``seed=rank``) to spread a fleet.
- **Per-exception policies.** A flaky filesystem deserves patience; an
  assertion does not.  ``policies={TimeoutError: RetryPolicy(...)}``
  overrides the default policy for matching exception classes;
  an exception matching NO policy (and not ``retry_on``) re-raises
  immediately.
- **Telemetry.** Every retry records a ``resilience.retry`` span and
  bumps ``resilience_retries_total{fn=...}``; a call that eventually
  succeeds after retries records a recovery event — pairing with
  injected faults in the chaos report.
"""
from __future__ import annotations

import functools
import random
import time

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.resilience.faultinject import note_recovery

__all__ = ["RetryPolicy", "RetryExhausted", "retry", "compute_backoff"]


class RetryExhausted(RuntimeError):
    """Raised when every attempt failed; ``__cause__`` is the last
    underlying exception, ``attempts`` how many ran."""

    def __init__(self, fn_name, attempts, last):
        self.attempts = attempts
        super().__init__(
            f"{fn_name} failed after {attempts} attempts "
            f"({type(last).__name__}: {last})")


class RetryPolicy:
    """How to retry one class of failure.

    backoff delay for attempt k (0-based retry index) is::

        min(backoff * multiplier**k, max_backoff) * (1 + U(-jitter, 0))

    i.e. jitter only ever SHORTENS the wait (never exceeds the declared
    ceiling) and ``jitter=0`` is exact exponential backoff.
    """

    def __init__(self, max_attempts=3, backoff=0.05, multiplier=2.0,
                 max_backoff=30.0, jitter=0.5):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.backoff = float(backoff)
        self.multiplier = float(multiplier)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)

    def __repr__(self):
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"backoff={self.backoff}, multiplier={self.multiplier}, "
                f"max_backoff={self.max_backoff}, jitter={self.jitter})")


def compute_backoff(policy, attempt, rng):
    """Delay in seconds before retry `attempt` (0-based)."""
    base = min(policy.backoff * policy.multiplier ** attempt,
               policy.max_backoff)
    if policy.jitter:
        base *= 1.0 - rng.random() * policy.jitter
    return base


def _policy_for(exc, default, policies):
    for cls, pol in policies.items():
        if isinstance(exc, cls):
            return pol
    return default


def retry(fn=None, *, max_attempts=3, backoff=0.05, multiplier=2.0,
          max_backoff=30.0, jitter=0.5, retry_on=(Exception,),
          policies=None, seed=0, sleep=time.sleep, on_retry=None):
    """Decorator (bare or parameterized)::

        @retry(max_attempts=5, backoff=0.1,
               policies={OSError: RetryPolicy(max_attempts=8)})
        def flaky_write(...): ...

    `retry_on` bounds which exceptions are retryable AT ALL under the
    default policy; `policies` maps exception classes to dedicated
    :class:`RetryPolicy` overrides (checked first, so a class can be
    retryable via `policies` without widening `retry_on`).
    `on_retry(exc, attempt, delay)` observes each scheduled retry.
    """
    if fn is not None and callable(fn):          # bare @retry form
        return retry()(fn)
    default = RetryPolicy(max_attempts, backoff, multiplier, max_backoff,
                          jitter)
    policies = dict(policies or {})

    def deco(f):
        name = getattr(f, "__qualname__", repr(f))

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            rng = random.Random(seed)
            attempt = 0
            while True:
                try:
                    out = f(*args, **kwargs)
                    if attempt:
                        note_recovery("retry", "exception", fn=name,
                                      attempts=attempt + 1)
                    return out
                except Exception as e:
                    pol = _policy_for(e, None, policies)
                    if pol is None:
                        if not isinstance(e, tuple(retry_on)):
                            raise
                        pol = default
                    attempt += 1
                    if attempt >= pol.max_attempts:
                        raise RetryExhausted(name, attempt, e) from e
                    delay = compute_backoff(pol, attempt - 1, rng)
                    _record_retry(name, e, attempt, delay)
                    if on_retry is not None:
                        on_retry(e, attempt, delay)
                    if delay > 0:
                        sleep(delay)

        wrapper.retry_policy = default
        return wrapper

    return deco


def _record_retry(name, exc, attempt, delay):
    try:
        with obs.span("resilience.retry", fn=name, attempt=attempt,
                      exc=type(exc).__name__, delay_s=round(delay, 4)):
            pass
        obs.registry().counter(
            "resilience_retries_total", labels={"fn": name},
            help="retries scheduled by resilience.retry").inc()
    except Exception:
        pass
