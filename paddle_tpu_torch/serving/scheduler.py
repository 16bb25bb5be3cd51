"""Admission scheduling: FCFS queue, page-budget policy, and the
prompt-length bucketing (a copy of ``paddle_tpu/serving/scheduler.py``).

Bucketing: every prefill runs at one of ``len(buckets)`` padded
shapes and decode at exactly one shape, so the set of shapes the model
ever sees is closed and known up front.

Admission is strict FCFS with head-of-line blocking: if the oldest
waiting request does not fit (no free slot, or the page budget can't
cover its bucketed prompt plus one growth page), nothing behind it is
admitted either.  Skipping ahead would starve long prompts forever on a
busy pool; head-of-line blocking keeps latency ordering predictable.

Preemption is deterministic: when decode needs a page and the pool is
dry, the LATEST-arrived running request is evicted (LIFO victim — the
request that has consumed the least scheduler goodwill), its pages are
freed, and it re-enters the waiting queue at the front.
"""
from __future__ import annotations

from collections import deque

from paddle_tpu_torch.serving.request import RequestState

__all__ = ["AdmissionRejected", "bucket_for", "default_buckets",
           "Scheduler"]


class AdmissionRejected(RuntimeError):
    """Explicit backpressure: the engine refuses NEW work (bounded
    admission queue full, or the health state machine is DRAINING)
    instead of queueing unboundedly.  Callers retry elsewhere / later —
    `reason` is machine-readable ("queue_full" | "draining")."""

    def __init__(self, reason, detail=""):
        self.reason = reason
        super().__init__(f"admission rejected ({reason})"
                         + (f": {detail}" if detail else ""))


def default_buckets(max_model_len, smallest=16):
    """Powers-of-two padded prompt lengths up to max_model_len."""
    buckets = []
    b = smallest
    while b < max_model_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_model_len)
    return tuple(buckets)


def bucket_for(length, buckets):
    """Smallest bucket >= length; raises when the prompt can't fit."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"prompt length {length} exceeds the largest bucket "
        f"{buckets[-1]} — raise max_model_len / add a bucket")


class Scheduler:
    """FCFS admission with a page-budget gate.

    The scheduler owns the WAITING queue only; running-state ownership
    (slots, allocator) stays with the engine, which passes the relevant
    views in.  Keeping the policy pure over those views makes it
    unit-testable without compiling anything.
    """

    def __init__(self, buckets, page_size, growth_reserve_pages=1,
                 max_queue_depth=None):
        self.buckets = tuple(sorted(buckets))
        self.page_size = int(page_size)
        # pages kept back per admission so one decode step can always
        # grow the newly admitted sequence without instant preemption
        self.growth_reserve_pages = int(growth_reserve_pages)
        # bounded admission: NEW enqueues past this depth raise
        # AdmissionRejected (None = unbounded, the historical behavior)
        self.max_queue_depth = (int(max_queue_depth)
                                if max_queue_depth is not None else None)
        self._waiting = deque()

    # ---- queue ----
    def enqueue(self, request):
        if self.max_queue_depth is not None and \
                len(self._waiting) >= self.max_queue_depth:
            raise AdmissionRejected(
                "queue_full",
                f"waiting queue at max_queue_depth={self.max_queue_depth}")
        self._waiting.append(request)

    def requeue_front(self, request):
        """Evicted requests keep their FCFS priority.  Exempt from the
        queue bound: the request was already admitted once, and
        dropping it here would turn a preemption into a data loss."""
        self._waiting.appendleft(request)

    def withdraw(self, request):
        """Remove a still-WAITING request from the queue (generate()
        unwinding a partially-enqueued batch under backpressure).
        Missing is fine — the request may already have been rejected."""
        try:
            self._waiting.remove(request)
        except ValueError:
            pass

    def drain_waiting(self):
        """Remove and return EVERY waiting request in queue order (the
        router's drain hook: still-queued work migrates to another
        replica instead of waiting out this one's retirement)."""
        out = list(self._waiting)
        self._waiting.clear()
        return out

    def pop_expired(self, now):
        """Remove and return every waiting request whose deadline has
        passed (deterministic: queue order preserved for survivors)."""
        expired = [r for r in self._waiting if r.past_deadline(now)]
        if expired:
            self._waiting = deque(r for r in self._waiting
                                  if not r.past_deadline(now))
        return expired

    @property
    def queue_depth(self):
        return len(self._waiting)

    def has_waiting(self):
        return bool(self._waiting)

    def peek(self):
        return self._waiting[0] if self._waiting else None

    # ---- policy ----
    def pages_for_prompt(self, prompt_len):
        """Pages an admission must secure: the FULL bucketed shape is
        never written (padding is routed to the garbage page), so only
        the real prompt length counts, plus the growth reserve."""
        return (-(-prompt_len // self.page_size)
                + self.growth_reserve_pages)

    def admissible(self, request, free_slots, free_pages):
        """Can `request` be admitted right now?"""
        if free_slots <= 0:
            return False
        need = self.pages_for_prompt(len(request.replay_token_ids))
        return need <= free_pages

    def pop_admissible(self, free_slots, free_pages):
        """Pop the queue head if it fits (strict FCFS: a non-fitting
        head blocks everything behind it). Returns None when nothing is
        admissible."""
        if not self._waiting:
            return None
        head = self._waiting[0]
        if not self.admissible(head, free_slots, free_pages):
            return None
        return self._waiting.popleft()

    def select_victim(self, running):
        """Deterministic preemption: evict the latest-arrived DECODE
        request. Returns None when there is nothing to evict."""
        candidates = [r for r in running
                      if r.state == RequestState.DECODE]
        if not candidates:
            return None
        return max(candidates, key=lambda r: r.arrival_index)

    def bucket_for_len(self, length):
        return bucket_for(length, self.buckets)
