"""Request/sequence state machine for the serving engine (a copy of
``paddle_tpu/serving/request.py``).

Lifecycle::

    WAITING --admit--> PREFILL --first token--> DECODE --stop--> FINISHED
       ^                                          |
       '--------------- EVICTED <--preempted------'

EVICTED requests re-enter at the FRONT of the waiting queue (they were
admitted once, so FCFS priority says they go first) and are replayed by
prefilling ``prompt + tokens generated so far`` — sampling seeds fold in
the absolute token position, so a replayed request regenerates the exact
same continuation it would have produced uninterrupted.
"""
from __future__ import annotations

import enum


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    EVICTED = "evicted"


# legal transitions; anything else is an engine bug.  WAITING/EVICTED
# may go straight to FINISHED: deadline expiry finishes a queued
# request without it ever (re-)reaching a slot.
_TRANSITIONS = {
    RequestState.WAITING: {RequestState.PREFILL, RequestState.FINISHED},
    RequestState.PREFILL: {RequestState.DECODE, RequestState.FINISHED},
    RequestState.DECODE: {RequestState.FINISHED, RequestState.EVICTED},
    RequestState.EVICTED: {RequestState.PREFILL, RequestState.FINISHED},
    RequestState.FINISHED: set(),
}


class SamplingParams:
    """Per-request sampling configuration.

    temperature == 0 means greedy (argmax); top_k <= 0 and top_p >= 1
    disable those filters. `seed` + the absolute token position fully
    determine each draw, so generation is batch-composition independent
    (continuous batching, sequential decode, and preemption replay all
    produce identical tokens).

    `deadline_s` is a per-request TTL measured from arrival: a request
    still queued (or still decoding) past its deadline is finished with
    ``finish_reason="deadline"`` at the next step boundary — enforced
    deadline semantics rather than unbounded queueing.
    """

    def __init__(self, max_new_tokens=16, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0, eos_token_id=None, deadline_s=None):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.eos_token_id = eos_token_id
        self.deadline_s = float(deadline_s) if deadline_s is not None \
            else None

    def __repr__(self):
        return (f"SamplingParams(max_new_tokens={self.max_new_tokens}, "
                f"temperature={self.temperature}, top_k={self.top_k}, "
                f"top_p={self.top_p}, seed={self.seed}, "
                f"eos_token_id={self.eos_token_id}, "
                f"deadline_s={self.deadline_s})")


class Request:
    """One generation request moving through the engine.

    `stream` is an optional ``callback(request, token_id, finished)``
    invoked once per NEW token (replayed tokens after an eviction are
    not re-streamed).
    """

    def __init__(self, request_id, prompt_token_ids, sampling_params,
                 arrival_index, stream=None):
        if not prompt_token_ids:
            raise ValueError("prompt must contain at least one token")
        self.request_id = request_id
        self.prompt_token_ids = list(prompt_token_ids)
        self.sampling_params = sampling_params
        self.arrival_index = int(arrival_index)  # FCFS / victim ordering
        self.stream = stream
        self.state = RequestState.WAITING
        self.output_token_ids = []
        self._streamed = 0          # tokens already delivered to `stream`
        self._stream_done = False   # final last=True signal sent
        self.slot = None            # decode batch slot while running
        self.num_evictions = 0
        self.num_guard_evictions = 0    # evictions by the serving guard
        # distributed-trace identity (observability.TraceContext, the
        # one ambient at add_request) or None
        self.trace = None
        # set when adopted onto this engine; cleared when the first
        # resumed token observes the ttft_decode stage histogram
        self._resume_t = None
        # "stop" | "length" | "deadline" | "anomaly"
        self.finish_reason = None
        # metrics timestamps (host clocks; filled by the engine)
        self.deadline_t = None      # arrive_t + deadline_s, or None
        self.arrive_t = None
        self.first_token_t = None
        self.finish_t = None
        self.last_token_t = None

    # ---- state machine ----
    def transition(self, new_state):
        if new_state not in _TRANSITIONS[self.state]:
            raise RuntimeError(
                f"illegal request transition {self.state.value} -> "
                f"{new_state.value} (request {self.request_id})")
        self.state = new_state

    # ---- derived views ----
    @property
    def replay_token_ids(self):
        """What a (re-)prefill must feed the model: the prompt plus any
        tokens already generated before an eviction."""
        return self.prompt_token_ids + self.output_token_ids

    @property
    def total_len(self):
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def is_finished(self):
        return self.state == RequestState.FINISHED

    def append_token(self, token_id, now=None):
        """Record a newly sampled token; returns True if it was NEW
        (not a replay duplicate — replays never reach here because the
        engine re-prefills rather than re-samples)."""
        self.output_token_ids.append(int(token_id))
        if self.first_token_t is None and now is not None:
            self.first_token_t = now
        self.last_token_t = now
        return True

    def deliver(self, finished):
        """Stream not-yet-delivered tokens to the callback.  A finish
        with nothing left to stream (deadline expiry of a queued
        request, tokens already drained) still fires one final
        ``(request, None, True)`` completion signal — a stream consumer
        must never wait forever for its ``last=True``."""
        if self.stream is None:
            self._streamed = len(self.output_token_ids)
            return
        toks = self.output_token_ids
        while self._streamed < len(toks):
            t = toks[self._streamed]
            self._streamed += 1
            last = finished and self._streamed == len(toks)
            if last:
                self._stream_done = True
            self.stream(self, t, last)
        if finished and not self._stream_done:
            self._stream_done = True
            self.stream(self, None, True)

    def past_deadline(self, now):
        return self.deadline_t is not None and now >= self.deadline_t

    def should_stop(self):
        """Returns the finish reason if the request is done, else None."""
        sp = self.sampling_params
        if (sp.eos_token_id is not None and self.output_token_ids
                and self.output_token_ids[-1] == sp.eos_token_id):
            return "stop"
        if len(self.output_token_ids) >= sp.max_new_tokens:
            return "length"
        return None

    def __repr__(self):
        return (f"Request({self.request_id}, state={self.state.value}, "
                f"prompt={len(self.prompt_token_ids)}t, "
                f"out={len(self.output_token_ids)}t, slot={self.slot})")


class GenerationResult:
    """What `LLMEngine.generate` returns per prompt."""

    def __init__(self, request):
        self.request_id = request.request_id
        self.prompt_token_ids = list(request.prompt_token_ids)
        self.output_token_ids = list(request.output_token_ids)
        self.finish_reason = request.finish_reason
        self.num_evictions = request.num_evictions

    def __repr__(self):
        return (f"GenerationResult({self.request_id}, "
                f"{len(self.output_token_ids)} tokens, "
                f"finish={self.finish_reason})")
