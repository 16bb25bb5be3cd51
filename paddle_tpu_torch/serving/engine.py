"""LLMEngine — continuous-batching serving over a paged KV cache
(counterpart of ``paddle_tpu/serving/engine.py``).

Execution model, as in the reference:

- PREFILL one request at a time at a padded prompt-length bucket
  (``[1, bucket]`` token ids): dense causal attention, the real tokens'
  K/V scattered into the shared paged pools, the last REAL token's
  logits out;
- DECODE at the full slot width ``[max_num_seqs, 1]``: every live
  sequence appends its token at its own length and attends over its own
  pages; empty slots decode garbage rows against page 0;
- sampling per width (1 and max_num_seqs) with every knob per row.

Continuous batching: new requests join the running decode batch at step
boundaries, finished sequences free their pages immediately, and when
the pool runs dry the latest-arrived running request is
deterministically preempted (replayed later by prefilling prompt +
generated tokens; the (seed, position) sampler makes the replay
token-identical).

PyTorch runs eagerly, so there are no compiled programs and no compile
bound. Not ported yet: tensor-parallel meshes, quantized KV pools, the
serving guard, the AOT program cache, crash-safe decode, the router,
fleet and traffic hooks, and tracing spans.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.incubate.nn.paged_attention import (
    PageAllocator, paged_decode_step, paged_prefill_append)
from paddle_tpu_torch.resilience.health import HealthMonitor
from paddle_tpu_torch.serving.metrics import EngineMetrics
from paddle_tpu_torch.serving.request import (GenerationResult, Request,
                                              RequestState, SamplingParams)
from paddle_tpu_torch.serving.sampler import sample_tokens
from paddle_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                Scheduler, default_buckets)

__all__ = ["AdmissionRejected", "EngineConfig", "LLMEngine",
           "PagedKVContext"]

_NARROW = (torch.bfloat16, torch.float16)


class EngineConfig:
    """Sizing and shape-bucketing knobs for :class:`LLMEngine`.

    - `max_num_seqs`: decode batch width B (slots).
    - `page_size` / `num_pages`: shared-pool geometry.  The default pool
      holds every slot at `max_model_len` (no preemption pressure);
      size it DOWN to oversubscribe memory and exercise preemption.
    - `prefill_buckets`: the closed set of padded prompt shapes.
    - `eos_token_id`: default stop token for requests that don't set one.
    - `dtype`: the KV pools' dtype.
    - `max_queue_depth`: bounded admission — `add_request` past this
      waiting-queue depth raises :class:`AdmissionRejected`.
    - `health_*`: thresholds for the HEALTHY→DEGRADED→DRAINING state
      machine driven by live page-pool occupancy; DRAINING rejects new
      admissions until pressure falls.

    `mesh`, `kv_cache_dtype` and `guard` are not ported yet and raise
    NotImplementedError when set.
    """

    def __init__(self, max_num_seqs=8, page_size=16, max_model_len=256,
                 num_pages=None, prefill_buckets=None,
                 growth_reserve_pages=1, eos_token_id=None,
                 dtype=torch.float32, finished_retention=1024,
                 max_queue_depth=None, health_degraded_at=0.85,
                 health_drain_at=0.97, health_recover_at=0.70, mesh=None,
                 kv_cache_dtype=None, guard=False):
        for name, value, unset in (("mesh", mesh, None),
                                   ("kv_cache_dtype", kv_cache_dtype, None),
                                   ("guard", guard, False)):
            if value != unset:
                raise NotImplementedError(
                    f"EngineConfig({name}=...) is not ported yet")
        if max_num_seqs < 1:
            raise ValueError("max_num_seqs must be >= 1")
        self.max_num_seqs = int(max_num_seqs)
        self.page_size = int(page_size)
        self.max_model_len = int(max_model_len)
        self.max_pages_per_seq = -(-self.max_model_len // self.page_size)
        if num_pages is None:
            num_pages = self.max_num_seqs * self.max_pages_per_seq + 1
        self.num_pages = int(num_pages)
        if prefill_buckets is None:
            prefill_buckets = default_buckets(self.max_model_len)
        buckets = tuple(sorted(int(b) for b in prefill_buckets))
        if not buckets or buckets[-1] > self.max_model_len:
            raise ValueError(
                f"prefill_buckets {buckets} must be non-empty and "
                f"<= max_model_len {self.max_model_len}")
        self.prefill_buckets = buckets
        self.growth_reserve_pages = int(growth_reserve_pages)
        self.eos_token_id = eos_token_id
        self.dtype = dtype
        self.finished_retention = int(finished_retention)
        self.max_queue_depth = (int(max_queue_depth)
                                if max_queue_depth is not None else None)
        self.health_degraded_at = float(health_degraded_at)
        self.health_drain_at = float(health_drain_at)
        self.health_recover_at = float(health_recover_at)


class PagedKVContext:
    """The cache-aware attention hook handed to ``model(..., kv_ctx=)``.

    It carries the per-layer pools and a layer cursor; each attention
    layer calls :meth:`attend` exactly once per forward.

    - mode "prefill": dense causal attention over the (padded) prompt —
      the padded tail only pollutes its own discarded rows — plus a
      batched scatter of the real tokens' K/V into the pages.
    - mode "decode": one-token append + attention over the row's pages
      at its own length (ragged).

    Pool writes are in place.
    """

    def __init__(self, k_pools, v_pools, tables, lens, page_size, mode):
        self.k_pools = k_pools
        self.v_pools = v_pools
        self.tables = tables
        self.lens = lens
        self.page_size = page_size
        self.mode = mode
        self._layer = 0

    def attend(self, q, k, v):
        """q/k/v ``[b, s, n_head, head_dim]`` -> the attention output,
        same shape; writes this layer's K/V into its pools."""
        li = self._layer
        self._layer += 1
        if li >= len(self.k_pools):
            raise RuntimeError(
                f"model has more attention layers ({li + 1}+) than the "
                f"engine allocated pools for ({len(self.k_pools)})")
        qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))   # [b,h,s,d]
        if self.mode == "prefill":
            out = _dense_causal_attention(qT, kT, vT)
            paged_prefill_append(kT, vT, self.k_pools[li], self.v_pools[li],
                                 self.tables, self.lens, self.page_size)
        else:
            out, _, _ = paged_decode_step(
                qT, kT, vT, self.k_pools[li], self.v_pools[li], self.tables,
                self.lens, self.page_size)
        return out.transpose(1, 2)                              # [b,s,h,d]


def _dense_causal_attention(q, k, v):
    """``[b, h, s, d]`` causal attention with an f32 softmax. Narrow
    (bf16/fp16) inputs accumulate both contractions in f32 and round
    once at the output."""
    d = q.shape[-1]
    s = q.shape[2]
    narrow = q.dtype in _NARROW
    # sqrt(d) rounded to q's type, as the reference divides by it
    qs = q / float(torch.tensor(math.sqrt(d)).to(q.dtype))
    if narrow:
        scores = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    else:
        scores = torch.matmul(qs, k.transpose(-1, -2))      # [b, h, s, s]
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores.float(),
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if narrow:
        return torch.matmul(probs.float(), v.float()).to(q.dtype)
    return torch.matmul(probs, v)


class LLMEngine:
    """Continuous-batching engine over any kv_ctx-aware decoder model.

    The model contract (`models/gpt.py` is the reference attach point):

    - ``model.config`` exposes ``num_layers``, ``num_heads``,
      ``hidden_size`` (head_dim = hidden_size // num_heads);
    - ``model(input_ids, position_ids=..., kv_ctx=...)`` returns
      ``[b, s, vocab]`` logits, with every attention layer delegating to
      ``kv_ctx.attend(q, k, v)`` when a context is passed.

    The engine runs on ``device`` (default CUDA; RuntimeError without it
    unless ``device="cpu"``), where the model must already live.

    Public surface: :meth:`add_request`, :meth:`step`, :meth:`generate`,
    :attr:`metrics`, :meth:`shutdown`.
    """

    def __init__(self, model, config=None, device=None, program_cache=None):
        if program_cache is not None:
            raise NotImplementedError(
                "LLMEngine(program_cache=...) is not ported yet")
        self.config = config or EngineConfig()
        cfg = self.config
        self.device = resolve_device(device)
        for p in model.parameters():
            if p.device != self.device:
                raise ValueError(
                    f"model parameters are on {p.device}, the engine runs "
                    f"on {self.device}: build the model there")
        self._model = model
        model.eval()
        mc = model.config
        self._num_layers = int(mc.num_layers)
        self._num_heads = int(mc.num_heads)
        self._head_dim = int(mc.hidden_size) // int(mc.num_heads)
        if cfg.max_model_len > int(getattr(mc, "max_seq_len",
                                           cfg.max_model_len)):
            raise ValueError(
                f"max_model_len {cfg.max_model_len} exceeds the model's "
                f"max_seq_len {mc.max_seq_len}")

        B, P = cfg.max_num_seqs, cfg.max_pages_per_seq
        pool_shape = (cfg.num_pages, self._num_heads, cfg.page_size,
                      self._head_dim)
        self._k_pools = [torch.zeros(pool_shape, dtype=cfg.dtype,
                                     device=self.device)
                         for _ in range(self._num_layers)]
        self._v_pools = [torch.zeros(pool_shape, dtype=cfg.dtype,
                                     device=self.device)
                         for _ in range(self._num_layers)]
        self._tables = np.zeros((B, P), np.int64)      # host-canonical
        self._lens = np.zeros((B,), np.int64)          # host-canonical
        self._alloc = PageAllocator(cfg.num_pages, B, P)
        self._slots = [None] * B                       # Request | None

        self.scheduler = Scheduler(cfg.prefill_buckets, cfg.page_size,
                                   cfg.growth_reserve_pages,
                                   max_queue_depth=cfg.max_queue_depth)
        self.metrics = EngineMetrics()
        self.metrics.pages_total = cfg.num_pages - 1   # page 0 reserved
        self.health = HealthMonitor(
            degraded_at=cfg.health_degraded_at,
            drain_at=cfg.health_drain_at,
            recover_at=cfg.health_recover_at)
        self._requests = {}          # live (queued or running) only
        self.finished_requests = OrderedDict()
        self._next_id = 0

    # ------------------------------------------------------------ API
    def _resolve_params(self, sampling_params):
        """Fill in the engine-level eos default."""
        sp = sampling_params or SamplingParams(
            eos_token_id=self.config.eos_token_id)
        if sp.eos_token_id is None and self.config.eos_token_id is not None:
            sp = SamplingParams(
                max_new_tokens=sp.max_new_tokens,
                temperature=sp.temperature, top_k=sp.top_k,
                top_p=sp.top_p, seed=sp.seed,
                eos_token_id=self.config.eos_token_id,
                deadline_s=sp.deadline_s)
        return sp

    def _validate_request(self, prompt, sp):
        """Raise ValueError unless (prompt, sp) is servable end to end —
        called BEFORE anything is enqueued."""
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        total_max = len(prompt) + sp.max_new_tokens
        if total_max > self.config.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({sp.max_new_tokens}) = {total_max} exceeds "
                f"max_model_len {self.config.max_model_len}")
        # the WORST-CASE replay length must be bucketable: an eviction
        # after g generated tokens replays prompt + g through prefill
        self.scheduler.bucket_for_len(len(prompt) + sp.max_new_tokens - 1)
        need_total = max(
            self._alloc.pages_needed(total_max, self.config.page_size),
            self.scheduler.pages_for_prompt(total_max - 1))
        if need_total > self.config.num_pages - 1:
            raise ValueError(
                f"request needs up to {need_total} pages (incl. the "
                f"admission growth reserve) but the pool only has "
                f"{self.config.num_pages - 1}")

    def add_request(self, prompt_token_ids, sampling_params=None,
                    stream=None):
        """Queue one request; returns its request id.  Admission happens
        at the next :meth:`step` boundary.  Raises
        :class:`AdmissionRejected` under backpressure."""
        sp = self._resolve_params(sampling_params)
        prompt = [int(t) for t in prompt_token_ids]
        self._validate_request(prompt, sp)
        if not self.health.admitting:
            self.metrics.requests_rejected += 1
            raise AdmissionRejected(
                "draining",
                f"page-pool pressure {self.health.last_pressure:.2f}")
        rid = f"req-{self._next_id}"
        req = Request(rid, prompt, sp, arrival_index=self._next_id,
                      stream=stream)
        req.arrive_t = self.metrics.clock()
        if sp.deadline_s is not None:
            req.deadline_t = req.arrive_t + sp.deadline_s
        try:
            self.scheduler.enqueue(req)
        except AdmissionRejected:
            self.metrics.requests_rejected += 1
            raise
        self._next_id += 1
        self._requests[rid] = req
        self.metrics.requests_received += 1
        return rid

    def has_unfinished(self):
        return (self.scheduler.has_waiting()
                or any(r is not None for r in self._slots))

    def step(self):
        """One engine iteration: admit + prefill new requests at the
        step boundary, then one continuous-batched decode step.  Returns
        ``[(request_id, token_id, finished), ...]`` for tokens produced
        this step; a preemption surfaces as ``(request_id, None, False)``."""
        events = []
        self._expire_deadlines(events)
        admitted = self._admit(events)
        if any(r is not None for r in self._slots):
            self._decode_step(events)
        elif not admitted and self.scheduler.has_waiting() \
                and self.health.admitting:
            head = self.scheduler.peek()
            raise RuntimeError(
                f"scheduler deadlock: nothing running and request "
                f"{head.request_id} (prompt {len(head.replay_token_ids)} "
                f"tokens) cannot be admitted — the page pool "
                f"({self._alloc.num_free_pages} free) is too small")
        self._refresh_gauges()
        return events

    def generate(self, prompts, sampling_params=None):
        """Sync facade: serve `prompts` (list of token-id lists) to
        completion; returns :class:`GenerationResult` per prompt in
        input order."""
        if prompts and isinstance(prompts[0], int):
            raise TypeError("generate expects a LIST of prompts "
                            "(each a list of token ids)")
        if isinstance(sampling_params, (list, tuple)):
            if len(sampling_params) != len(prompts):
                raise ValueError("one SamplingParams per prompt required")
            sps = list(sampling_params)
        else:
            sps = [sampling_params] * len(prompts)
        # all-or-nothing: validate the whole batch BEFORE enqueueing
        pairs = [([int(t) for t in p], self._resolve_params(sp))
                 for p, sp in zip(prompts, sps)]
        for prompt, sp in pairs:
            self._validate_request(prompt, sp)
        rids = []
        try:
            for p, sp in pairs:
                rids.append(self.add_request(p, sp))
        except AdmissionRejected:
            for r in rids:
                self.scheduler.withdraw(self._requests.pop(r))
            raise
        reqs = [self._requests[r] for r in rids]
        while self.has_unfinished():
            self.step()
        for r in rids:
            self.finished_requests.pop(r, None)
        return [GenerationResult(req) for req in reqs]

    def shutdown(self):
        """Release the KV pools; the engine serves nothing after this."""
        self._k_pools = []
        self._v_pools = []

    # ----------------------------------------------------- deadlines
    def _expire_deadlines(self, events):
        """Step-boundary deadline sweep: queued requests past their TTL
        finish with reason "deadline"; running ones release their slot
        and pages first."""
        now = self.metrics.clock()
        expired = self.scheduler.pop_expired(now)
        for slot in range(self.config.max_num_seqs):
            r = self._slots[slot]
            if r is not None and r.past_deadline(now):
                expired.append(r)
        for req in expired:
            self.metrics.requests_expired += 1
            self._finish(req, "deadline", now)
            req.deliver(finished=True)
            events.append((req.request_id, None, True))

    # ----------------------------------------------------- admission
    def _admit(self, events):
        admitted = 0
        while True:
            free_slots = sum(1 for r in self._slots if r is None)
            req = self.scheduler.pop_admissible(free_slots,
                                                self._alloc.num_free_pages)
            if req is None:
                break
            self._prefill(req, events)
            admitted += 1
        return admitted

    def _prefill(self, req, events):
        cfg = self.config
        t0 = self.metrics.clock()
        req.transition(RequestState.PREFILL)
        tokens = req.replay_token_ids
        L = len(tokens)
        bucket = self.scheduler.bucket_for_len(L)
        slot = self._slots.index(None)
        self._slots[slot] = req
        req.slot = slot

        need = self._alloc.pages_needed(L, cfg.page_size)
        for pos, page in self._alloc.allocate(slot, need):
            self._tables[slot, pos] = page

        ids = np.zeros((1, bucket), np.int64)
        ids[0, :L] = tokens
        pos_ids = np.arange(bucket, dtype=np.int64)[None, :]
        ctx = PagedKVContext(self._k_pools, self._v_pools,
                             self._on_device(self._tables[slot:slot + 1]),
                             self._on_device(np.array([L])), cfg.page_size,
                             "prefill")
        logits = self._run_model(ids, pos_ids, ctx)
        # logits [1, bucket, V] -> the last REAL token's row
        last_logits = logits[:, L - 1].float()
        self._lens[slot] = L

        tok = self._sample(last_logits, [req], width=1)[0]
        now = self.metrics.clock()
        self.metrics.prefill_steps += 1
        self.metrics.prefill_step_s.observe(now - t0)
        self.metrics.prompt_tokens += L
        if req.num_evictions == 0:
            self.metrics.requests_admitted += 1
            self.metrics.ttft.observe(now - req.arrive_t)
        req.append_token(tok, now=now)
        self.metrics.generated_tokens += 1
        self._post_token(req, events, now)
        if not req.is_finished:
            req.transition(RequestState.DECODE)

    # -------------------------------------------------------- decode
    def _decode_step(self, events):
        cfg = self.config
        t0 = self.metrics.clock()
        # capacity pass: every live row must fit one more token; the
        # pool running dry preempts the latest-arrived running request
        for slot in range(cfg.max_num_seqs):
            req = self._slots[slot]
            if req is None:
                continue
            need = self._alloc.pages_needed(
                int(self._lens[slot]) + 1, cfg.page_size)
            while not self._alloc.can_allocate(slot, need):
                victim = self.scheduler.select_victim(
                    [r for r in self._slots if r is not None])
                if victim is None:
                    raise RuntimeError(
                        "paged pool exhausted with nothing left to "
                        "preempt")
                self._evict(victim, events)
                if victim is req:
                    break
            if self._slots[slot] is None:
                continue                       # row preempted itself
            for pos, page in self._alloc.allocate(slot, need):
                self._tables[slot, pos] = page

        live = [(s, r) for s, r in enumerate(self._slots) if r is not None]
        if not live:
            return
        tokens = np.zeros((cfg.max_num_seqs, 1), np.int64)
        for s, r in live:
            tokens[s, 0] = r.output_token_ids[-1]

        ctx = PagedKVContext(self._k_pools, self._v_pools,
                             self._on_device(self._tables),
                             self._on_device(self._lens), cfg.page_size,
                             "decode")
        # each row's position is its cache length
        logits = self._run_model(tokens, self._lens[:, None], ctx)
        logits = logits[:, 0].float()

        toks = self._sample(logits, list(self._slots),
                            width=cfg.max_num_seqs)
        for s, r in live:
            self._lens[s] += 1
        now = self.metrics.clock()
        self.metrics.decode_steps += 1
        self.metrics.decode_step_s.observe(now - t0)
        for s, r in live:
            if r.last_token_t is not None:
                self.metrics.inter_token.observe(now - r.last_token_t)
            r.append_token(toks[s], now=now)
            self.metrics.generated_tokens += 1
            self._post_token(r, events, now)

    # ------------------------------------------------------ sampling
    def _sample(self, logits, reqs, width):
        """reqs: per-row Request or None (padding rows).  Position is
        the ABSOLUTE index of the token being sampled = the row's cache
        length AFTER its input token was appended = `total_len`."""
        seeds = [0] * width
        pos = [0] * width
        temps = np.zeros((width,), np.float32)
        top_ks = np.zeros((width,), np.int32)
        top_ps = np.ones((width,), np.float32)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            sp = r.sampling_params
            seeds[i] = sp.seed
            pos[i] = r.total_len
            temps[i] = sp.temperature
            top_ks[i] = sp.top_k
            top_ps[i] = sp.top_p
        out = sample_tokens(logits, seeds, pos, temps, top_ks, top_ps)
        return out.tolist()

    # ------------------------------------------------- finish / evict
    def _post_token(self, req, events, now):
        reason = req.should_stop()
        if reason is not None:
            self._finish(req, reason, now)
        req.deliver(finished=req.is_finished)
        events.append((req.request_id, req.output_token_ids[-1],
                       req.is_finished))

    def _finish(self, req, reason, now):
        req.finish_reason = reason
        req.transition(RequestState.FINISHED)
        if req.slot is not None:     # queued deadline expiry has none
            self._release_slot(req)
        req.finish_t = now
        self.metrics.requests_finished += 1
        self.metrics.e2e_latency.observe(now - req.arrive_t)
        self._requests.pop(req.request_id, None)
        self.finished_requests[req.request_id] = req
        while len(self.finished_requests) > self.config.finished_retention:
            self.finished_requests.popitem(last=False)

    def _evict(self, req, events):
        """Deterministic preemption: free everything, requeue at the
        queue front; the replay prefill later reconstructs the cache
        from prompt + generated tokens."""
        req.transition(RequestState.EVICTED)
        self._release_slot(req)
        req.num_evictions += 1
        self.metrics.requests_evicted += 1
        self.scheduler.requeue_front(req)
        events.append((req.request_id, None, False))

    def _release_slot(self, req):
        slot = req.slot
        self._alloc.release(slot)
        self._tables[slot, :] = 0
        self._lens[slot] = 0
        self._slots[slot] = None
        req.slot = None

    def _refresh_gauges(self):
        m = self.metrics
        m.queue_depth = self.scheduler.queue_depth
        m.running = sum(1 for r in self._slots if r is not None)
        m.pages_in_use = (self.config.num_pages - 1
                          - self._alloc.num_free_pages)
        state = self.health.update(
            m.pages_in_use / m.pages_total if m.pages_total else 0.0)
        m.health = state.name.lower()

    # --------------------------------------------------------- model
    def _on_device(self, array):
        """A device copy of a host array (never a view of it: the host
        copy changes after the step)."""
        return torch.tensor(array, dtype=torch.int64, device=self.device)

    def _run_model(self, ids, pos_ids, ctx):
        with torch.no_grad():
            return self._model(self._on_device(ids),
                               position_ids=self._on_device(pos_ids),
                               kv_ctx=ctx)
