"""LLMEngine — continuous-batching serving over a paged KV cache
(counterpart of ``paddle_tpu/serving/engine.py``).

Execution model, as in the reference: a small, fixed set of programs
serves every request mix —

- one PREFILL program per prompt-length bucket: ``[1, bucket]`` token
  ids in, dense causal attention, the real tokens' K/V scattered into
  the shared paged pools, the last REAL token's logits out;
- ONE DECODE program at the full slot width ``[max_num_seqs, 1]``:
  every live sequence appends its token at its own length and attends
  over its own pages; empty slots decode garbage rows against page 0;
- one SAMPLER program per width (1 and max_num_seqs) with every knob
  per row as an operand.

Each program is a function of device tensors only (the pools are
written in place). On CUDA the engine captures each one as a CUDA graph
the first time it is needed (or all of them in :meth:`LLMEngine.warmup`)
and from then on replays it: a call copies the step's host arrays into
the graph's static input buffers, replays, and returns its static
output, which the next call of the same program overwrites. A step's
one host read is the sampler's tokens. On the CPU the same functions run
uncaptured. Either way at most ``EngineConfig.compile_bound =
len(prefill_buckets) + 3`` programs are built for the life of the
engine, and `EngineMetrics.note_compile` raises past it. A capture that
fails raises: there is no eager fallback.

Continuous batching: new requests join the running decode batch at step
boundaries, finished sequences free their pages immediately, and when
the pool runs dry the latest-arrived running request is
deterministically preempted (replayed later by prefilling prompt +
generated tokens; the (seed, position) sampler makes the replay
token-identical).

Options, as in the reference: ``kv_cache_dtype`` stores the pools as
per-page-scaled ``(codes, scales)`` pairs
(:mod:`paddle_tpu_torch.quantization.kv_cache`); ``guard`` makes the
decode program also return ``[B, 2]`` anomaly flags (a non-finite
logits row; a non-finite or too large page scale), read after the
sampler's tokens, and a flagged request is evicted and requeued (its
token dropped), or finished with ``"anomaly"`` past
``guard_requeue_limit``; with
``crash_safe_decode`` an exception at a decode step evicts the offending
request instead of raising. The fault sites ``serving.pool``,
``serving.decode`` and ``serving.logits`` fire where the reference's do.
``serving.decode`` fires on the host before the replay, so a faulted
step has written nothing; a decode step that does run is idempotent
anyway (it writes position ``lens[s]`` of each row, which advances only
after it, and a quantized append that repeats sees the grown scale and
re-grids by exactly 1.0).

Router hooks, as the reference's: :meth:`LLMEngine.adopt_request` takes a
request that generated tokens on another engine at the queue front, in
the evicted-replay posture, and :meth:`LLMEngine.release_waiting` hands
every still-queued request back to its caller (the router's drain).

AOT program cache (``program_cache=``, :mod:`.aot_cache`): a CUDA graph
cannot be written to disk, so a cold build stores what it learned (the
program's input and output signature and a digest of its output on the
zero example) and a later engine's warm build reads it: the output
buffers come from the record, so it skips the cold build's two eager
warm-up calls when the same program has already run eagerly in this
process (every engine of the process captures on one shared capture
stream), and one of them otherwise (a fresh process: the program's lazy
set-up, its kernels' loading, happens in that call, not in the capture);
then it captures, replays once and holds the replay against the digest
(a mismatch drops the entry and builds cold). ``warmup()``'s
``compiled`` counts cold builds and ``cache_loads`` warm ones; both stay
under ``compile_bound``.

Observability, as the reference's: the engine's instruments live in the
process-wide registry under ``{"engine": metrics_name}``, its
``metrics.snapshot()`` is registered there as a source (weakly; removed
by :meth:`LLMEngine.shutdown`), every program build is a
``serving-aot`` event of the recompile log, and spans mark admission,
deadlines, each prefill and decode step, guard and fault evictions,
preemptions, program builds, and (for a request added under a
:class:`~paddle_tpu_torch.observability.TraceContext`) its finish. A
span reads host clocks only: a decode step keeps its one wait, the
sampler's tokens.

Not ported yet: tensor-parallel meshes, and the fleet's page hand-off
(``export_page_state`` / ``import_page_state``, ROADMAP A.4).
"""
from __future__ import annotations

import math
import os
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from paddle_tpu_torch.core import cuda_graph
from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.observability import (TraceContext, current_context,
                                            next_instance_label,
                                            note_aot_compile, registry, span)
from paddle_tpu_torch.incubate.nn.paged_attention import (
    PageAllocator, paged_decode_step, paged_prefill_append)
from paddle_tpu_torch.quantization.kv_cache import (
    quantized_decode_step, quantized_prefill_append, resolve_kv_cache_dtype)
from paddle_tpu_torch.resilience.faultinject import fire as _fire
from paddle_tpu_torch.resilience.faultinject import note_recovery
from paddle_tpu_torch.resilience.health import HealthMonitor
from paddle_tpu_torch.resilience.sentinel import note_anomaly
from paddle_tpu_torch.serving.aot_cache import (AOTProgramCache,
                                                engine_fingerprint,
                                                output_digest, signature)
from paddle_tpu_torch.serving.metrics import EngineMetrics
from paddle_tpu_torch.serving.request import (GenerationResult, Request,
                                              RequestState, SamplingParams)
from paddle_tpu_torch.serving.sampler import sample_tokens
from paddle_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                Scheduler, default_buckets)

__all__ = ["AdmissionRejected", "EngineConfig", "LLMEngine",
           "PagedKVContext"]

_NARROW = (torch.bfloat16, torch.float16)
# one capture stream a device, shared by the process's engines (cuBLAS's
# workspace is the stream's), and (device, engine fingerprint, program)
# of every program that has run eagerly on it: a warm build of one of
# those captures without a warm-up call
_CAPTURE_STREAMS = {}
_WARMED_PROGRAMS = set()


def _capture_stream(device):
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


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
    - `crash_safe_decode`: a decode-step exception evicts and requeues
      the offending request (replayed from its prompt and tokens)
      instead of raising.
    - `health_*`: thresholds for the HEALTHY→DEGRADED→DRAINING state
      machine driven by live page-pool occupancy; DRAINING rejects new
      admissions until pressure falls.
    - `kv_cache_dtype`: None (pools at `dtype`) or "int8", "fp8_e4m3",
      "fp8_e5m2": per-page-scaled ``(codes, scales)`` pools; activations
      and logits stay at `dtype`. An unknown name raises ValueError.
    - `guard`: the decode program also returns per-slot anomaly flags;
      a flagged request is evicted and requeued, and finishes with
      ``"anomaly"`` after `guard_requeue_limit` guard evictions.
      `guard_scale_limit` bounds quantized page scales (None: finite
      only).

    `mesh` is not ported yet and raises NotImplementedError when set.
    """

    def __init__(self, max_num_seqs=8, page_size=16, max_model_len=256,
                 num_pages=None, prefill_buckets=None,
                 growth_reserve_pages=1, eos_token_id=None,
                 dtype=torch.float32, finished_retention=1024,
                 max_queue_depth=None, crash_safe_decode=True,
                 health_degraded_at=0.85, health_drain_at=0.97,
                 health_recover_at=0.70, mesh=None, kv_cache_dtype=None,
                 guard=False, guard_scale_limit=None,
                 guard_requeue_limit=2):
        if mesh is not None:
            raise NotImplementedError(
                "EngineConfig(mesh=...) is not ported yet")
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
        self.crash_safe_decode = bool(crash_safe_decode)
        self.health_degraded_at = float(health_degraded_at)
        self.health_drain_at = float(health_drain_at)
        self.health_recover_at = float(health_recover_at)
        self.kv_cache_dtype = (None if kv_cache_dtype is None
                               else resolve_kv_cache_dtype(
                                   kv_cache_dtype).name)
        self.guard = bool(guard)
        self.guard_scale_limit = (float(guard_scale_limit)
                                  if guard_scale_limit is not None else None)
        self.guard_requeue_limit = int(guard_requeue_limit)

    @property
    def compile_bound(self):
        """Ceiling on the programs built for the engine's lifetime: one
        prefill per bucket + one decode + two sampler widths."""
        return len(self.prefill_buckets) + 3


class PagedKVContext:
    """The cache-aware attention hook handed to ``model(..., kv_ctx=)``.

    It carries the per-layer pools and a layer cursor; each attention
    layer calls :meth:`attend` exactly once per forward.

    - mode "prefill": dense causal attention over the (padded) prompt —
      the padded tail only pollutes its own discarded rows — plus a
      batched scatter of the real tokens' K/V into the pages.
    - mode "decode": one-token append + attention over the row's pages
      at its own length (ragged).

    Pool writes are in place. ``quant`` (a
    :class:`~paddle_tpu_torch.quantization.kv_cache.KVQuantSpec`, None for
    plain pools) makes each pool a ``(codes, scales)`` pair written and
    read through the quantized step functions.
    """

    def __init__(self, k_pools, v_pools, tables, lens, page_size, mode,
                 quant=None):
        self.k_pools = k_pools
        self.v_pools = v_pools
        self.tables = tables
        self.lens = lens
        self.page_size = page_size
        self.mode = mode
        self.quant = quant
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
        kp, vp = self.k_pools[li], self.v_pools[li]
        rows = (self.tables, self.lens, self.page_size)
        if self.mode == "prefill":
            out = _dense_causal_attention(qT, kT, vT)
            if self.quant is None:
                paged_prefill_append(kT, vT, kp, vp, *rows)
            else:
                quantized_prefill_append(kT, vT, kp, vp, *rows, self.quant)
        elif self.quant is None:
            out, _, _ = paged_decode_step(qT, kT, vT, kp, vp, *rows)
        else:
            out, _, _ = quantized_decode_step(qT, kT, vT, kp, vp, *rows,
                                              self.quant)
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


class _Graph:
    """One program captured as a CUDA graph over static input buffers
    (:mod:`paddle_tpu_torch.core.cuda_graph`).

    ``fn`` runs ``cuda_graph.WARMUP_CALLS`` times eagerly on ``stream``
    on copies of ``example`` (its kernels count as launched), then once
    under capture into ``pool``, and the graph is replayed once on the
    example (a graph's first replay uploads it, and should not fall on a
    request). The example's tables are zeros, so these calls write only
    the garbage page 0. The captured region ends by copying the result
    (a tensor, or a tuple of them) into output buffers allocated outside
    the pool, so no tensor of the pool outlives a replay: the engine's
    graphs share one pool and replay in any order.

    ``outputs`` (``(signature, single)`` from an AOT cache record) makes
    it a warm build: ``warmups`` eager calls (0 or 1), the output buffers
    made from the signature.
    """

    def __init__(self, fn, example, pool, stream, outputs=None, warmups=0):
        inputs = cuda_graph.StaticInputs(example, stream.device)
        if outputs is None:
            out = cuda_graph.warm_up(fn, inputs.buffers, stream)
            single = isinstance(out, torch.Tensor)
            bufs = tuple(torch.empty_like(o) for o in ((out,) if single
                                                       else out))
            del out
        else:
            sig, single = outputs
            if warmups:
                cuda_graph.warm_up(fn, inputs.buffers, stream, calls=warmups)
            bufs = tuple(torch.empty(shape, dtype=getattr(
                torch, dtype.rsplit(".", 1)[-1]), device=stream.device)
                for shape, dtype in sig)
        self.warmups = cuda_graph.WARMUP_CALLS if outputs is None else warmups
        self.single = single

        def captured(*a):
            res = fn(*a)
            for buf, o in zip(bufs, (res,) if single else res):
                buf.copy_(o)

        self.out = bufs[0] if single else bufs
        self._graph = cuda_graph.CapturedGraph(captured, inputs, pool,
                                               stream)
        self._graph.replay()

    def __call__(self, *args):
        """Copy ``args`` (CPU or CUDA tensors) into the input buffers,
        replay, and return the output buffers, which the next call
        overwrites."""
        self._graph(args)
        return self.out

    def outputs(self):
        """The output buffers as a tuple."""
        return (self.out,) if self.single else self.out

    def release(self):
        self._graph.release()


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
    ``clock`` (default the host's perf_counter) is the engine's whole
    timebase: arrival stamps, deadlines and latency histograms.
    ``metrics_name`` labels its registry instruments and names its
    metrics source (default ``serving.engine<n>``, unique in the
    process). ``program_cache`` (an :class:`~.aot_cache.AOTProgramCache`
    or a directory) keeps the records of cold builds for warm ones.

    Public surface: :meth:`add_request`, :meth:`adopt_request`,
    :meth:`release_waiting`, :meth:`export_page_state`,
    :meth:`import_page_state`, :meth:`step`, :meth:`generate`,
    :meth:`warmup`, :meth:`audit_programs`, :attr:`metrics`,
    :meth:`shutdown`.
    """

    def __init__(self, model, config=None, device=None, program_cache=None,
                 metrics_name=None, clock=None):
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
        # kv_cache_dtype narrows the pools' storage only: (codes, scales)
        # pairs with one f32 scale per (page, head)
        self._kv_quant = resolve_kv_cache_dtype(cfg.kv_cache_dtype)

        def pool():
            if self._kv_quant is None:
                return self._zeros(*pool_shape, dtype=cfg.dtype)
            return (self._zeros(*pool_shape,
                                dtype=self._kv_quant.code_dtype),
                    self._zeros(*pool_shape[:2], dtype=torch.float32))

        self._k_pools = [pool() for _ in range(self._num_layers)]
        self._v_pools = [pool() for _ in range(self._num_layers)]
        self._tables = np.zeros((B, P), np.int64)      # host-canonical
        self._lens = np.zeros((B,), np.int64)          # host-canonical
        self._alloc = PageAllocator(cfg.num_pages, B, P)
        self._slots = [None] * B                       # Request | None

        self.scheduler = Scheduler(cfg.prefill_buckets, cfg.page_size,
                                   cfg.growth_reserve_pages,
                                   max_queue_depth=cfg.max_queue_depth)
        # a monotonic default label, never id()-derived: a reused id
        # would merge this engine's instruments into a dead one's
        self._metrics_name = (metrics_name
                              or next_instance_label("serving.engine"))
        self.metrics = EngineMetrics(clock or time.perf_counter,
                                     name=self._metrics_name)
        self.metrics.compile_bound = cfg.compile_bound
        self.metrics.pages_total = cfg.num_pages - 1   # page 0 reserved
        self._programs = {}          # key -> built program (_compile)
        self._graph_pool = None      # CUDA: the graphs' shared memory pool
        if isinstance(program_cache, (str, os.PathLike)):
            program_cache = AOTProgramCache(program_cache)
        self._program_cache = program_cache
        self._program_fp = None
        if program_cache is not None:
            self._program_fp = engine_fingerprint(
                mc, cfg, dict(model.state_dict()), self.device)
        self.health = HealthMonitor(
            degraded_at=cfg.health_degraded_at,
            drain_at=cfg.health_drain_at,
            recover_at=cfg.health_recover_at,
            gauge=self.metrics.health_state)
        self._decode_fault_streak = 0
        self._requests = {}          # live (queued or running) only
        self.finished_requests = OrderedDict()
        self._next_id = 0

        # weak registration: a dropped engine (no shutdown()) stays
        # collectable and evicts its source at the next report
        mref = weakref.ref(self.metrics)
        name = self._metrics_name

        def _snapshot():
            m = mref()
            if m is None:
                # only if the source is still ours: a newer engine may
                # have registered the same name
                registry().unregister_source(name, expected=_snapshot)
                return {"error": "engine collected"}
            return m.snapshot()

        self._snapshot_fn = _snapshot
        registry().register_source(name, _snapshot)

    @property
    def program_fingerprint(self):
        """The AOT-cache fingerprint (None without a cache)."""
        return self._program_fp

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
        # the ambient TraceContext (use_context) names the request's
        # trace; without one its spans carry no trace identity
        req.trace = current_context()
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

    def adopt_request(self, prompt_token_ids, sampling_params=None,
                      generated_token_ids=(), stream=None, streamed=None,
                      arrive_t=None, arrival_index=None):
        """Router failover hook: enqueue a request that already generated
        tokens on ANOTHER engine. It enters at the queue front in the
        evicted-replay posture: ``generated_token_ids`` ride along in its
        replay tokens, the replay prefill rebuilds its KV cache, and the
        (seed, position) sampler draws its continuation.

        ``streamed`` is how many tokens the origin already delivered to
        the stream (default: all of ``generated_token_ids``), so none is
        streamed twice; ``arrive_t`` the original arrival time (this
        engine's clock), so a deadline keeps counting from the first
        arrival; ``arrival_index`` the caller's age order, so the
        fleet's oldest request does not become this engine's preferred
        preemption victim. Raises :class:`AdmissionRejected` while this
        engine drains, and ValueError when the request could never be
        served here; either way the request stays with the caller."""
        sp = self._resolve_params(sampling_params)
        prompt = [int(t) for t in prompt_token_ids]
        generated = [int(t) for t in generated_token_ids]
        self._validate_request(prompt, sp)
        if len(generated) >= sp.max_new_tokens:
            raise ValueError(
                f"request already finished ({len(generated)} of "
                f"{sp.max_new_tokens} tokens) — nothing to adopt")
        if not self.health.admitting:
            self.metrics.requests_rejected += 1
            raise AdmissionRejected(
                "draining",
                f"page-pool pressure {self.health.last_pressure:.2f}")
        rid = f"req-{self._next_id}"
        req = Request(rid, prompt, sp,
                      arrival_index=(self._next_id if arrival_index is None
                                     else int(arrival_index)),
                      stream=stream)
        req.output_token_ids = generated
        req._streamed = len(generated) if streamed is None \
            else min(int(streamed), len(generated))
        # adopted == evicted elsewhere: the admission and its TTFT were
        # the origin's events, not this engine's
        req.num_evictions = 1
        req.trace = current_context()
        req.arrive_t = (self.metrics.clock() if arrive_t is None
                        else float(arrive_t))
        req._resume_t = self.metrics.clock()
        if sp.deadline_s is not None:
            req.deadline_t = req.arrive_t + sp.deadline_s
        self.scheduler.requeue_front(req)
        self._next_id += 1
        self._requests[rid] = req
        self.metrics.requests_adopted += 1
        with span("serving.adopt", ctx=req.trace, request=rid,
                  generated=len(generated)):
            pass
        return rid

    def release_waiting(self):
        """Router drain hook: withdraw every still-queued request (fresh,
        or evicted and requeued: none holds a slot or pages) and hand
        the Request objects to the caller, which now owns them. Running
        requests finish here: their pages are here."""
        reqs = self.scheduler.drain_waiting()
        for r in reqs:
            self._requests.pop(r.request_id, None)
        if reqs:
            with span("serving.release_waiting", count=len(reqs)):
                pass
        return reqs

    # ------------------------------------- disaggregated page handoff
    def _geometry(self):
        cfg = self.config
        return {"page_size": cfg.page_size,
                "num_layers": self._num_layers,
                "num_heads": self._num_heads,
                "head_dim": self._head_dim,
                "kv_cache_dtype": cfg.kv_cache_dtype,
                "dtype": str(cfg.dtype).replace("torch.", "")}

    def _pool_parts(self, li):
        """Layer ``li``'s pool tensors by their handoff names."""
        k, v = self._k_pools[li], self._v_pools[li]
        if self._kv_quant is None:
            return {"k": k, "v": v}
        return {"k_codes": k[0], "k_scales": k[1],
                "v_codes": v[0], "v_scales": v[1]}

    def export_page_state(self, request_id, release=True):
        """Disaggregated prefill → decode: snapshot one RUNNING request's
        KV pages and scheduler state into a host dict another engine can
        :meth:`import_page_state` (the page-moving counterpart of
        token-only adoption). Per layer, the request's owned pages
        gathered from the pools into host tensors (``k`` / ``v``, or
        ``k_codes`` / ``k_scales`` / ``v_codes`` / ``v_scales`` over
        quantized pools); the prompt and generated tokens, sampling
        params, stream watermark, deadline AGE (never an absolute clock
        reading), arrival index, trace and the pool geometry. With
        ``release`` (default) the request leaves this engine: slot,
        pages and live entry."""
        req = self._requests.get(request_id)
        if req is None or req.slot is None:
            raise ValueError(
                f"request {request_id!r} is not running here: only a "
                f"RUNNING (slot-owning) request has pages to export")
        slot = req.slot
        L = int(self._lens[slot])
        pages = self._alloc.owned_pages(slot)
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        layers = [{name: t.index_select(0, idx).cpu()
                   for name, t in self._pool_parts(li).items()}
                  for li in range(self._num_layers)]
        sp = req.sampling_params
        state = {
            "prompt_token_ids": list(req.prompt_token_ids),
            "output_token_ids": list(req.output_token_ids),
            "streamed": int(req._streamed),
            "age_s": max(0.0, self.metrics.clock() - req.arrive_t),
            "arrival_index": int(req.arrival_index),
            "len": L,
            "sampling_params": {
                "max_new_tokens": sp.max_new_tokens,
                "temperature": sp.temperature,
                "top_k": sp.top_k, "top_p": sp.top_p, "seed": sp.seed,
                "eos_token_id": sp.eos_token_id,
                "deadline_s": sp.deadline_s,
            },
            "geometry": self._geometry(),
            "layers": layers,
        }
        if req.trace is not None:
            # the decode engine's spans join the request's trace
            state["trace"] = req.trace.to_dict()
        with span("serving.page_export", ctx=req.trace,
                  request=request_id, pages=len(pages), tokens=L,
                  release=bool(release)):
            if release:
                req.transition(RequestState.EVICTED)
                self._release_slot(req)
                self._requests.pop(request_id, None)
        return state

    def import_page_state(self, state, stream=None):
        """Decode side of the handoff: rebuild the exported request here.
        Fresh pages are allocated and the shipped blocks written IN
        PLACE into the pool tensors the captured decode graph reads
        (``index_copy_``), the row's table and length into the host
        arrays each replay copies in; no program is built, so
        ``serving_compile_total`` and the recompile log do not move.
        The request enters at DECODE and the (seed, position) sampler
        continues where the exporter stopped. Returns the new request
        id. Raises ValueError on a geometry mismatch or a cache length
        other than ``len(prompt) + len(generated) - 1``, and
        :class:`AdmissionRejected` when no slot or pages are free or
        this engine drains (the caller keeps ``state`` and can retry)."""
        geo = state["geometry"]
        for k, want in self._geometry().items():
            if geo.get(k) != want:
                raise ValueError(
                    f"page-state geometry mismatch on {k!r}: exporter "
                    f"{geo.get(k)!r} vs importer {want!r}")
        sp = SamplingParams(**state["sampling_params"])
        prompt = [int(t) for t in state["prompt_token_ids"]]
        generated = [int(t) for t in state["output_token_ids"]]
        self._validate_request(prompt, sp)
        L = int(state["len"])
        if L != len(prompt) + len(generated) - 1:
            raise ValueError(
                f"page-state cache length {L} does not match "
                f"prompt+generated-1 = {len(prompt) + len(generated) - 1}"
                f" (the newest token's KV is written by the NEXT decode "
                f"step)")
        if not self.health.admitting:
            self.metrics.requests_rejected += 1
            raise AdmissionRejected(
                "draining",
                f"engine {self._metrics_name} page-pool pressure "
                f"{self.health.last_pressure:.2f}")
        names = list(self._pool_parts(0))
        n_pages = len(state["layers"][0][names[0]])
        try:
            slot = self._slots.index(None)
        except ValueError:
            self.metrics.requests_rejected += 1
            raise AdmissionRejected(
                "no_slot", f"engine {self._metrics_name} has no free "
                f"decode slot for an imported request") from None
        if not self._alloc.can_allocate(slot, n_pages):
            self.metrics.requests_rejected += 1
            raise AdmissionRejected(
                "no_pages", f"engine {self._metrics_name} cannot allocate "
                f"{n_pages} pages for an imported request")
        rid = f"req-{self._next_id}"
        req = Request(rid, prompt, sp,
                      arrival_index=int(state.get("arrival_index",
                                                  self._next_id)),
                      stream=stream)
        req.output_token_ids = generated
        req._streamed = min(int(state.get("streamed", len(generated))),
                            len(generated))
        req.num_evictions = 1     # admission and TTFT were the exporter's
        req.trace = (TraceContext.from_dict(state.get("trace"))
                     or current_context())
        req.arrive_t = self.metrics.clock() - float(state.get("age_s", 0.0))
        req._resume_t = self.metrics.clock()
        if sp.deadline_s is not None:
            req.deadline_t = req.arrive_t + sp.deadline_s
        self._next_id += 1
        self._slots[slot] = req
        req.slot = slot
        pages = [page for _pos, page in self._alloc.allocate(slot, n_pages)]
        self._tables[slot, :len(pages)] = pages
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for li in range(self._num_layers):
            blk = state["layers"][li]
            for name, pool in self._pool_parts(li).items():
                src = torch.as_tensor(blk[name])
                pool.index_copy_(0, idx, src.to(device=self.device,
                                                 dtype=pool.dtype))
        self._lens[slot] = L
        req.transition(RequestState.PREFILL)
        req.transition(RequestState.DECODE)
        self._requests[rid] = req
        self.metrics.requests_adopted += 1
        with span("serving.page_import", ctx=req.trace, request=rid,
                  pages=n_pages, tokens=L):
            pass
        return rid

    def has_unfinished(self):
        return (self.scheduler.has_waiting()
                or any(r is not None for r in self._slots))

    # live admission telemetry: the signals the scrape gauges export,
    # read at the source so a router balancing a burst of admissions
    # between steps sees each one land
    @property
    def queue_depth(self):
        return self.scheduler.queue_depth

    @property
    def num_running(self):
        return sum(1 for r in self._slots if r is not None)

    @property
    def page_occupancy(self):
        total = self.config.num_pages - 1      # page 0 reserved
        if not total:
            return 0.0
        return (total - self._alloc.num_free_pages) / total

    def step(self):
        """One engine iteration: admit + prefill new requests at the
        step boundary, then one continuous-batched decode step.  Returns
        ``[(request_id, token_id, finished), ...]`` for tokens produced
        this step; a preemption surfaces as ``(request_id, None, False)``."""
        events = []
        self._expire_deadlines(events)
        with span("serving.admit"):
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

    def warmup(self):
        """Build every program this engine can run (each prefill bucket,
        the decode step, both sampler widths), so that serving builds
        none. Returns ``{"programs", "compiled", "cache_loads",
        "boot_ms"}``. Idempotent."""
        t0 = time.perf_counter()
        for b in self.config.prefill_buckets:
            self._get_prefill(b)
        self._get_decode()
        self._get_sampler(1)
        self._get_sampler(self.config.max_num_seqs)
        return {
            "programs": len(self._programs),
            "compiled": self.metrics.compile_count,
            "cache_loads": self.metrics.aot_cache_loads,
            "boot_ms": (time.perf_counter() - t0) * 1e3,
        }

    @property
    def kv_pool_bytes(self):
        """Bytes of every layer's K and V pools, quantized pools' scales
        included."""
        def nbytes(pool):
            parts = pool if isinstance(pool, tuple) else (pool,)
            return sum(t.numel() * t.element_size() for t in parts)
        return sum(nbytes(p) for p in self._k_pools + self._v_pools)

    @property
    def kv_bytes_per_token(self):
        """Pool bytes per token of KV capacity across all layers (page 0's
        bytes and capacity cancel)."""
        return self.kv_pool_bytes / (self.config.num_pages
                                     * self.config.page_size)

    def shutdown(self):
        """Unregister the metrics source, release this engine's claim on
        its registry instruments, and release the KV pools and the
        programs (each CUDA graph gives its memory back); the engine
        serves nothing after this."""
        registry().unregister_source(self._metrics_name,
                                     expected=self._snapshot_fn)
        self.metrics.release()
        for prog in self._programs.values():
            if isinstance(prog, _Graph):
                prog.release()
        self._programs.clear()
        self._graph_pool = None
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
            with span("serving.deadline", request=req.request_id,
                      state=req.state.value,
                      overrun_s=round(now - req.deadline_t, 4)):
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
        with span("serving.prefill", ctx=req.trace,
                  request=req.request_id, bucket=bucket, tokens=L):
            self._prefill_inner(req, events, cfg, t0, tokens, L, bucket)

    def _prefill_inner(self, req, events, cfg, t0, tokens, L, bucket):
        slot = self._slots.index(None)
        self._slots[slot] = req
        req.slot = slot

        need = self._alloc.pages_needed(L, cfg.page_size)
        for pos, page in self._alloc.allocate(slot, need):
            self._tables[slot, pos] = page

        ids = np.zeros((1, bucket), np.int64)
        ids[0, :L] = tokens
        pos_ids = np.arange(bucket, dtype=np.int64)[None, :]
        last_logits = self._get_prefill(bucket)(*_tensors(
            self._tables[slot:slot + 1], ids, pos_ids, np.array([L])))
        self._lens[slot] = L

        tok = self._sample(last_logits, [req], width=1)[0]
        now = self.metrics.clock()
        self.metrics.prefill_steps += 1
        self.metrics.prefill_step_s.observe(now - t0)
        self.metrics.prompt_tokens += L
        if req.num_evictions == 0:
            self.metrics.requests_admitted += 1
            self.metrics.ttft.observe(now - req.arrive_t)
            # stage decomposition: for a fresh request TTFT is exactly
            # queue-wait (arrival -> prefill start) + prefill
            self.metrics.ttft_queue.observe(max(0.0, t0 - req.arrive_t))
            self.metrics.ttft_prefill.observe(max(0.0, now - t0))
        req.append_token(tok, now=now)
        self._observe_resume(req, now)
        self.metrics.generated_tokens += 1
        self._post_token(req, events, now)
        if not req.is_finished:
            req.transition(RequestState.DECODE)

    # -------------------------------------------------------- decode
    def _decode_step(self, events):
        with span("serving.decode"):
            self._decode_step_inner(events)

    def _decode_step_inner(self, events):
        cfg = self.config
        t0 = self.metrics.clock()
        # fault site: injected pool exhaustion drives one preemption
        # round through the real victim selection
        spec = _fire("serving.pool", step=self.metrics.decode_steps)
        if spec is not None and spec.kind == "pool_exhaust":
            for _ in range(int(spec.payload.get("victims", 1))):
                victim = self.scheduler.select_victim(
                    [r for r in self._slots if r is not None])
                if victim is None:
                    break
                self._evict(victim, events)
                note_recovery("serving.pool", "pool_exhaust",
                              victim=victim.request_id)
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

        fn = self._get_decode()
        args = _tensors(self._tables, self._lens, tokens)
        if cfg.guard:
            args += _tensors(self._poison_vector(live))
        try:
            # fault site: an `exception` here is a crashed decode step
            # (payload `request_id` names the offender)
            _fire("serving.decode", step=self.metrics.decode_steps)
            out = fn(*args)
        except Exception as e:
            if not cfg.crash_safe_decode:
                raise
            self._recover_decode_fault(e, events)
            return
        logits, flags = out if cfg.guard else (out, None)
        self._decode_fault_streak = 0
        # flagged rows are sampled too and their tokens dropped: sampling
        # is per row, so the others' tokens are those the reference draws
        # with the flagged rows cleared first, and the flags' read comes
        # after the tokens', which waited for the device already
        toks = self._sample(logits, list(self._slots),
                            width=cfg.max_num_seqs)
        if flags is not None:
            live = self._quarantine_flagged(live, flags.cpu().numpy(),
                                            events)
        for s, r in live:
            self._lens[s] += 1
        now = self.metrics.clock()
        self.metrics.decode_steps += 1
        self.metrics.decode_step_s.observe(now - t0)
        for s, r in live:
            if r.last_token_t is not None:
                self.metrics.inter_token.observe(now - r.last_token_t)
            r.append_token(toks[s], now=now)
            self._observe_resume(r, now)
            self.metrics.generated_tokens += 1
            self._post_token(r, events, now)

    def _poison_vector(self, live):
        """The guarded decode's ``[B, 1]`` poison operand: zeros, unless a
        ``serving.logits`` fault poisons its victim's row (``nan_grad``
        NaN, ``bitflip`` +inf), so detection runs through the real
        program and injection never changes it."""
        poison = np.zeros((self.config.max_num_seqs, 1), np.float32)
        spec = _fire("serving.logits", step=self.metrics.decode_steps)
        if spec is not None and spec.kind in ("bitflip", "nan_grad") \
                and live:
            rid = spec.payload.get("request_id")
            if rid is not None:
                # a targeted fault whose target is gone is spent
                victim = next((r for _s, r in live
                               if r.request_id == rid), None)
            else:
                victim = max((r for _s, r in live),
                             key=lambda r: r.arrival_index)
            if victim is not None:
                poison[victim.slot, 0] = (np.nan if spec.kind == "nan_grad"
                                          else np.inf)
        return poison

    def _quarantine_flagged(self, live, flags, events):
        """Guard verdicts (``flags`` ``[B, 2]`` on the host) -> evictions:
        a flagged live request is evicted and requeued (its replay
        prefill rebuilds its pages), unless it was guard-evicted
        ``guard_requeue_limit`` times already: then it finishes with
        ``"anomaly"``. Returns the surviving live rows."""
        flagged = [(s, r) for s, r in live if flags[s].any()]
        if not flagged:
            return live
        now = self.metrics.clock()
        for s, r in flagged:
            kind = "nan_logits" if flags[s, 0] else "scale_overflow"
            note_anomaly(kind, "serving.decode",
                         step=self.metrics.decode_steps,
                         request=r.request_id)
            r.num_guard_evictions += 1
            self.metrics.guard_anomalies += 1
            with span("serving.guard", request=r.request_id, kind=kind,
                      evictions=r.num_guard_evictions):
                if r.num_guard_evictions > self.config.guard_requeue_limit:
                    self._finish(r, "anomaly", now)
                    r.deliver(finished=True)
                    events.append((r.request_id, None, True))
                else:
                    self._evict(r, events)
            note_recovery("serving.decode", kind, request=r.request_id)
        return [(s, r) for s, r in live if self._slots[s] is r]

    def _recover_decode_fault(self, exc, events):
        """Crash-safe decode: the failed step left nothing to undo (it
        fired before the replay; pages grown for it are kept), so the
        offending request (the exception's ``request_id``, else the
        latest-arrived live one) is evicted and requeued, and serving goes
        on. More consecutive faults than slots re-raise: the fault is not
        the request's."""
        live = [r for r in self._slots if r is not None]
        self._decode_fault_streak += 1
        if not live or self._decode_fault_streak > self.config.max_num_seqs:
            raise exc
        rid = getattr(exc, "request_id", None)
        offender = next((r for r in live if r.request_id == rid), None)
        if offender is None:
            offender = max(live, key=lambda r: r.arrival_index)
        with span("serving.decode_fault", request=offender.request_id,
                  exc=type(exc).__name__, streak=self._decode_fault_streak):
            self._evict(offender, events)
        self.metrics.decode_fault_recoveries += 1
        note_recovery("serving.decode", "exception",
                      request=offender.request_id, exc=type(exc).__name__)

    # ------------------------------------------------------ sampling
    def _sample(self, logits, reqs, width):
        """reqs: per-row Request or None (padding rows).  Position is
        the ABSOLUTE index of the token being sampled = the row's cache
        length AFTER its input token was appended = `total_len`."""
        seeds = np.zeros((width,), np.int64)
        pos = np.zeros((width,), np.int64)
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
        out = self._get_sampler(width)(logits, *_tensors(
            seeds, pos, temps, top_ks, top_ps))
        return out.tolist()         # the step's one host read

    # ------------------------------------------------- finish / evict
    def _observe_resume(self, req, now):
        """The first token after an adoption on THIS engine closes the
        ttft_decode stage (the resume latency of migrated work)."""
        if req._resume_t is not None:
            self.metrics.ttft_decode.observe(max(0.0, now - req._resume_t))
            req._resume_t = None

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
        if req.trace is not None:
            # the trace's terminal marker (fleettrace timelines key on
            # it), recorded only for traced requests
            with span("serving.finish", ctx=req.trace,
                      request=req.request_id, reason=reason,
                      tokens=len(req.output_token_ids)):
                pass
        self._requests.pop(req.request_id, None)
        self.finished_requests[req.request_id] = req
        while len(self.finished_requests) > self.config.finished_retention:
            self.finished_requests.popitem(last=False)

    def _evict(self, req, events):
        """Deterministic preemption: free everything, requeue at the
        queue front; the replay prefill later reconstructs the cache
        from prompt + generated tokens."""
        with span("serving.preempt", request=req.request_id,
                  generated=len(req.output_token_ids)):
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
        m.sync_gauges()    # queue-depth / page-occupancy scrape gauges

    # ------------------------------------------------------ programs
    def _forward(self, ids, pos_ids, ctx):
        with torch.no_grad():
            return self._model(ids, position_ids=pos_ids, kv_ctx=ctx)

    def _zeros(self, *shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _prefill_program(self, bucket, pools=None):
        """(fn, example inputs) of the prefill program at ``bucket``:
        ``fn(row_table [1, P], ids [1, bucket], pos_ids [1, bucket],
        length [1])`` -> the last real token's logits ``[1, V]`` f32; the
        prompt's K/V go into ``pools`` (``(k_pools, v_pools)``, default
        the engine's) in place."""
        cfg = self.config
        k_pools, v_pools = pools or (self._k_pools, self._v_pools)

        def prefill(row_table, ids, pos_ids, length):
            ctx = PagedKVContext(k_pools, v_pools, row_table, length,
                                 cfg.page_size, "prefill",
                                 quant=self._kv_quant)
            logits = self._forward(ids, pos_ids, ctx)       # [1, bucket, V]
            last = (length - 1)[:, None, None].expand(-1, 1,
                                                      logits.shape[-1])
            return logits.gather(1, last)[:, 0].float()

        return prefill, (self._zeros(1, cfg.max_pages_per_seq),
                         self._zeros(1, bucket), self._zeros(1, bucket),
                         torch.ones(1, dtype=torch.int64,
                                    device=self.device))

    def _guard_flags(self, logits, k_pools, v_pools, tables, lens):
        """Per-slot anomaly flags ``[B, 2]`` f32: column 0 a non-finite
        value in the row's logits, column 1 (quantized pools) a
        non-finite page scale, or one above ``guard_scale_limit``, on a
        page the row uses, in any layer."""
        cfg = self.config
        bad_logits = (~torch.isfinite(logits)).any(dim=-1)          # [B]
        bad_scale = torch.zeros_like(bad_logits)
        if self._kv_quant is not None:
            P = tables.shape[1]
            used = (torch.arange(P, device=tables.device) * cfg.page_size
                    )[None, :] < (lens + 1)[:, None]                 # [B, P]
            limit = cfg.guard_scale_limit
            for kq, vq in zip(k_pools, v_pools):
                for _codes, scales in (kq, vq):
                    sc = scales[tables]                             # [B,P,h]
                    bad = ~torch.isfinite(sc)
                    if limit is not None:
                        bad = bad | (sc > limit)
                    bad_scale = bad_scale | (bad & used[:, :, None]).any(
                        dim=2).any(dim=1)
        return torch.stack([bad_logits, bad_scale], dim=-1).float()

    def _decode_program(self, pools=None):
        """(fn, example inputs) of the decode program: ``fn(tables [B, P],
        lens [B], tokens [B, 1])`` -> logits ``[B, V]`` f32; each row's
        token goes into ``pools`` (``(k_pools, v_pools)``, default the
        engine's) in place at its length, which is also its position.
        With ``guard`` it takes a ``[B, 1]`` f32 poison added to the
        logits (zeros but under a ``serving.logits`` fault) and returns
        ``(logits, flags [B, 2])``: still one program."""
        cfg = self.config
        k_pools, v_pools = pools or (self._k_pools, self._v_pools)

        def decode(tables, lens, tokens, *poison):
            ctx = PagedKVContext(k_pools, v_pools, tables, lens,
                                 cfg.page_size, "decode",
                                 quant=self._kv_quant)
            logits = self._forward(tokens, lens[:, None], ctx)[:, 0].float()
            if not cfg.guard:
                return logits
            logits = logits + poison[0]
            return logits, self._guard_flags(logits, k_pools, v_pools,
                                             tables.long(), lens.long())

        B = cfg.max_num_seqs
        example = (self._zeros(B, cfg.max_pages_per_seq), self._zeros(B),
                   self._zeros(B, 1))
        if cfg.guard:
            example += (self._zeros(B, 1, dtype=torch.float32),)
        return decode, example

    def _sampler_program(self, width):
        """(fn, example inputs) of the sampler at ``width``: ``fn(logits
        [width, V] f32, seeds, positions, temperatures, top_ks, top_ps)``
        -> token ids ``[width]`` int32."""
        V = int(self._model.config.vocab_size)
        return sample_tokens, (
            self._zeros(width, V, dtype=torch.float32), self._zeros(width),
            self._zeros(width), self._zeros(width, dtype=torch.float32),
            self._zeros(width, dtype=torch.int32),
            torch.ones(width, dtype=torch.float32, device=self.device))

    def audit_programs(self):
        """{name: (fn, example inputs)} of every program the engine builds
        (``prefill_<bucket>``, ``decode``, ``sample_1``,
        ``sample_<max_num_seqs>``), from the same builders, over copies
        of the pools: calling one writes none of the engine's state."""
        def copy(pool):
            return tuple(t.clone() for t in pool) \
                if isinstance(pool, tuple) else pool.clone()
        pools = ([copy(p) for p in self._k_pools],
                 [copy(p) for p in self._v_pools])
        progs = {}
        for b in self.config.prefill_buckets:
            progs[f"prefill_{b}"] = self._prefill_program(b, pools)
        progs["decode"] = self._decode_program(pools)
        for width in (1, self.config.max_num_seqs):
            progs[f"sample_{width}"] = self._sampler_program(width)
        return progs

    def _get_prefill(self, bucket):
        key = ("prefill", bucket)
        if key in self._programs:
            return self._programs[key]
        return self._compile(key, *self._prefill_program(bucket))

    def _get_decode(self):
        key = ("decode",)
        if key in self._programs:
            return self._programs[key]
        return self._compile(key, *self._decode_program())

    def _get_sampler(self, width):
        key = ("sample", width)
        if key in self._programs:
            return self._programs[key]
        return self._compile(key, *self._sampler_program(width))

    def _compile(self, key, fn, example):
        """Build, count and keep one program: every program the engine
        runs passes through here, so ``metrics.compile_count`` (cold
        builds) and ``metrics.aot_cache_loads`` (warm ones) are exact.
        On CUDA the program is ``fn`` captured as a :class:`_Graph` (a
        failed capture raises); on the CPU it is ``fn`` itself. A cold
        build is a ``serving-aot`` event of the recompile log, recorded
        before ``note_compile`` can raise past the bound, so an
        over-bound build is the log's last event; that program is then
        released, not kept. With a program cache a record of this
        program is tried first (:meth:`_load`), and a cold build stores
        one."""
        prog_name = "/".join(str(p) for p in key)
        cache = self._program_cache
        if cache is not None:
            record = cache.load(self._program_fp, prog_name)
            if record is not None:
                prog = self._load(key, prog_name, fn, example, record)
                if prog is not None:
                    return prog
        t0 = time.perf_counter()
        with span("serving.compile", program=str(key)):
            if self.device.type == "cuda":
                fn = _Graph(fn, example, self._pool(),
                            _capture_stream(self.device))
                _WARMED_PROGRAMS.add((self.device, self._program_fp,
                                      prog_name))
        note_aot_compile(
            prog_name,
            compile_ms=round((time.perf_counter() - t0) * 1e3, 3),
            cache_size=len(self._programs) + 1,
            bound=self.config.compile_bound, engine=self._metrics_name)
        try:
            self.metrics.note_compile()
        except RuntimeError:
            if isinstance(fn, _Graph):
                fn.release()
            raise
        self._programs[key] = fn
        if cache is not None:
            self._store(prog_name, fn, example)
        return fn

    def _pool(self):
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _store(self, prog_name, prog, example):
        """Record what the cold build of ``prog_name`` learned: its
        signatures and its output on the zero example (the graph's boot
        replay on CUDA; one call on copies of the example on the CPU)."""
        if isinstance(prog, _Graph):
            outs, single = prog.outputs(), prog.single
        else:
            out = prog(*[a.clone() for a in example])
            single = isinstance(out, torch.Tensor)
            outs = (out,) if single else tuple(out)
        self._program_cache.store(self._program_fp, prog_name, {
            "program": prog_name, "inputs": signature(example),
            "outputs": signature(outs), "single": single,
            "digest": output_digest(outs)})

    def _load(self, key, prog_name, fn, example, record):
        """A warm build from ``record``, or None when the record does not
        fit (the entry is dropped and the caller builds cold): on the CPU
        the function itself once its input signature matches; on CUDA a
        :class:`_Graph` whose boot replay reproduces the recorded digest,
        captured after one warm-up call when the program has not run
        eagerly in this process yet, else after none."""
        cache = self._program_cache
        if record.get("inputs") != signature(example):
            cache.drop(self._program_fp, prog_name, why="signature")
            return None
        t0 = time.perf_counter()
        with span("serving.aot_load", program=str(key),
                  fingerprint=self._program_fp) as sp:
            if self.device.type == "cuda":
                warmed = (self.device, self._program_fp, prog_name)
                prog = _Graph(fn, example, self._pool(),
                              _capture_stream(self.device),
                              outputs=(record["outputs"], record["single"]),
                              warmups=0 if warmed in _WARMED_PROGRAMS else 1)
                _WARMED_PROGRAMS.add(warmed)
                if output_digest(prog.outputs()) != record["digest"]:
                    prog.release()
                    cache.drop(self._program_fp, prog_name, why="digest")
                    sp.attrs["result"] = "digest mismatch"
                    return None
            else:
                prog = fn
            sp.attrs["load_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        self.metrics.note_aot_load()
        self._programs[key] = prog
        return prog


def _tensors(*arrays):
    """Host arrays as CPU tensors (no copy), a program's inputs."""
    return [torch.from_numpy(a) for a in arrays]
