#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases, exit 0 only if all pass
    python3 chip_smoke.py --profile    # also profile a few decode steps

Phases, in order (any failure raises and exits non-zero):

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for matmuls and convolutions;
2. build: compile the port's CUDA kernels from ``paddle_tpu_torch/ops/
   cuda/csrc`` with nvcc for sm_90a;
3. kernels: the LayerNorm forwards against their plain PyTorch versions
   at the main path's shapes (hidden 2048; rows 8, 16, 512, 1000, 4096
   and the ragged 1001, 4097; f32, bf16 and the mixes bf16 x + f32 r,
   bf16 x + f32 weights, bf16 x + f32 r and weights (the O1 post-LN
   join); hidden 512 at 4096 rows too; ``act="gelu"`` too for
   ln_res_fwd), the same
   bits from a second run and from a launch of the first rows alone;
   the dtypes the train path hands them (one forward of GPT-1.3B cut to
   a layer, watched); then their times (CUDA events) at rows 8, 16, 512,
   1000 and 4096 in bf16, and in the train path's mix at 4096, beside
   the bound, the plain version's time, the library call's and the
   launch floor (an empty kernel's time);
4. serving: GPT-1.3B (``gpt3_1p3b(fused_ln=True)``, random bf16 weights
   from a seeded generator) serves 8 requests through ``LLMEngine``,
   whose ``warmup()`` first captures every program as a CUDA graph
   (``compile_bound`` = 10: seven prefill buckets, the decode step, two
   sampler widths) and which then serves only by replaying them,
   capturing nothing more; every request finishes with 64 tokens, the
   logits of every prefill and decode call are finite, the kernels'
   launch counts (counted once a replay) match the forward passes
   exactly, and serving the same requests one at a time on a fresh
   engine gives the same tokens; the decode graph's logits equal one
   uncaptured call of the same program function on copies of the same
   pools, tables, lengths and tokens (``check_close``); then one run
   with every request sampled (temperature 0.8, top_k 50, top_p 0.9:
   threefry noise drawn on the card), whose first request alone draws
   the same tokens;
5. train kernels: the flash attention kernels (forward, dq, dk/dv) at the
   training path's shape (``[4, 1024, 16, 128]``, causal, q/k/v strided
   views of a fused projection) plus a ragged non-causal one, causal
   ones with sq != sk both ways, a length of 1000 and a single (b, h),
   and the LayerNorm backward kernel (rows 4096, 8 and 4097 at hidden
   2048, 4096 rows at hidden 512, 1024 and 4096; plain and residual, ``act``
   None and gelu), f32 and bf16, each against its plain version; then
   the autograd Functions (kernel path) against autograd through the
   plain versions, and each kernel's time beside its bound, its plain
   version's and the library call's (for the flash backward pair, SDPA's
   backward alone; for the forward also without the causal mask);
6. fused AdamW kernels: the update and the guard's sums of squares at
   the training path's weight shapes (and an odd-row single block, and
   ``cols % 8 != 0``), f32 and bf16 moments, decay on and off, guard off
   and on with one NaN planted in one row block under guard, each
   against its plain version bit for bit (that block's p, m and v
   bit-identical to the inputs); then their times beside their bounds,
   the plain version's and ``torch._fused_adamw_``'s;
7. training: GPT-1.3B (``gpt3_1p3b(fused_ln=True)``, dropout 0, f32
   master weights from a seeded generator) takes 10 steps of
   ``to_static(amp_policy="bf16")`` + ``AdamW(fused=False)`` on one
   seeded batch of 4 x 1024 tokens; every loss is finite, the last is
   below the first by more than ``LOSS_DROP``, every parameter ends
   with a finite gradient, and each step launches each kernel exactly as
   often as the model has call sites. Every train phase below runs the
   step as ``to_static`` captures it, one CUDA graph (``_compiled`` at
   1), its first call's ``WARMUP_CALLS`` eager warm-ups counted with the
   launches; here the same 10 steps of a copy through
   ``dygraph_function`` (eagerly) first, and the captured run equals it
   bit for bit (losses and final weights); the first call's time and
   peak memory apart from the steady ones; then one replayed step under
   ``torch.profiler`` says where a step's time goes;
8. guarded training: the same model, weights and batch through the
   reference's optimized, guarded step (``to_static(amp_policy="bf16",
   guard=True)``, ``AdamW(fused=True, guard=True)``) watched by a
   ``TrainingSentinel``: 10 clean steps (every action OK, 3091 guarded
   regions, losses within ``TRAJECTORY_TOL`` of phase 7's), then a
   ``nan_grad`` fault in the word embedding's gradient (that step through
   ``dygraph_function``, under the fault plan: the step is
   classified ``nan_grad`` with one bad region, that 128-row block keeps
   its p, m and v, the rest moves, the embedding's beta powers hold),
   and one more captured step; launch counts exact; its breakdown and
   profile;
9. fused, unguarded: ``AdamW(fused=True)`` at depth 2 against
   ``AdamW(fused=False)``, 3 steps; then the lr as device state: a
   depth-2 guarded, fused step under ``LinearWarmup`` stepped between 6
   captured calls equals 6 eager steps bit for bit, and so does the
   same step given its batches on the CPU (placed on the card by the
   state it changes, captured, its batches staged into device buffers);
   the fault hooks' counts over a first call, two more, a new shape,
   ``set_lr`` and a call (2, 2, 2, 3, 3, the reference's); a captured ``Linear(6, 3)`` step against its
   eager twin: without a clear ``.grad`` accumulates over 3 calls, with
   ``zero_grad()`` or ``zero_grad(set_to_none=False)`` weights and
   ``.grad`` follow eager steps, returned losses survive later calls;
   a step drawing from its own generator fails its capture and dropout
   on the default one draws fresh masks each replay;
10. rollback: at depth 2, a fault-free run and a run with ``nan_grad`` on
   steps 7 and 8 (checkpoint at 4, ``skip_limit`` 2): detected at step
   7, 2 skips, 1 rollback, and the resumed run's (eager) losses and
   weights equal the fault-free (captured) run's bit for bit; the step-4
   checkpoint restored into the captured run replays as one eager step
   from it, bit for bit;
11. (run after phase 6) RMSNorm and block-sparse attention kernels:
   ``rms_fwd`` at rows 8, 1000, 8192 by hidden 2048, 4096, 8192, f32 and
   bf16 x with an f32, a bf16 or no weight, within one bf16 ulp (f32
   1e-5); ``bsa_fwd`` (o and lse) at the path's shape, a long-context
   shape, BigBird-base's head, a ragged f32 shape, a non-causal mask
   with an empty q-row (o = 0, finite lse), a ragged bf16 shape at
   blocks of 128 and a window at block_q 256 / block_k 64, per element
   as the flash checks, each launched twice for the same bits; then
   their times beside bound, plain version and library (``bsa_fwd`` at
   the path's, the long-context and BigBird-base's shapes);
12. sparse block: a pre-norm long-context attention block written from
   the port's public layers (``nn.RMSNorm(2048)``, ``nn.Linear(2048,
   6144)``, ``F.sparse_attention`` over a CSR of a global+window
   pattern, ``nn.Linear(2048, 2048)``, the residual) takes 5 steps of
   ``to_static(amp_policy="bf16")`` + ``AdamW(1e-3, fused=True)`` on 2 x
   4096 tokens: losses finite and falling, every gradient finite, the
   pattern analysed once and memoised after (the capture finds it in
   the memo), launches exact per step; a step taking the CSR as an
   argument fails its capture;
13. (run after phase 11) shapes no kernel takes: ``gpt3_tiny`` (head_dim
   16) trains 3 f32 steps (dropout 0, ``to_static``, ``AdamW(fused=
   False)``) on the card and on the CPU from the same weights and batch,
   losses within 1e-4 relative, every attention call routed to the
   composition (``flash_attention.ROUTED``) and the LayerNorms on their
   kernels; ``nn.LayerNorm(5120)`` forward and backward on the card
   (routed, no launch) against the CPU, f32 and bf16 rows;
14. the sampler: 64 rows of seeded f32 logits at vocab 50304, the
   threefry uniforms on the card equal the CPU's bit for bit, the Gumbel
   noise within 2 ulp of each log, the tokens sampled at temperature
   0.8, top_k 50, top_p 0.9 identical;
15. (run after phase 11) the keep-mask kernel (dropout's
   ``bernoulli(split(key)[1], 0.9)``) against its plain version (the
   torch threefry) at the dropout drive's shapes (``[4, 16, 1024,
   1024]`` bf16, ``[4, 1024, 2048]`` bf16 and f32), a ragged bool, an
   f16 and a split alone: mask, subkey and advanced key bit for bit;
   its time beside its bound (integer operations) and the plain
   version's;
16. (run after phase 9) GPT-1.3B at its own defaults, dropout 0.1 and
   attention dropout 0.1, with ``AdamW(1e-4, weight_decay=0.01,
   grad_clip=ClipGradByGlobalNorm(1.0), fused=True)`` and a
   ``GPTPretrainingCriterion`` masking each row's last 128 tokens: 10
   steps eagerly through ``dygraph_function``, then captured by
   ``to_static(amp_policy="bf16")`` from the same seed: losses, the key
   after every step and the final weights bit-identical, the key
   advancing every step, two steps' masks different, 1 + 3 x 24 mask
   launches a forward and no flash launch; one replay profiled; then the
   same step under ``remat=True`` (losses within 1e-6, the keys equal),
   ``remat="bf16"`` (within 0.05), at dropout 0, and under
   ``remat=True`` at dropout 0 (flash on the path, its forward launched
   again in the backward), each with its step time, first-call peak and
   steady memory;
17. at depth 2 of the same widths, f32: the untied head's
   ``loss_with_fused_head`` (chunks of 1024 tokens) against logits +
   ``cross_entropy`` from the same weights (loss within 1e-5 relative,
   every gradient within 1e-4 of its tensor's largest magnitude), with
   both peaks; one eager ``GradScaler`` step against an unscaled one;
18. (run after phase 4) quantized, guarded serving: the same model and
   requests with ``EngineConfig(kv_cache_dtype="int8", guard=True)``:
   10 graphs at ``warmup()`` and none after, 64 tokens a request, finite
   logits, the LayerNorm launches of every forward, no anomaly,
   continuous == sequential, the decode graph's logits and flags
   bit-identical to the uncaptured program's on copies of the
   ``(codes, scales)`` pools, the pools at half phase 4's bytes plus
   their scales; a ``serving.logits`` NaN at decode step 2 and a
   ``serving.decode`` exception at step 4 each evict the latest request
   once (1 anomaly, 1 recovery), every other request's tokens and the
   victim's before its eviction equal the clean run's, and a second run
   of each plan gives the same tokens (the replay re-quantizes the
   victim's pages at once, the reference's documented tolerance);
   ``guard_scale_limit=1e-6`` finishes every request as "anomaly";
   ``fp8_e4m3`` pools serve 64 tokens a request, continuous ==
   sequential; printed, not gated: the greedy requests' agreement with
   phase 4's tokens, and int8's tokens/s, decode step, TTFT and peak
   beside bf16's (``--profile``: a profiled decode step of each);
19. at depth 2 (f32 masters, ``to_static(amp_policy="bf16")``, 4 x 1024
   tokens a step): SGD, Momentum (Nesterov), LarsMomentum, RMSProp
   (centered), Adagrad, Adadelta, Adamax, Lamb, 3 steps each, and
   ``GradientMergeOptimizer(AdamW(fused=True), k_steps=2)``, 4 steps,
   moving the weights at steps 2 and 4 only: each captured run equal to
   its ``dygraph_function`` twin bit for bit (losses and weights),
   launches exact; then ``SGD(guard=True)`` with a planted ``nan_grad``
   keeps exactly that parameter;
20. observability and resilience: GPT-1.3B serves phase 4's 8 requests
   on an engine named ``smoke`` inside a telemetry spool: ``warmup()``
   is exactly 10 ``serving-aot`` events of the recompile log and
   ``serving_compile_total{engine="smoke"}`` 10; after a warm-up run
   of it, eight runs in turns (``OBS_PLAN``) with spans on (under a
   ``TraceContext``) and the spool armed, spans on alone, and spans
   off: one ``serving.prefill`` span a prefill, one
   ``serving.decode`` a decode step, one ``serving.finish`` a request,
   the same tokens in every run, the LayerNorm launches of every
   forward; a scrape of ``serve_prometheus`` on 127.0.0.1 returns the
   engine's series; the spool merges into a Chrome trace with the spans
   and a request's timeline; each run's tokens/s and mean decode step,
   and an empty span's host µs, are printed beside the card. Then at
   depth 2 (``to_static(amp_policy="bf16", guard=True)``,
   ``AdamW(fused=True, guard=True)``): the recompile log's causes of a
   first call, a halved
   sequence and a new registry version; six captured steps, and the
   same six with a ``preempt`` fault at the third ``optimizer.step``
   under a ``PreemptionHandler``: it drains a checkpoint of step 3 and
   a fresh model and optimizer resumed from it take steps 4-6 captured
   (the fresh optimizer drops the saved moments, as the reference's
   does), bit for bit as an eager twin resumed the same way, the
   parameters' ``tree_digest`` equal before the save and after the load; and ``localize_poison`` over a
   ``BatchLineage`` (a checkpoint at step 2, a ``nan_grad`` planted at
   step 5 of 8) names step 5;
21. router and traffic: GPT-1.3B behind a ``Router`` of 2 replicas
   sharing the model, over an ``AOTProgramCache`` in a temporary
   directory: replica 0 boots cold (10 builds), replica 1 and the two
   respawns warm (10 cache loads each, their graphs' boot replays equal
   to the cold build's recorded digest); phase 4's 8 requests served
   with replica 0 drained before its first step (its 4 queued requests
   migrate before a token) and again under a ``serving.decode`` crash
   planted at the site's 7th firing, replica 0's 4th decode step (its 4
   running requests adopt onto replica 1 with 4 tokens each): 64 tokens a request, every
   request not migrated after a token equal to phase 4's, the migrated
   ones printed where they part from it, the LayerNorm launches those
   of every engine's forwards and boot replays; one engine booted cold
   in a fresh process and one from the cache in another (no cold build,
   10 loads after one warm-up call each), both serving phase 4's
   tokens; a seeded Poisson trace
   through 2 replicas on a ``VirtualClock`` twice (identical reports and
   registry snapshots) and an on/off burst that the ``SLOAutoscaler``
   answers by unparking a replica, booted warm; the roofline profiler:
   ``profile_engine`` over the ten programs, the depth-2 guarded step
   (>= 90 % of bytes and flops attributed, its state unchanged), each
   kernel launched at the kernel table's shapes under the walk with its
   booked bound equal to the table's, the decode program and the step
   reconciled with the spans of their own replays, and prefill_1024's
   five costliest layers
   (and each kind of layer) predicted beside their kernel time in a
   ``torch.profiler`` run grouped by the scopes' ``record_function``
   paths; then ``drift_probe``: where a replayed request first drifts
   from its decoded self, op by op at layer 0, and the logits where
   their tokens part;
22. the multi-process serving fleet: in this process, two engines of
   GPT-1.3B hand phase 4's 8 requests over after their first tokens
   (``export_page_state`` → ``wire.pack_state`` → a TCPStore on
   127.0.0.1 → ``import_page_state``), over bf16 pools (phase 4's
   tokens exactly) and over int8 pools (one int8 engine's tokens
   exactly), no program built after the warm-ups, the decode graph
   bit-identical to its uncaptured program over the imported pages, the
   LayerNorm launches of every forward; then ``FLEET_NODES`` fresh
   processes through ``python -m paddle_tpu_torch.distributed.launch``
   run ``paddle_tpu_torch/serving/fleet/worker.py``: rank 0 (the
   store's host) serves the monolithic run into a shared AOT cache and
   fronts ranks 1-3 with the stock router, rank 4 a spare; 9 requests
   (64-900 token prompts, 64 new, odd ones sampled) with ``rank_kill``
   on rank 2 and ``wedge`` (a real SIGSTOP) on rank 3 mid-decode, then
   3 prompts (128, 384, 900 tokens) disaggregated between two live
   replicas; every request finishes, its stream is its tokens once, the
   unmigrated ones and the disaggregated run equal the monolithic run,
   a migrated one equals it up to its migration (where it parts is
   printed), both faults draw DEAD verdicts, the respawn boots warm on
   rank 4 (0 builds, 10 loads), every live replica built at most 10
   programs and launched the LayerNorms of every forward, the spools
   merge onto rank 0's clock and the post-mortems name the dead ranks'
   requests; the verdict latencies, respawn and boot ms, the handoff's
   bytes and ms by part, tokens/s, peaks and the wall seconds are
   printed;
23. mixture of experts: ``gpt3_1p3b(fused_ln=True, moe_num_experts=8,
   moe_top_k=2, moe_every=2, moe_gate="gshard")`` (GShard's top 2 of 8
   experts in every other block, capacity (2.0, 2.0), 4.13 B params)
   serves phase 4's 8 requests at 24 layers in bf16 as CUDA graphs: 10
   programs, 64 tokens a request, finite logits, the LayerNorm launches
   of every forward (25 / 24), the decode graph's logits and pools
   bit-identical to its uncaptured program; continuous against
   sequential is printed, not gated (a prefill routes its padded bucket
   and a decode all 8 rows, so capacity and drops depend on the batch);
   tokens/s, decode step, TTFT and peaks printed. Then at 12 layers
   (2.12 B f32 params) it trains on 4 x 1024 tokens at dropout 0 under
   ``to_static(amp_policy="bf16")`` with loss = criterion + 0.01 x
   ``moe_aux_loss()``, with ``AdamW(fused=True, guard=True)`` and with
   ``AdamW(fused=False)``: an eager twin through ``dygraph_function``
   and the captured run from one seed equal bit for bit (losses, aux
   losses, weights; GShard's random routing drawn from the key), losses
   falling, aux losses finite and positive, launches exact (one
   keep-mask launch a MoE block: the routing's draw); step ms, tokens/s,
   the first call's peak, a profiled replay and an eager step's kernel
   time split into the experts, the dispatch and combine, and the rest;
24. eager collectives: 3 processes through the launcher run
   ``tests/_torch_fleet_worker.py`` with their tensors on the card, one
   AVG ``all_reduce`` of [loss, grad] a step through the fleet's store,
   a quorum checkpoint after step 5, ``rank_kill`` on rank 2 at step 8:
   both survivors name it in their ``CollectiveTimeout``, reconfigure to
   2 and reload the checkpoint resharded; then 2 fresh processes run the
   fault-free baseline from the same checkpoint, and the resumed losses
   equal it exactly; an all_reduce's ms, the DEAD verdict's latency
   against ``dead_after_s`` and ``reconfigure``'s seconds printed;
25. flash at head_dim 64: the three flash kernels' head_dim-64
   instances against their plain versions, f32 and bf16, at BERT's
   ``[16, 512, 12, 64]``, ViT-B/16's ragged ``[128, 197, 12, 64]``, a
   causal ``[4, 1024, 16, 64]``, Transformer-base's ``[16, 256, 8, 64]``,
   sq != sk both ways (200 / 328, causal and not) and one query row
   against 256 and 255 keys (the decode; against 1 key forward only);
   then their bf16 times at BERT's, ViT's and Transformer-base's shapes
   beside bound, plain version and SDPA;
26. encoders: ERNIE-3.0-base and BERT-base (dropout 0) through the
   reference's MLM step (``bench.py:_bench_ernie`` / ``_bench_bert``:
   ``to_static``, ``auto_cast(level="O1", dtype="bfloat16")``,
   ``AdamW(1e-4)``, ``cross_entropy`` over the vocabulary) on 16 x 512
   tokens (ERNIE with task ids 0): 4 steps of an eager twin, then 4
   captured, equal bit for bit (losses and every state tensor), losses
   finite and falling, ``ln_fwd`` and ``ln_bwd`` 26 and each flash kernel
   12 launches a step, nothing routed; step ms, tokens/s, the first
   call's ms and peaks;
27. vision: ResNet-50 NHWC (``bench.py:_resnet_variant``:
   ``Momentum(0.1, momentum=0.9)``, O1) on 256 images of 224^2, cuDNN
   deterministic, the captured run equal to the eager twin in its
   weights and all 106 BatchNorm statistics, no port kernel launched;
   ViT-B/16 (``tools/profile_vit.py``: ``AdamW(1e-4)``, O1) on 128
   images, ``ln_fwd`` / ``ln_bwd`` 25 and flash 12 each a step at 197
   tokens; images/s, the first call's ms and peaks;
28. transformer: Transformer-base (Vaswani et al. 2017, Table 3, "base":
   ``nn.Transformer`` at 512 / 8 heads / 6 + 6 layers / FFN 2048, one
   [37000, 512] embedding shared by source and target and tied to the
   output, scaled by sqrt(512), plus the sinusoid table) trained on 16 x
   256 source and target tokens with ``cross_entropy(label_smoothing=
   0.1)`` and ``Adam(NoamDecay(512, 4000), 0.9, 0.98, 1e-9)`` under
   ``to_static`` and ``auto_cast(level="O1", dtype="bfloat16")``, encoder
   and decoder of ``fused_ln=True`` layers at dropout 0: 4 eager + 4
   captured steps equal bit for bit (losses, weights, Adam moments, lr,
   key), losses finite and falling, a step's launches ``ln_res_fwd`` 30,
   ``ln_bwd`` 30, each flash kernel 12, nothing routed; step ms,
   tokens/s, the first call and the peaks, a replay by kernel;
29. transformer_defaults: ``nn.Transformer()`` at its own defaults
   (dropout 0.1, ``fused_ln`` off) through the same step: ``ln_fwd`` 30,
   ``ln_bwd`` 30, ``keep_mask`` 62 a step, no flash; captured = eager;
30. transformer_decode: phase 28's model in eval, f32: 32 greedy tokens
   for 16 sources of 256 through ``TransformerDecoder.gen_cache``
   (``Cache`` + ``StaticCache``, flash at one query row against 1-32
   and 256 keys) equal to 32 tokens from re-running the decoder on the
   prefix under the causal mask, logits within 1e-4 of their largest
   magnitude; launches exact; ms a token each way;
31. lstm: the PTB "large" LSTM (Zaremba et al. 2014, §4: vocab 10,000,
   ``nn.LSTM(1500, 1500, num_layers=2, dropout=0.65)``, dropout 0.65 on
   the embedding and the output) on 20 x 35 tokens, ``SGD(1.0)`` with
   ``ClipGradByGlobalNorm(10)``, f32, under ``to_static``: 4 eager + 4
   captured steps equal bit for bit, ``keep_mask`` 3 a step and no other
   port kernel (the time loop is torch's GEMMs and elementwise
   kernels); step ms and tokens/s.

The phases print their seconds as they end.

Each main path (serving, the training runs) runs with every launch count
and every count of calls routed to a composition by shape set to 0 just
before it and read just after; a GPT-1.3B or sparse block path that
routed any call fails. The last line is ``{"ok": true, "device":
{...}}``; the line before it holds the kernels' numbers as JSON. Each
kernel's ``bound_ms`` is ``ops/cuda/cost.py``'s, the formula the
roofline profiler books its launches with.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import random
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HIDDEN = 2048
ROWS = (8, 16, 512, 1000, 4096)      # decode, prefill-sized, the train step
LN_CHECK_ROWS = ROWS + (1001, 4097)  # and ragged counts past the split's edges
TRAIN_LN_ROWS = 4096                 # B * S: the train step's LayerNorm rows
EPS = 1e-5
TIMED_ROWS = 8                       # the decode shape: most launches
NORM_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/norm.cu"
FLASH_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu"
OPTIM_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/optim.cu"
BSA_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/block_sparse_attention.cu"
RANDOM_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/random.cu"
REPLACES = {"ln_fwd": "paddle_tpu/ops/pallas/norm.py:55",
            "ln_res_fwd": "paddle_tpu/ops/pallas/norm.py:190",
            "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:94",
            "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:144",
            "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:181",
            "ln_bwd": "paddle_tpu/ops/pallas/norm.py:225",
            "ln_bwd_res": "paddle_tpu/ops/pallas/norm.py:233",
            "adam_update": "paddle_tpu/ops/pallas/optim.py:61",
            "adam_update_guard": "paddle_tpu/ops/pallas/optim.py:61",
            "adam_guard_sumsq": "paddle_tpu/ops/pallas/optim.py:61",
            "rms_fwd": "paddle_tpu/ops/pallas/norm.py:66",
            "bsa_fwd": "paddle_tpu/ops/pallas/block_sparse_attention.py:86",
            # no pallas_call: the XLA fusion of jax.random.bernoulli that
            # the reference's attention dropout compiles to
            "keep_mask": "paddle_tpu/nn/functional/transformer.py:39"}
SOURCES = {name: FLASH_SOURCE if name.startswith("flash") else
           OPTIM_SOURCE if name.startswith("adam") else
           BSA_SOURCE if name.startswith("bsa") else
           RANDOM_SOURCE if name == "keep_mask" else NORM_SOURCE
           for name in REPLACES}
# the training path: batch, sequence, heads, head_dim (GPT-1.3B)
B, S, H, D = 4, 1024, 16, 128
TRAIN_STEPS = 10
LOSS_DROP = 0.1                      # last loss <= first - LOSS_DROP
# the fused AdamW: GPT-1.3B's rank-2 weights by shape and count (word
# and position embeddings, then qkv, out, fc1, fc2 of each layer)
ADAM_PATH_SHAPES = {(50304, 2048): 1, (2048, 2048): 25, (2048, 6144): 24,
                    (2048, 8192): 24, (8192, 2048): 24}
# and two layouts the path does not have: an odd-row single block, and
# cols % 8 != 0 over several blocks
ADAM_CHECK_SHAPES = tuple(ADAM_PATH_SHAPES) + ((1003, 520), (4096, 1001))
ADAM_LR, ADAM_T, ADAM_WD = 1e-4, 3, 0.01      # AdamW(1e-4) at its 3rd step
GUARD_REGIONS = 3091                 # 2,897 row blocks + 194 rank-1 params
TRAJECTORY_TOL = 0.05                # guarded vs unfused losses, per step
CHAOS_CKPT, CHAOS_FAULT, CHAOS_TOTAL, CHAOS_SKIPS = 4, 7, 10, 2
RMS_EPS = 1e-6
RMS_ROWS = (8, 1000, 8192)           # decode, prefill-sized, the path's
RMS_HIDDEN = (2048, 4096, 8192)      # GPT-1.3B's, and LLaMA's widths
# the sparse block path: batch, sequence, mask block, steps (hidden 2048,
# 16 heads of 128: GPT-1.3B's widths)
SB_B, SB_S, SB_BLOCK, SB_STEPS = 2, 4096, 64, 5
LR_STEPS = 6                         # captured steps under LinearWarmup
TINY_STEPS = 3                       # gpt3_tiny on the card against the CPU
TINY_REL = 1e-4                      # their f32 losses, relative
LN_WIDE = 5120                       # past MAX_HIDDEN: the LN composition
SAMPLER_ROWS = 64                    # rows of logits for the sampler check
LN_FWD_KERNEL = "ln_fwd_kernel"       # both LayerNorm forwards, by name
DROPOUT = 0.1                        # GPTConfig's own dropout defaults
SEED = 2024                          # the global key of the dropout drives
MASK_TAIL = 128                      # loss_mask drops each row's last tokens
REMAT_TOL = {True: 1e-6, "bf16": 0.05}   # remat losses against plain
HEAD_CHUNK = 1024                    # loss_with_fused_head's chunk


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bf16_ulp(t):
    """One bf16 ulp at each element's magnitude."""
    mag = t.abs().float().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


SHARES = {}     # (check group, dtype) -> largest error as a share of its limit


def _held(name, got, err, tol):
    """Raise unless every element of ``err`` is within ``tol`` and ``got``
    is finite; else note the largest share of the limit under the
    name's first word (the check group) and last word (the dtype), and
    return the max abs error."""
    bad = int((err > tol).sum())
    share = (err / tol.clamp(min=torch.finfo(torch.float32).tiny)).max()
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements beyond tolerance, "
                             f"max abs err {err.max().item()}, largest "
                             f"share of the limit {share.item()}")
    words = name.split()
    key = (words[0], words[-1])
    SHARES[key] = max(SHARES.get(key, 0.0), share.item())
    return err.max().item()


def shares(*groups):
    """{group: {dtype: largest error as a share of its limit}}."""
    return {g: {dt: round(x, 6) for (g2, dt), x in sorted(SHARES.items())
                if g2 == g} for g in groups}


def check_close(name, got, want):
    """f32: atol = rtol = 1e-5. bf16: one bf16 ulp of the larger
    magnitude, plus 1e-5 for the f32 sums' other order near zero."""
    narrow = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if narrow:
        tol = bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-5
    else:
        tol = 1e-5 + 1e-5 * want.abs()
    return _held(name, got, err, tol)


def check_sum(name, got, want, rel=None):
    """For outputs of long sums (f32 attention over 1024 keys, gradients
    summed over 4096 rows), whose terms add in another order: f32 within 1e-5 of the tensor's largest
    magnitude plus 1e-5 of the element's; bf16 within 2^-7 of the
    tensor's largest magnitude (two bf16 ulps there); ``rel``, where
    given, within that share of the largest magnitude whatever the type.
    Returns the max abs error."""
    narrow = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = want.abs().max()
    if rel is not None:
        tol = rel * top
    else:
        tol = 2.0 ** -7 * top if narrow else 1e-5 * top + 1e-5 * want.abs()
    return _held(name, got, err, tol)


def check_terms(name, got, want, terms):
    """For attention outputs, each element a sum over the other sequence
    of products one factor of which (p, or ds) both sides round to bf16,
    at other points (p against a running maximum in the kernel, the
    row's maximum in the plain version): f32 as :func:`check_sum`; bf16
    within one bf16 ulp of the element (the output's own rounding may
    land on either side), plus 2^-8 of ``terms``, the element's sum of
    the products' magnitudes (two roundings of one factor differ by at
    most 2^-8 of it), plus 1e-5 of the tensor's largest magnitude (the
    other sum order)."""
    if got.dtype != torch.bfloat16:
        return check_sum(name, got, want)
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = bf16_ulp(torch.maximum(got.abs(), want.abs())) \
        + 2.0 ** -8 * terms + 1e-5 * want.abs().max()
    return _held(name, got, err, tol)


def device_ms(fn, inputs, reps=50, per_rep=20):
    """Median over `reps` of the mean device time of `per_rep` launches,
    by CUDA events. A sleep kernel ahead of each batch lets the host
    queue the whole batch first, so the events time the device, not the
    host's launch rate; `inputs` cycles through copies larger than L2."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = []
    for i in range(reps + 3):
        torch.cuda._sleep(20_000_000)
        start.record()
        for j in range(per_rep):
            fn(*inputs[(i * per_rep + j) % len(inputs)])
        end.record()
        end.synchronize()
        if i >= 3:                         # warm-up batches
            samples.append(start.elapsed_time(end) / per_rep)
    return statistics.median(samples)


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card_line()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build():
    from paddle_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.load_library()
    path = Path(build.last_build["path"])
    regs = [int(line.split("Used ")[1].split()[0])
            for line in build.last_build["ptxas"].splitlines()
            if "Used " in line and " registers" in line]
    spills = [line for line in build.last_build["ptxas"].splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.last_build['seconds']:.1f} s); {len(regs)} kernel "
          f"instances, registers {min(regs, default=0)}..{max(regs, default=0)}"
          f", spilling: {len(spills)}")
    if spills:
        raise AssertionError("kernels spill registers:\n" + "\n".join(spills))
    check_loads_first(path)


def check_loads_first(lib_path):
    """In the compiled code of every LayerNorm forward instance, every
    global load (LDG) sits ahead of the first shuffle (SHFL), the first
    reduction: x, w and b (and r) load together, and the next row's x (and
    r) before this row's statistics. ``cuobjdump -sass`` from the
    toolkit that built the library."""
    from paddle_tpu_torch.ops.cuda import build
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    late, ahead = {}, []
    for section in sass.split("Function : ")[1:]:
        name, body = section.split("\n", 1)
        if LN_FWD_KERNEL not in name:
            continue
        lines = body.splitlines()
        first = next(i for i, line in enumerate(lines) if "SHFL" in line)
        ahead.append(sum("LDG" in line for line in lines[:first]))
        after = sum("LDG" in line for line in lines[first:])
        if after:
            late[name.strip()] = after
    print(f"[build] LayerNorm forwards: {len(ahead)} instances, "
          f"{min(ahead, default=0)}..{max(ahead, default=0)} global loads "
          f"ahead of the first shuffle, {sum(late.values())} after it")
    if not ahead or late:
        raise AssertionError(f"loads after the first reduction: {late}")


def _inputs(rows, dtype, gen, copies=1, hidden=HIDDEN, r_dtype=None,
            w_dtype=None):
    """``copies`` sets of (x, r, w, b); r and the weights in ``dtype``
    unless ``r_dtype`` / ``w_dtype`` say otherwise."""
    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dt)
    wd = w_dtype or dtype
    w = (1.0 + 0.1 * torch.randn(hidden, device="cuda", generator=gen)).to(wd)
    b = (0.1 * torch.randn(hidden, device="cuda", generator=gen)).to(wd)
    return [(rnd(rows, hidden), rnd(rows, hidden, dt=r_dtype or dtype), w, b)
            for _ in range(copies)]


def _dt(dtype):
    return str(dtype).split(".")[1]


def train_ln_mix():
    """The dtypes (x, weight; x, residual, weight) the train path hands
    the LayerNorm forwards: one forward of GPT-1.3B cut to one layer under
    ``to_static(amp_policy="bf16")``, with f32 masters, its launchers
    watched."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import norm
    _cfg, model = _gpt(num_layers=1)
    seen = {}
    saved = {n: getattr(norm, n) for n in ("_ln_fwd_launch",
                                           "_ln_res_fwd_launch")}

    def watch(name):
        def launch_(*args):
            seen.setdefault(name, set()).add(tuple(
                _dt(a.dtype) for a in args[:3 if name == "ln_res_fwd" else 2]))
            return saved[f"_{name}_launch"](*args)
        return launch_

    try:
        for name in ("ln_fwd", "ln_res_fwd"):
            setattr(norm, f"_{name}_launch", watch(name))
        ids = torch.zeros((1, 16), dtype=torch.long, device="cuda")
        with torch.no_grad():
            pt.jit.to_static(amp_policy="bf16")(model)(ids)
        torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(norm, n, fn)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mix = {name: sorted(s) for name, s in seen.items()}
    print(f"[kernels] the train path hands the LayerNorm forwards (x, "
          f"weight) / (x, residual, weight): {mix}")
    if len(mix.get("ln_fwd", ())) != 1 or len(mix.get("ln_res_fwd", ())) != 1:
        raise AssertionError(f"expected one dtype mix a kernel: {mix}")
    (x_dt, w_dt), = mix["ln_fwd"]
    (rx_dt, r_dt, rw_dt), = mix["ln_res_fwd"]
    if (x_dt, w_dt) != (rx_dt, rw_dt):
        raise AssertionError(f"the two kernels see other mixes: {mix}")
    return getattr(torch, x_dt), getattr(torch, r_dt), getattr(torch, w_dt)


def check_ln_forwards(norm, gen):
    """Both forwards against their plain versions at every checked row
    count, uniform and mixed dtypes, act None and gelu; then the same
    bits from a second run and from a launch of the first rows alone.
    Returns the max abs errors."""
    f32, bf16 = torch.float32, torch.bfloat16
    max_err = {"ln_fwd": 0.0, "ln_res_fwd": 0.0}
    # (x, residual, weights): uniform, then the mixes the kernels take
    # (bf16, f32, f32): the O1 post-LN join of nn.Transformer, checked
    # also at its hidden 512 and 4,096 rows
    mixes = ((f32, f32, f32), (bf16, bf16, bf16), (bf16, bf16, f32),
             (bf16, f32, bf16), (f32, bf16, f32), (bf16, f32, f32))
    shapes = [(rows, HIDDEN) for rows in LN_CHECK_ROWS] \
        + [(TRAIN_LN_ROWS, 512)]
    for xd, rd, wd in mixes:
        for rows, hidden in shapes:
            (x, r, w, b), = _inputs(rows, xd, gen, hidden=hidden,
                                    r_dtype=rd, w_dtype=wd)
            tag = f"rows={rows} hidden={hidden} w={_dt(wd)} r={_dt(rd)} " \
                  f"{_dt(xd)}"
            got = norm.ln_fwd(x, w, b, EPS)
            torch.cuda.synchronize()
            max_err["ln_fwd"] = max(max_err["ln_fwd"], check_close(
                f"ln_fwd {tag}", got, norm._ln_fwd_ref(x, w, b, EPS)))
            for act in (None, "gelu"):
                h, y = norm.ln_res_fwd(x, r, w, b, EPS, act)
                torch.cuda.synchronize()
                h_ref, y_ref = norm._ln_res_fwd_ref(x, r, w, b, EPS, act)
                out = _dt(h_ref.dtype)
                max_err["ln_res_fwd"] = max(
                    max_err["ln_res_fwd"],
                    check_close(f"ln_res_fwd h act={act} {tag} out {out}",
                                h, h_ref),
                    check_close(f"ln_res_fwd y act={act} {tag} out {out}",
                                y, y_ref))
    print(f"[kernels] agree with their plain versions on "
          f"{len(mixes) * len(shapes)} shapes and dtype mixes; "
          f"max abs err {max_err}")
    for xd in (f32, bf16):
        (x, r, w, b), = _inputs(TRAIN_LN_ROWS, xd, gen)
        y = norm.ln_fwd(x, w, b, EPS)
        h, yr = norm.ln_res_fwd(x, r, w, b, EPS, "gelu")
        for rows in (TIMED_ROWS, 1000):
            y_few = norm.ln_fwd(x[:rows], w, b, EPS)
            h_few, yr_few = norm.ln_res_fwd(x[:rows], r[:rows], w, b, EPS,
                                            "gelu")
            same = torch.equal(y_few, y[:rows]) and torch.equal(
                h_few, h[:rows]) and torch.equal(yr_few, yr[:rows])
            if not same:
                raise AssertionError(f"{_dt(xd)}: the first {rows} rows of a "
                                     f"{TRAIN_LN_ROWS}-row launch differ from "
                                     f"a launch of them alone")
        again = norm.ln_fwd(x, w, b, EPS)
        h2, yr2 = norm.ln_res_fwd(x, r, w, b, EPS, "gelu")
        if not (torch.equal(again, y) and torch.equal(h2, h)
                and torch.equal(yr2, yr)):
            raise AssertionError(f"{_dt(xd)}: a second run gave other bits")
    print(f"[kernels] the same bits from a second run and from launches of "
          f"the first {TIMED_ROWS} and 1000 rows alone (f32, bf16)")
    return max_err


def phase_kernels():
    from paddle_tpu_torch.ops.cuda import cost, norm
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = check_ln_forwards(norm, gen)
    print(f"[kernels] largest error as a share of its limit: "
          f"{shares('ln_fwd', 'ln_res_fwd')}")
    mix = train_ln_mix()

    floor = device_ms(torch.cuda._sleep, [(0,)])
    print(f"[kernels] launch floor (an empty kernel, torch.cuda._sleep(0)):"
          f" {floor:.5f} ms")
    timings = {}
    bf16 = torch.bfloat16
    cases = [(rows, (bf16, bf16, bf16)) for rows in ROWS] \
        + [(TRAIN_LN_ROWS, mix)]
    for rows, (xd, rd, wd) in cases:
        e = xd.itemsize
        copies = max(1, min(64, math.ceil(150e6 / (4 * rows * HIDDEN * e))))
        sets = _inputs(rows, xd, gen, copies, r_dtype=rd, w_dtype=wd)
        ln_args = [(x, w, b, EPS) for x, _r, w, b in sets]
        res_args = [(x, r, w, b, EPS) for x, r, w, b in sets]
        lib_args, lib_note = [(x, (HIDDEN,), w, b, EPS)
                              for x, _r, w, b in sets], ""
        try:
            torch.nn.functional.layer_norm(*lib_args[0])
        except RuntimeError:
            lib_args = [(x, (HIDDEN,), w.to(xd), b.to(xd), EPS)
                        for x, _r, w, b in sets]
            lib_note = f" (F.layer_norm refuses the mix: weights cast to " \
                f"{_dt(xd)})"
        key = "" if (xd, rd, wd) == (bf16,) * 3 else " mix"
        for name, fn, ref, args, costs, lib in (
                ("ln_fwd", norm.ln_fwd, norm._ln_fwd_ref, ln_args,
                 cost.ln_fwd(*ln_args[0]), torch.nn.functional.layer_norm),
                ("ln_res_fwd", norm.ln_res_fwd, norm._ln_res_fwd_ref,
                 res_args, cost.ln_res_fwd(*res_args[0], None), None)):
            bound, by = _bound(costs)
            t = {
                "ms": device_ms(fn, args),
                "plain_ms": device_ms(ref, args),
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": device_ms(lib, lib_args) if lib else None,
                "launch_floor_ms": floor,
            }
            timings[(name, rows) if not key else (name, rows, "mix")] = t
            lib_txt = (f"{t['library_ms']:.5f}" if t["library_ms"]
                       is not None else "null")
            dts = f"x {_dt(xd)}, weights {_dt(wd)}" + (
                f", r {_dt(rd)}" if name == "ln_res_fwd" else "")
            print(f"[kernels] {name} rows={rows} hidden={HIDDEN} {dts}: "
                  f"kernel_ms {t['ms']:.5f} bound_ms {t['bound_ms']:.5f} "
                  f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.0f} % "
                  f"of it) plain_ms {t['plain_ms']:.5f} library_ms {lib_txt}"
                  f"{lib_note if lib else ''}; launch floor {floor:.5f}")
    return max_err, timings


def _prompts(seed, vocab, n=8):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 901, n)
    return [rng.integers(1, vocab, int(L)).tolist() for L in lens]


def _launch_counts():
    from paddle_tpu_torch.ops.cuda import (block_sparse_attention,
                                           flash_attention, norm, optim,
                                           random)
    return (norm.LAUNCHES, flash_attention.LAUNCHES, optim.LAUNCHES,
            block_sparse_attention.LAUNCHES, random.LAUNCHES)


def _routed_counts():
    from paddle_tpu_torch.ops.cuda import flash_attention, norm
    return flash_attention.ROUTED, norm.ROUTED


def reset_launches():
    """Every launch count, and every count of calls routed to a
    composition by shape, to 0."""
    for counts in _launch_counts() + _routed_counts():
        for k in counts:
            counts[k] = 0


def read_routed():
    return {k: v for counts in _routed_counts() for k, v in counts.items()}


def read_launches(path):
    """The launch counts since :func:`reset_launches`. Prints the routed
    counts of ``path`` and raises if any call was routed to a
    composition: every shape of the GPT-1.3B and sparse block paths is
    one the kernels take."""
    routed = read_routed()
    print(f"[routed] {path}: {routed}")
    if any(routed.values()):
        raise AssertionError(f"{path}: calls routed to a composition by "
                             f"shape: {routed}")
    return _launches()


def _launches():
    return {k: v for counts in _launch_counts() for k, v in counts.items()}


def _watch_finite(eng, finite):
    """Wrap the engine's prefill and decode programs so that each call
    notes whether its logits are all finite, read at once (the next call
    overwrites a graph's output). Returns the programs it wrapped."""
    originals = {k: p for k, p in eng._programs.items()
                 if k[0] in ("prefill", "decode")}

    def watched(prog):
        def call(*args):
            out = prog(*args)
            logits = out[0] if isinstance(out, tuple) else out
            finite.append(torch.isfinite(logits).all())
            return out
        return call

    eng._programs.update({k: watched(p) for k, p in originals.items()})
    # the check's own kernels load at their first call: not in the timing
    torch.isfinite(torch.zeros(1, 8, device="cuda")).all()
    return originals


def _pool_bits(pools):
    """Every tensor of a list of pools (plain, or ``(codes, scales)``
    pairs), one-byte codes as uint8 (``torch.equal`` takes no fp8)."""
    flat = [t for p in pools for t in (p if isinstance(p, tuple) else (p,))]
    return [t.view(torch.uint8) if t.element_size() == 1 else t
            for t in flat]


def _clone_pool(p):
    return tuple(t.clone() for t in p) if isinstance(p, tuple) else p.clone()


def check_decode_graph(eng, prompts, sps, exact=False):
    """One decode step at full width: the decode graph's outputs (logits;
    and the guard's flags) against one uncaptured call of the same
    ``_decode_program()`` function on copies of the same pools (plain or
    ``(codes, scales)``), tables, lengths and tokens (and a zero poison).
    Returns the max abs error."""
    for p, sp in zip(prompts, sps):
        eng.add_request(p, sp)
    eng.step()                         # admits and prefills all 8
    eng.step()
    err = decode_graph_vs_program(eng, exact)
    eng.shutdown()
    return err


def decode_graph_vs_program(eng, exact=False):
    """The next decode step of ``eng``'s running requests through its
    decode graph against one uncaptured call of ``_decode_program()`` on
    copies of the pools: the pools after bit-identical (and the guard's
    outputs too, or with ``exact`` the logits), the logits within
    ``check_close``'s bf16 limit. The step's pages are allocated as
    ``_decode_step`` would, so serving on after it replays the same step
    (the same KV rewritten). Returns the max abs error."""
    # the next step's inputs, as LLMEngine._decode_step makes them
    page = eng.config.page_size
    tokens = np.zeros((eng.config.max_num_seqs, 1), np.int64)
    for slot, req in enumerate(eng._slots):
        if req is None:
            continue
        need = eng._alloc.pages_needed(int(eng._lens[slot]) + 1, page)
        for pos, pg in eng._alloc.allocate(slot, need):
            eng._tables[slot, pos] = pg
        tokens[slot, 0] = req.output_token_ids[-1]
    args = [torch.from_numpy(a) for a in (eng._tables, eng._lens, tokens)]
    if eng.config.guard:
        args.append(torch.zeros(eng.config.max_num_seqs, 1))
    copies = ([_clone_pool(p) for p in eng._k_pools],
              [_clone_pool(p) for p in eng._v_pools])
    out = eng._get_decode()(*args)
    replayed = [o.clone() for o in (out if isinstance(out, tuple)
                                    else (out,))]
    fn, _ = eng._decode_program(pools=copies)
    eager = fn(*(a.cuda() for a in args))
    eager = eager if isinstance(eager, tuple) else (eager,)
    torch.cuda.synchronize()
    # bf16 products upcast: compared at bf16, check_close's bf16 limit
    tag = "serving decode graph logits bf16" + (
        f", {eng.config.kv_cache_dtype} pools" if eng.config.kv_cache_dtype
        else "")
    err = check_close(tag, replayed[0].bfloat16(), eager[0].bfloat16())
    same = all(torch.equal(a, b) for a, b in zip(replayed, eager))
    pools_same = all(torch.equal(a, b) for a, b in zip(
        _pool_bits(eng._k_pools + eng._v_pools),
        _pool_bits(copies[0] + copies[1])))
    print(f"[serving] decode graph vs the uncaptured decode program at "
          f"lens {eng._lens.tolist()}: max abs err {err}, outputs "
          f"({len(replayed)}) bit-identical {same}, pools after "
          f"bit-identical {pools_same}")
    if not pools_same:
        raise AssertionError("decode graph: the pools differ from the "
                             "uncaptured program's")
    if (eng.config.guard or exact) and not same:
        raise AssertionError("decode graph: logits (or the guard's flags) "
                             "differ from the uncaptured program's")
    return err


def _serving_model(tag):
    """GPT-1.3B (``fused_ln=True``) in bf16 from seed 0, the serving
    phases' model."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    cfg = gpt3_1p3b(fused_ln=True)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] gpt3_1p3b(fused_ln=True): {n_params / 1e9:.3f} B "
          f"params in bf16, built in {time.perf_counter() - t0:.1f} s")
    return cfg, model


def _serving_engine(model, metrics_name=None, **options):
    """The serving phases' engine: 8 slots, pages of 16, 1024 tokens,
    bf16, with ``options`` of ``EngineConfig``."""
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine
    return LLMEngine(model, EngineConfig(
        max_num_seqs=8, page_size=16, max_model_len=1024,
        dtype=torch.bfloat16, **options), metrics_name=metrics_name)


def _serving_requests(vocab):
    """8 prompts of 64-900 tokens and their sampling: even requests
    greedy, odd ones sampled; 64 new tokens each."""
    from paddle_tpu_torch.serving import SamplingParams
    prompts = _prompts(0, vocab)
    sps = [SamplingParams(max_new_tokens=64,
                          temperature=0.0 if i % 2 == 0 else 0.8,
                          top_k=0 if i % 2 == 0 else 50, seed=100 + i)
           for i in range(len(prompts))]
    return prompts, sps


def phase_serving(profile):
    from paddle_tpu_torch.serving import SamplingParams
    cfg, model = _serving_model("serving")

    def engine():
        return _serving_engine(model)

    prompts, sps = _serving_requests(cfg.vocab_size)

    eng = engine()
    bound = eng.config.compile_bound
    boot = eng.warmup()
    print(f"[serving] warmup: {boot['programs']} programs captured as CUDA "
          f"graphs in {boot['boot_ms']:.1f} ms (compile bound {bound})")
    if not boot["programs"] == boot["compiled"] == bound == 10:
        raise AssertionError(f"warmup built {boot}, bound {bound}")
    finite = []
    originals = _watch_finite(eng, finite)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = eng.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("serving")
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    pool_bytes = (eng.kv_pool_bytes, eng.kv_bytes_per_token)
    m = eng.metrics
    if m.compile_count != bound:
        raise AssertionError(f"generate captured {m.compile_count - bound} "
                             f"more programs")
    forwards = m.prefill_steps + m.decode_steps
    expect = {k: 0 for k in launches}
    expect.update(ln_fwd=forwards * (cfg.num_layers + 1),
                  ln_res_fwd=forwards * cfg.num_layers)
    print(f"[serving] {len(results)} requests, prompts "
          f"{[len(p) for p in prompts]}, {m.prefill_steps} prefills + "
          f"{m.decode_steps} decode steps, all graph replays; launches "
          f"{launches}")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")
    if len(finite) != forwards or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits (or a forward not seen)")
    for r in results:
        if len(r.output_token_ids) != 64:
            raise AssertionError(f"{r.request_id}: "
                                 f"{len(r.output_token_ids)} tokens")
    eng._programs.update(originals)
    eng.shutdown()

    seq = engine()
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        (one,) = seq.generate([p], [sp])
        if one.output_token_ids != results[i].output_token_ids:
            raise AssertionError(f"request {i}: continuous serving "
                                 f"differs from sequential")
    seq.shutdown()
    print("[serving] continuous == sequential for all 8 requests")
    check_decode_graph(engine(), prompts, sps)

    # one run with every request sampled: the threefry noise of (seed,
    # position) is drawn on the card, and request 0 alone on a fresh
    # engine draws the same tokens as in the batch
    sampled = [SamplingParams(max_new_tokens=64, temperature=0.8, top_k=50,
                              top_p=0.9, seed=200 + i)
               for i in range(len(prompts))]
    eng_s = engine()
    eng_s.warmup()
    t0 = time.perf_counter()
    res_s = eng_s.generate(prompts, sampled)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    gen_s = eng_s.metrics.generated_tokens
    eng_s.shutdown()
    if any(len(r.output_token_ids) != 64 for r in res_s):
        raise AssertionError("sampled run: a request without 64 tokens")
    alone = engine()
    (one,) = alone.generate([prompts[0]], [sampled[0]])
    alone.shutdown()
    if one.output_token_ids != res_s[0].output_token_ids:
        raise AssertionError("sampled run: request 0 alone draws other "
                             "tokens than in the batch")
    print(f"[serving] sampled run (temperature 0.8, top_k 50, top_p 0.9, "
          f"all 8 requests): {gen_s / wall_s:.1f} tokens/s ({gen_s} tokens "
          f"in {wall_s:.2f} s); request 0 alone draws the same tokens")

    snap = m.snapshot()
    card = card_line()
    bf16 = {"tokens": [r.output_token_ids for r in results],
            "tokens_per_s": m.generated_tokens / wall,
            "decode_ms": snap["decode_step_ms"]["mean"],
            "ttft_p50_ms": snap["ttft_ms"]["p50"], "peak": peak,
            "kv_pool_bytes": pool_bytes[0],
            "kv_bytes_per_token": pool_bytes[1]}
    print(f"[serving] {card}: {m.generated_tokens / wall:.1f} tokens/s "
          f"({m.generated_tokens} tokens in {wall:.2f} s), mean decode "
          f"step {snap['decode_step_ms']['mean']:.2f} ms, mean prefill "
          f"{snap['prefill_step_ms']['mean']:.2f} ms, TTFT p50 "
          f"{snap['ttft_ms']['p50']:.1f} ms p99 {snap['ttft_ms']['p99']:.1f}"
          f" ms, boot {boot['boot_ms']:.1f} ms, peak memory "
          f"{peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB "
          f"reserved (the graphs' pool is reserved, not allocated)")
    if profile:
        profile_decode(engine(), prompts, sps)
    return launches, bf16


def profile_decode(eng, prompts, sps):
    """Device time by kernel over 10 decode steps at full width, all
    graph replays."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    eng.warmup()
    for p, sp in zip(prompts, sps):
        eng.add_request(p, sp)
    eng.step()                         # admits and prefills all 8
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    print(f"[serving] profiled: 10 decode steps in {wall * 1e3:.1f} ms of "
          f"host time")
    eng.shutdown()


def _serve(model, prompts, sps, plan=None, **options):
    """Serve the batch on a fresh engine with ``options``, under the
    fault plan ``plan``: (tokens, finish reasons, metrics)."""
    from paddle_tpu_torch.resilience import FaultInjector
    eng = _serving_engine(model, **options)
    try:
        if plan is None:
            res = eng.generate(prompts, sps)
        else:
            with FaultInjector(plan):
                res = eng.generate(prompts, sps)
        return ([r.output_token_ids for r in res],
                [r.finish_reason for r in res], eng.metrics)
    finally:
        eng.shutdown()


def _check_sequential(model, prompts, sps, tokens, tag, **options):
    """Each request alone on a fresh engine draws the batch's tokens."""
    seq = _serving_engine(model, **options)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        (one,) = seq.generate([p], [sp])
        if one.output_token_ids != tokens[i]:
            raise AssertionError(f"{tag}: request {i} served alone differs "
                                 f"from the batch")
    seq.shutdown()


QUANT_SERVING = dict(kv_cache_dtype="int8", guard=True)


def phase_quant_serving(bf16, profile=False):
    """GPT-1.3B served over int8 KV pools with the guard: 10 graphs at
    ``warmup()`` and none after, 64 tokens a request with finite logits,
    the LayerNorm launches of every forward, continuous == sequential,
    the decode graph (logits and flags) bit-identical to its uncaptured
    program, the pools at half the bf16 pools' bytes plus the scales;
    then the fault plans (a NaN logits row, a crashed decode step) back to
    the clean run's tokens, an absurd scale limit finishing every request
    as "anomaly", and fp8_e4m3 pools continuous == sequential. Prints,
    ungated, the greedy requests' agreement with the bf16 pools' tokens
    (``bf16``: phase_serving's run) and int8's serving numbers beside
    bf16's."""
    from paddle_tpu_torch.resilience import FaultPlan, FaultSpec
    cfg, model = _serving_model("quantized serving")
    prompts, sps = _serving_requests(cfg.vocab_size)
    eng = _serving_engine(model, **QUANT_SERVING)
    bound = eng.config.compile_bound
    boot = eng.warmup()
    print(f"[quantized serving] {QUANT_SERVING}: warmup captured "
          f"{boot['programs']} programs in {boot['boot_ms']:.1f} ms "
          f"(compile bound {bound})")
    if not boot["programs"] == boot["compiled"] == bound == 10:
        raise AssertionError(f"warmup built {boot}, bound {bound}")
    finite = []
    originals = _watch_finite(eng, finite)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = eng.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("quantized serving")
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics
    if m.compile_count != bound:
        raise AssertionError(f"generate captured {m.compile_count - bound} "
                             f"more programs")
    forwards = m.prefill_steps + m.decode_steps
    expect = {k: 0 for k in launches}
    expect.update(ln_fwd=forwards * (cfg.num_layers + 1),
                  ln_res_fwd=forwards * cfg.num_layers)
    print(f"[quantized serving] {m.prefill_steps} prefills + "
          f"{m.decode_steps} decode steps, all graph replays; launches "
          f"{launches}")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")
    if len(finite) != forwards or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits (or a forward not seen)")
    tokens = [r.output_token_ids for r in results]
    if any(len(t) != 64 for t in tokens) or m.guard_anomalies \
            or {r.finish_reason for r in results} != {"length"}:
        raise AssertionError("a request without 64 tokens, or flagged")
    pool_bytes = eng.kv_pool_bytes
    scales = 2 * cfg.num_layers * eng.config.num_pages * cfg.num_heads * 4
    print(f"[quantized serving] pools {pool_bytes} B (codes + scales, "
          f"{eng.kv_bytes_per_token:.2f} B a token) against bf16's "
          f"{bf16['kv_pool_bytes']} B ({bf16['kv_bytes_per_token']:.2f} B a "
          f"token): {pool_bytes / bf16['kv_pool_bytes']:.5f}")
    if pool_bytes != bf16["kv_pool_bytes"] // 2 + scales:
        raise AssertionError("int8 pools are not half the bf16 pools' "
                             "bytes plus their scales")
    eng._programs.update(originals)
    snap = m.snapshot()
    eng.shutdown()
    _check_sequential(model, prompts, sps, tokens, "int8, guarded",
                      **QUANT_SERVING)
    print("[quantized serving] continuous == sequential for all 8 requests")
    check_decode_graph(_serving_engine(model, **QUANT_SERVING), prompts, sps)

    # each plan evicts the latest-arrived request at decode step `at`,
    # after its 1 + at tokens; its replay prefill re-quantizes prompt and
    # tokens at once where the clean run grew its pages' scales, so from
    # there its tokens may drift (the reference's documented tolerance):
    # the other requests and its tokens before the eviction must match,
    # and two runs of the plan must agree
    plans = {"nan logits": FaultSpec("serving.logits", "nan_grad", at=2),
             "decode fault": FaultSpec("serving.decode", "exception", at=4)}
    victim = len(prompts) - 1
    for tag, spec in plans.items():
        (got, fins, mm), (again, _, _) = (
            _serve(model, prompts, sps, FaultPlan([spec]), **QUANT_SERVING)
            for _ in range(2))
        counts = (mm.guard_anomalies, mm.decode_fault_recoveries,
                  mm.requests_evicted)
        differ = [i for i, (a, b) in enumerate(zip(got, tokens)) if a != b]
        first = next((j for j, (a, b) in enumerate(zip(got[victim],
                                                       tokens[victim]))
                      if a != b), 64)
        plain, _, _ = _serve(model, prompts, sps, FaultPlan([spec]),
                             guard=True)
        plain_differ = [i for i, (a, b) in enumerate(zip(plain,
                                                         bf16["tokens"]))
                        if a != b]
        print(f"[quantized serving] {tag} ({spec}): anomalies, recoveries, "
              f"evictions {counts}, finish {set(fins)}; requests with other "
              f"tokens than the clean run {differ} (the evicted request "
              f"{victim} from token {first}, its replay from token "
              f"{1 + spec.at}), a second run the same {again == got}; on "
              f"bf16 pools, requests with other tokens {plain_differ}")
        want = (1, 0, 1) if tag == "nan logits" else (0, 1, 1)
        if counts != want or set(differ) - {victim} or first < 1 + spec.at \
                or again != got or set(fins) != {"length"}:
            raise AssertionError(f"{tag}: did not recover to the clean run")
    _, fins, mm = _serve(model, prompts, sps, guard_scale_limit=1e-6,
                         **QUANT_SERVING)
    print(f"[quantized serving] guard_scale_limit=1e-6: finish {set(fins)}, "
          f"{mm.guard_anomalies} anomalies")
    if set(fins) != {"anomaly"}:
        raise AssertionError("an overflowing scale did not finish every "
                             "request as an anomaly")
    fp8, fins, _ = _serve(model, prompts, sps, kv_cache_dtype="fp8_e4m3")
    if any(len(t) != 64 for t in fp8):
        raise AssertionError("fp8_e4m3: a request without 64 tokens")
    _check_sequential(model, prompts, sps, fp8, "fp8_e4m3",
                      kv_cache_dtype="fp8_e4m3")
    print("[quantized serving] fp8_e4m3 pools: 64 tokens a request, "
          "continuous == sequential")

    for tag, run in (("int8", tokens), ("fp8_e4m3", fp8)):
        agree = []
        for i, sp in enumerate(sps):
            if sp.temperature == 0.0:
                a, b = run[i], bf16["tokens"][i]
                first = next((j for j, (x, y) in enumerate(zip(a, b))
                              if x != y), len(a))
                agree.append((i, first, sum(x == y for x, y in zip(a, b))))
        print(f"[quantized serving] {tag} against bf16 pools, greedy "
              f"requests (request, first differing token, equal tokens of "
              f"64): {agree} (random weights: not gated)")
    tps = m.generated_tokens / wall
    print(f"[quantized serving] {card_line()}: int8 {tps:.1f} tokens/s, "
          f"mean decode step {snap['decode_step_ms']['mean']:.2f} ms, TTFT "
          f"p50 {snap['ttft_ms']['p50']:.1f} ms, peak {peak / 2**30:.2f} GiB;"
          f" bf16 {bf16['tokens_per_s']:.1f} tokens/s, "
          f"{bf16['decode_ms']:.2f} ms, {bf16['ttft_p50_ms']:.1f} ms, "
          f"{bf16['peak'] / 2**30:.2f} GiB")
    if profile:
        profile_decode(_serving_engine(model, **QUANT_SERVING), prompts, sps)
    return launches


# ------------------------------------------------------ training kernels
def _attention_inputs(dtype, gen, b=B, sq=S, sk=S, h=H, d=D):
    """q, k, v as the strided views GPTAttention splits off its fused
    projection ([b, s, h, 3d]), and a cotangent do."""
    if sq == sk:
        qkv = torch.randn(b, sq, h, 3 * d, device="cuda", generator=gen)
        q, k, v = qkv.to(dtype).split(d, dim=-1)
    else:
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
        kv = torch.randn(b, sk, h, 2 * d, device="cuda", generator=gen)
        k, v = kv.to(dtype).split(d, dim=-1)
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
    return q, k, v, do


def _delta(do, o):
    b, sq, h, _ = do.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * h, sq).contiguous()


def _flash_terms(q, k, v, do, lse, delta, causal, scale):
    """Each attention output's sum of the magnitudes of the products whose
    bf16 factor may round differently, from the plain version's p (given
    lse) and ds (given delta), as ``[b, s, h, d]`` f32: o = p @ v,
    dq = scale * ds @ k, dk = scale * ds^T @ q, dv = p^T @ do."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    b, sq, h, _ = q.shape
    log2e = 1.4426950408889634
    p = torch.exp2(fa._scores(q, k, causal, scale)
                   - lse.reshape(b, h, sq, 1) * log2e)
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    ds = (p * (dof @ vf.transpose(-1, -2)
               - delta.reshape(b, h, sq, 1))).abs()
    terms = (p @ vf.abs(), scale * ds @ kf.abs(),
             scale * ds.transpose(-1, -2) @ qf.abs(),
             p.transpose(-1, -2) @ dof.abs())
    return tuple(t.transpose(1, 2) for t in terms)


def check_flash_cases(err, gen, dtype, cases):
    """Each flash kernel against its plain version on the same inputs, at
    each ``(causal, shape)`` of ``cases`` in ``dtype``; the largest
    errors go into ``err`` ({kernel: max abs err}). Against a single key
    p is 1 and ds = p (dP - D) is exactly 0: dq and dk are the rounding
    noise of that cancellation on both sides, held within 1e-5 absolute;
    dv (= do) as everywhere."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    for causal, shape in cases:
        q, k, v, do = _attention_inputs(dtype, gen, **shape)
        tag = f"{tuple(q.shape)}x{k.shape[1]} causal={causal} " \
              f"{str(dtype).split('.')[1]}"
        scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        o_ref, lse_ref = fa._flash_fwd_ref(q, k, v, causal, scale)
        torch.cuda.synchronize()
        args = (q, k, v, do, lse_ref, _delta(do, o_ref), causal, scale)
        t_o, t_dq, t_dk, t_dv = _flash_terms(*args)
        err["flash_fwd"] = max(
            err["flash_fwd"],
            check_terms(f"flash_fwd o {tag}", o, o_ref, t_o),
            check_sum(f"flash_fwd lse {tag}", lse, lse_ref))
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        dq_ref = fa._flash_bwd_dq_ref(*args)
        dk_ref, dv_ref = fa._flash_bwd_dkv_ref(*args)
        if k.shape[1] == 1:
            e_dq = _held(f"flash_bwd_dq {tag}", dq,
                         (dq.float() - dq_ref.float()).abs(),
                         torch.full_like(t_dq, 1e-5))
            e_dk = _held(f"flash_bwd_dkv dk {tag}", dk,
                         (dk.float() - dk_ref.float()).abs(),
                         torch.full_like(t_dk, 1e-5))
        else:
            e_dq = check_terms(f"flash_bwd_dq {tag}", dq, dq_ref, t_dq)
            e_dk = check_terms(f"flash_bwd_dkv dk {tag}", dk, dk_ref, t_dk)
        err["flash_bwd_dq"] = max(err["flash_bwd_dq"], e_dq)
        err["flash_bwd_dkv"] = max(
            err["flash_bwd_dkv"], e_dk,
            check_terms(f"flash_bwd_dkv dv {tag}", dv, dv_ref, t_dv))
    return err


def check_flash(gen):
    """Each flash kernel against its plain version on the same inputs,
    then the autograd Function against the plain versions and against
    autograd through the plain forward. Returns {kernel: max abs err}."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    err = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(True, dict()),
             (False, dict(b=1, sq=200, sk=328, h=4, d=D)),    # ragged
             # the bf16 forward's 128-row tiles: causal and ragged with
             # sq != sk both ways, a length that is not a multiple of 128,
             # and a single (b, h)
             (True, dict(b=1, sq=200, sk=328, h=4, d=D)),
             (True, dict(b=1, sq=328, sk=200, h=4, d=D)),
             (True, dict(b=2, sq=1000, sk=1000, h=4, d=D)),
             (True, dict(b=1, sq=S, sk=S, h=1, d=D))]
    for dtype in (torch.float32, torch.bfloat16):
        check_flash_cases(err, gen, dtype, cases)
        # the autograd Function (kernel path) on a fused projection's
        # views, against (1) the plain versions chained by hand on the
        # same tensors, delta taken from the Function's o as its
        # backward takes it, at the kernels' limits; and
        # (2) autograd through the plain forward on the same values in
        # f32 (the exact gradient): bf16 within 2^-7 of the largest
        # magnitude of each of q's, k's and v's gradients, since the
        # reference's backward takes delta from o rounded to bf16, which
        # moves rows whose exact gradient is near zero by a bf16 ulp of
        # delta times |k|
        q, k, v, do = _attention_inputs(dtype, gen)
        qkv = torch.cat([q, k, v], dim=-1)
        scale = D ** -0.5
        leaf = qkv.detach().clone().requires_grad_()
        o = fa.flash_attention_bshd(*leaf.split(D, dim=-1), causal=True)
        o.backward(do)
        o_ref, lse_ref = fa._flash_fwd_ref(q, k, v, True, scale)
        args = (q, k, v, do, lse_ref, _delta(do, o.detach()), True, scale)
        chained = torch.cat([fa._flash_bwd_dq_ref(*args),
                             *fa._flash_bwd_dkv_ref(*args)], dim=-1)
        exact = qkv.float().detach().clone().requires_grad_()
        o_exact = fa._flash_fwd_ref(*exact.split(D, dim=-1), True, scale)[0]
        o_exact.backward(do.float())
        terms = _flash_terms(*args)
        torch.cuda.synchronize()
        tag = str(dtype).split('.')[1]
        check_terms(f"flash_autograd o {tag}", o.detach(), o_ref, terms[0])
        check_terms(f"flash_autograd dqkv {tag}", leaf.grad, chained,
                    torch.cat(terms[1:], dim=-1))
        for i, part in enumerate("qkv"):
            check_sum(f"flash_exact d{part} {tag}",
                      leaf.grad[..., i * D:(i + 1) * D],
                      exact.grad[..., i * D:(i + 1) * D])
    return err


def check_ln_bwd(gen):
    """ln_bwd against its plain version (rows 4096 and 8 at hidden 2048,
    4097 rows, which the kernel's row split leaves ragged, and 4096 rows
    at hidden 1024 and 4096; plain and residual, act None and gelu, f32
    and bf16 rows with f32 weights, as on the training path), then the
    LayerNorm autograd Functions (kernel path) against autograd through
    the plain forwards."""
    from paddle_tpu_torch.ops.cuda import norm
    err = {"ln_bwd": 0.0, "ln_bwd_res": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for rows, hidden in ((B * S, HIDDEN), (8, HIDDEN), (B * S + 1, HIDDEN),
                             (B * S, 512), (B * S, 1024), (B * S, 4096)):
            (h, gy, _w, _b), = _inputs(rows, dtype, gen, hidden=hidden)
            (gh, _x, w, b), = _inputs(rows, torch.float32, gen, hidden=hidden)
            gh = gh.to(dtype)
            for act, res in ((None, False), (None, True), ("gelu", True)):
                name = "ln_bwd_res" if res else "ln_bwd"
                tag = f"{name} rows={rows} hidden={hidden} act={act}"
                kind = str(dtype).split('.')[1]
                args = (h, gy, w, b, EPS, act, gh if res else None)
                got, want = norm.ln_bwd(*args), norm._ln_bwd_ref(*args)
                torch.cuda.synchronize()
                err[name] = max(err[name],
                                check_close(f"{tag} dx {kind}", got[0], want[0]),
                                check_sum(f"{tag} dw {kind}", got[1], want[1]),
                                check_sum(f"{tag} db {kind}", got[2], want[2]))
        (x, r, _w, _b), = _inputs(B * S, dtype, gen)
        (gy, gh, w, b), = _inputs(B * S, torch.float32, gen)
        gy, gh = gy.to(dtype), gh.to(dtype)
        for kernel, plain, ins, cots in (
                (norm.ln_fwd, norm._ln_fwd_ref, (x, w, b), (gy,)),
                (lambda *t: norm.ln_res_fwd(*t, act="gelu"),
                 lambda *t: norm._ln_res_fwd_ref(*t, act="gelu"),
                 (x, r, w, b), (gh, gy))):
            grads = []
            for fn in (kernel, plain):
                leaves = [t.detach().clone().requires_grad_() for t in ins]
                outs = fn(*leaves, EPS)
                torch.autograd.backward(
                    list(outs) if len(cots) == 2 else [outs], list(cots))
                grads.append([t.grad for t in leaves])
            torch.cuda.synchronize()
            for i, (g_kernel, g_plain) in enumerate(zip(*grads)):
                tag = f"ln_autograd ({len(cots)} outputs) grad {i} " \
                      f"{str(dtype).split('.')[1]}"
                # the residual Function recomputes the statistics from h
                # as stored (bf16), as _ln_res_bwd_rule does, where
                # autograd through the plain forward differentiates the
                # f32 h: xhat moves by up to 2^-8, so every gradient is
                # held within 2^-7 of its largest magnitude
                if dtype == torch.bfloat16 and len(cots) == 2:
                    check_sum(tag, g_kernel, g_plain, rel=2.0 ** -7)
                elif g_kernel.dim() == 2:
                    check_close(tag, g_kernel, g_plain)
                else:
                    check_sum(tag, g_kernel, g_plain)
    return err


def _bound(costs, name=None):
    """(bound ms, "bytes" or "operations") of one launch, from the
    ``KernelCost`` list ``ops/cuda/cost.py`` gives for a call: its only
    entry, or the one called ``name``."""
    from paddle_tpu_torch.ops.cuda import cost
    (c,) = [c for c in costs if name in (None, c.name)]
    return cost.bound_ms(c.bytes, c.flops, c.peak)


def time_flash(gen, shape, causal):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at one bf16 ``(b, s, h,
    d)`` by CUDA events: kernel, plain version, bound, and the library
    call (SDPA's forward; for the backward pair, SDPA's backward alone:
    ``autograd.grad`` on a retained graph, the one library call that
    computes dq, dk and dv). Returns (rows, the inputs' two sets, the
    forward's arguments, SDPA's [b, h, s, d] copies)."""
    from paddle_tpu_torch.ops.cuda import cost
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, s, h, d = shape
    t = {}
    scale = 1.0 / math.sqrt(d)
    sets = [_attention_inputs(torch.bfloat16, gen, b, s, s, h, d)
            for _ in range(2)]
    stats = []
    for q, k, v, do in sets:
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        stats.append((lse, _delta(do, o)))
    fwd_args = [(q, k, v, causal, scale) for q, k, v, _ in sets]
    bwd_args = [(q, k, v, do, lse, dl, causal, scale)
                for (q, k, v, do), (lse, dl) in zip(sets, stats)]
    lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in (q, k, v, do))
                for q, k, v, do in sets]
    few = dict(reps=10, per_rep=5)
    rows = [
        ("flash_fwd", fa.flash_fwd, fa._flash_fwd_ref, fwd_args,
         (lambda q, k, v, do: sdpa(q, k, v, is_causal=causal), lib_sets)),
        ("flash_bwd_dq", fa.flash_bwd_dq, fa._flash_bwd_dq_ref, bwd_args,
         None),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, fa._flash_bwd_dkv_ref, bwd_args,
         None),
    ]
    for name, fn, ref, args, lib in rows:
        bound, by = _bound(getattr(cost, name)(*args[0]))
        t[name] = {"ms": device_ms(fn, args, **few),
                   "plain_ms": device_ms(ref, args, **few),
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": device_ms(lib[0], lib[1], **few)
                   if lib else None,
                   "shape": list(shape), "causal": causal,
                   "dtype": "bfloat16"}
    graphs = []
    for q, k, v, do in lib_sets:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        graphs.append((sdpa(*leaves, is_causal=causal), leaves, do))
    t["flash_bwd_pair"] = {
        "ms": t["flash_bwd_dq"]["ms"] + t["flash_bwd_dkv"]["ms"],
        "library_ms": device_ms(
            lambda out, leaves, do: torch.autograd.grad(
                out, leaves, do, retain_graph=True), graphs, **few)}
    del graphs
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        t[name]["pair_ms"] = t["flash_bwd_pair"]["ms"]
        t[name]["pair_library_ms"] = t["flash_bwd_pair"]["library_ms"]
    return t, sets, fwd_args, lib_sets


def time_train_kernels(gen):
    """Each training kernel at the path's shapes (bf16), by CUDA events:
    kernel, plain version, bound and the library call where there is
    one."""
    from paddle_tpu_torch.ops.cuda import cost, norm
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = 1.0 / math.sqrt(D)
    t, sets, fwd_args, lib_sets = time_flash(gen, (B, S, H, D), True)

    def lib_fwd_bwd(q, k, v, do):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = sdpa(*leaves, is_causal=True)
        return torch.autograd.grad(out, leaves, do)

    def kernel_fwd_bwd(q, k, v, do):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention_bshd(*leaves, causal=True, scale=scale)
        return torch.autograd.grad(out, leaves, do)

    few = dict(reps=10, per_rep=5)
    t["flash_fwd_bwd"] = {
        "ms": device_ms(kernel_fwd_bwd, [x for x in sets], **few),
        "library_ms": device_ms(lib_fwd_bwd, lib_sets, **few)}
    # the forward without the causal mask: every block runs all 8 key
    # tiles, so the wave tail of the causal grid is out of the reading
    bound, by = _bound(cost.flash_fwd(*fwd_args[0][:3], False, scale))
    t["flash_fwd_full"] = {
        "ms": device_ms(fa.flash_fwd, [a[:3] + (False, scale)
                                       for a in fwd_args], **few),
        "bound_ms": bound, "bound_by": by,
        "library_ms": device_ms(lambda q, k, v, do: sdpa(q, k, v), lib_sets,
                                **few)}

    for rows_ in (B * S, 8):
        copies = max(1, min(64, math.ceil(150e6 / (4 * rows_ * HIDDEN * 2))))
        ins = []
        for _ in range(copies):
            (h_, gy, _w, _b), = _inputs(rows_, torch.bfloat16, gen)
            (gh, _x, w, b), = _inputs(rows_, torch.float32, gen)
            ins.append((h_, gy, gh.to(torch.bfloat16), w, b))
        lib_args = []
        for h_, gy, _gh, w, b in ins:
            # F.layer_norm takes no bf16 rows with f32 weights: the
            # yardstick gets bf16 copies of the weights
            leaves = [x.detach().to(torch.bfloat16).requires_grad_()
                      for x in (h_, w, b)]
            y = torch.nn.functional.layer_norm(leaves[0], (HIDDEN,),
                                               leaves[1], leaves[2], EPS)
            lib_args.append((y, leaves, gy))
        for name in ("ln_bwd", "ln_bwd_res"):
            res = name == "ln_bwd_res"
            args = [(h_, gy, w, b, EPS, None, gh if res else None)
                    for h_, gy, gh, w, b in ins]
            bound, by = _bound(cost.ln_bwd(*args[0]))
            t[(name, rows_)] = {
                "ms": device_ms(norm.ln_bwd, args),
                "plain_ms": device_ms(norm._ln_bwd_ref, args),
                "bound_ms": bound, "bound_by": by,
                "library_ms": None if res else device_ms(
                    lambda y, leaves, gy: torch.autograd.grad(
                        y, leaves, gy, retain_graph=True), lib_args),
                "rows": rows_, "hidden": HIDDEN, "dtype": "bfloat16"}
    for key, v in t.items():
        print(f"[train kernels] {key}: " + ", ".join(
            f"{k} {x:.5f}" if isinstance(x, float) else f"{k} {x}"
            for k, x in v.items()))
    return t


def phase_train_kernels():
    gen = torch.Generator(device="cuda").manual_seed(1)
    err = check_flash(gen)
    err.update(check_ln_bwd(gen))
    print(f"[train kernels] agree with their plain versions, forward and "
          f"gradients; max abs err {err}")
    print(f"[train kernels] largest error as a share of its limit: "
          f"{shares(*err, 'flash_autograd', 'flash_exact', 'ln_autograd')}")
    return err, time_train_kernels(gen)


# ------------------------------------------- shapes no kernel takes (C.1)
def phase_tiny():
    """gpt3_tiny (head_dim 16) and ``nn.LayerNorm(LN_WIDE)`` on the card:
    shapes no kernel takes go to the compositions before any launch, as
    the reference falls back. The tiny GPT trains ``TINY_STEPS`` f32
    steps (dropout 0, ``to_static``, ``AdamW(fused=False)``) on the card
    and on the CPU from the same weights and batch: losses within
    ``TINY_REL``, every attention call routed, the LayerNorms (hidden 64)
    on their kernels. The wide LayerNorm's output and gradients on the
    card against the CPU's, f32 and bf16 rows."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
    from paddle_tpu_torch.nn import functional as F
    cfg = gpt3_tiny(fused_ln=True)
    vocab = cfg.vocab_size
    base = GPTForCausalLM(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids, labels = (torch.tensor(rng.integers(0, vocab, (2, 64)))
                   for _ in range(2))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        model.train()
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters(), fused=False)

        @pt.jit.to_static
        def step(ids, labels):
            opt.clear_grad()
            logits = model(ids)
            loss = F.cross_entropy(logits.reshape([-1, vocab]),
                                   labels.reshape([-1]))
            loss.backward()
            opt.step()
            return loss

        reset_launches()
        losses[dev] = [step(ids.to(dev), labels.to(dev)).item()
                       for _ in range(TINY_STEPS)]
        routed, launches = read_routed(), _launches()
    print(f"[tiny] gpt3_tiny(fused_ln=True) head_dim "
          f"{cfg.hidden_size // cfg.num_heads}, f32: losses on the card "
          f"{losses['cuda']}, on the CPU {losses['cpu']}")
    print(f"[tiny] routed {routed}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    for c, g in zip(losses["cpu"], losses["cuda"]):
        if not (math.isfinite(g) and abs(g - c) <= TINY_REL * abs(c)):
            raise AssertionError(f"tiny GPT losses differ beyond {TINY_REL}"
                                 f": {losses}")
    # the card's first call also runs WARMUP_CALLS eager steps
    steps = TINY_STEPS + WARMUP_CALLS
    expect = step_launches(cfg, steps, fused=False, guard=False)
    expect.update(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0)
    if launches != expect or routed["flash_attention"] != \
            cfg.num_layers * steps or routed["layer_norm"] or \
            routed["fused_ln_residual"]:
        raise AssertionError(f"tiny GPT: launches {launches} (expected "
                             f"{expect}), routed {routed}")

    from paddle_tpu_torch.ops.cuda import norm
    gen = torch.Generator().manual_seed(2)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        layer = pt.nn.LayerNorm(LN_WIDE)
        with torch.no_grad():
            layer.weight.copy_(1 + 0.1 * torch.randn(LN_WIDE, generator=gen))
            layer.bias.copy_(0.1 * torch.randn(LN_WIDE, generator=gen))
        x = torch.randn(8, LN_WIDE, generator=gen).to(dtype)
        gy = torch.randn(8, LN_WIDE, generator=gen)   # y is f32 (f32 w)
        got = {}
        for dev in ("cpu", "cuda"):
            ln = copy.deepcopy(layer).to(dev)
            leaf = x.detach().to(dev).requires_grad_()
            reset_launches()
            y = ln(leaf)
            y.backward(gy.to(dev))
            # on the CPU fused=None asks for the composition itself
            if norm.ROUTED["layer_norm"] != (dev == "cuda") or \
                    any(_launches().values()):
                raise AssertionError(f"LayerNorm({LN_WIDE}) on {dev}: "
                                     f"routed {read_routed()}, launches "
                                     f"{_launches()}")
            got[dev] = [t.detach().cpu() for t in (y, leaf.grad,
                                                   ln.weight.grad, ln.bias.grad)]
        kind = str(dtype).split('.')[1]
        for name, g, c in zip(("y", "dx", "dw", "db"), got["cuda"], got["cpu"]):
            # the composition rounds each step to x's type and the two
            # devices reduce in another order: bf16 rows within 2^-7 of
            # the largest magnitude (two bf16 ulps there)
            if dtype == torch.bfloat16:
                err = max(err, check_sum(f"ln_wide {name} {kind}", g, c,
                                         rel=2.0 ** -7))
            else:
                err = max(err, check_sum(f"ln_wide {name} {kind}", g, c))
    print(f"[tiny] nn.LayerNorm({LN_WIDE}) forward and backward on the card "
          f"(routed to the composition, no launch) against the CPU: max abs "
          f"err {err:.3g}, shares {shares('ln_wide')['ln_wide']}")
    return {"losses": losses, "routed": routed}


# ------------------------------------------------- the sampler's noise (C.2)
def phase_sampler():
    """The sampler's threefry Gumbel noise drawn on the card against the
    CPU's, on ``SAMPLER_ROWS`` rows of seeded f32 logits at GPT-1.3B's
    vocab: the uniforms bit for bit, the noise within 2 ulp of each log
    (``|dg| <= 2 ulp(g) + 2^-22``: both devices take the correctly
    rounded log, so it is as a rule exact), and the tokens sampled at
    temperature 0.8, top_k 50, top_p 0.9 identical."""
    from paddle_tpu_torch.serving import sampler
    rows, vocab = SAMPLER_ROWS, 50304
    rng = np.random.default_rng(5)
    logits = torch.tensor(3 * rng.standard_normal((rows, vocab)),
                          dtype=torch.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, rows).tolist()
    positions = rng.integers(0, 2048, rows).tolist()
    knobs = ([0.8] * rows, [50] * rows, [0.9] * rows)
    got = {}
    for dev in ("cpu", "cuda"):
        key = sampler.fold_in(sampler.prng_key(seeds, dev), positions)
        tokens = sampler.sample_tokens(logits.to(dev), seeds, positions,
                                       *knobs)
        got[dev] = [t.cpu() for t in (sampler.uniform(key, vocab),
                                      sampler.gumbel(key, vocab), tokens)]
    torch.cuda.synchronize()
    (u_c, g_c, t_c), (u_g, g_g, t_g) = got["cpu"], got["cuda"]
    if not torch.equal(u_c.view(torch.int32), u_g.view(torch.int32)):
        raise AssertionError("sampler: uniforms on the card differ from the "
                             "CPU's")
    ulp = torch.exp2(torch.floor(torch.log2(
        g_c.abs().clamp(min=torch.finfo(torch.float32).tiny))) - 23)
    err = _held("sampler gumbel float32", g_g, (g_g - g_c).abs(),
                2 * ulp + 2.0 ** -22)
    if not torch.equal(t_c, t_g):
        raise AssertionError(f"sampler: tokens differ on "
                             f"{int((t_c != t_g).sum())} of {rows} rows")
    dev_logits = logits.cuda()
    t0 = time.perf_counter()
    for _ in range(5):
        sampler.sample_tokens(dev_logits, seeds, positions, *knobs)
    torch.cuda.synchronize()
    print(f"[sampler] {rows} rows x {vocab}: uniforms equal the CPU's bit "
          f"for bit, Gumbel noise max abs err {err:.3g} ("
          f"{int((g_g == g_c).sum())} of {g_c.numel()} exact), sampled "
          f"tokens identical; sample_tokens on the card "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} ms a call (host clock)")
    return err


# ------------------------------------------------------- fused AdamW
def _adam_inputs(shape, gen, m_dtype, g_dtype=torch.float32):
    def rnd(scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)
    p, g = rnd(), rnd().to(g_dtype)
    m, v = rnd(0.1).to(m_dtype), (rnd(0.1) ** 2).to(m_dtype)
    return p, g, m, v


def _adam_sc(decay_on):
    c1, c2 = 1 - 0.9 ** ADAM_T, 1 - 0.999 ** ADAM_T
    return torch.tensor([ADAM_LR, c1, c2, float(decay_on)], device="cuda")


ADAM_KW = dict(beta1=0.9, beta2=0.999, eps=1e-8)


def check_adam(name, got, want):
    """p, m and v bit for bit equal to the plain version, bf16 moments
    too: both round with IEEE-rounded f32 ops in the reference kernel's
    order (the kernel through ``__f*_rn`` intrinsics, so nvcc contracts
    nothing into an FMA). A looser limit would not see a wrong decay: at
    ``AdamW(1e-4)``'s lr·wd = 1e-6 the decoupled decay moves p by
    1e-6·|p|, inside rtol 1e-6, while it moves p by several f32 ulps."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    differ = got.view(bits[got.dtype]) != want.view(bits[want.dtype])
    err = (got.float() - want.float()).abs()
    if bool(differ.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(differ.sum())} elements differ "
                             f"from the plain version, max abs err "
                             f"{err.max().item()}")
    words = name.split()
    SHARES.setdefault((words[0], words[-1]), 0.0)
    return 0.0


def check_parts(name, got, want):
    """Sums of squares: finite verdicts exact, finite sums within 1e-5
    relative (f32 sums in another order)."""
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        raise AssertionError(f"{name}: finite verdicts differ")
    ok = torch.isfinite(want)
    if not bool(ok.any()):
        return 0.0
    got, want = got[ok], want[ok]
    return _held(name, got, (got - want).abs(), 1e-5 * want.abs() + 1e-30)


def phase_adam_kernels():
    """Kernel #9 against its plain version at the path's shapes (and two
    layouts it does not have), then its times."""
    from paddle_tpu_torch.ops.cuda import optim
    gen = torch.Generator(device="cuda").manual_seed(2)
    err = {"adam_update": 0.0, "adam_update_guard": 0.0,
           "adam_guard_sumsq": 0.0}
    cases = [(shape, mdt, torch.float32, decay_on, guard)
             for shape in ADAM_CHECK_SHAPES
             for mdt in (torch.float32, torch.bfloat16)
             for decay_on in (True, False) for guard in (False, True)]
    cases.append(((2048, 6144), torch.float32, torch.bfloat16, True, True))
    for shape, mdt, gdt, decay_on, guard in cases:
        p, g, m, v = _adam_inputs(shape, gen, mdt, gdt)
        br, regions = optim._regions(shape)
        bad = None
        if guard:                     # one NaN in one row block
            bad = regions // 2
            g[bad * br + br // 2, shape[1] // 3] = float("nan")
        p_in, m_in, v_in = p.clone(), m.clone(), v.clone()
        ref = [p.clone(), m.clone(), v.clone()]
        sc = _adam_sc(decay_on)
        name = "adam_update_guard" if guard else "adam_update"
        parts = optim.fused_adam_update(p, g, m, v, sc, **ADAM_KW,
                                        weight_decay=ADAM_WD, guard=guard)
        ref_parts = optim._adam_ref(*ref[:1], g, *ref[1:], sc, ADAM_KW[
            "beta1"], ADAM_KW["beta2"], ADAM_KW["eps"], ADAM_WD, guard)
        torch.cuda.synchronize()
        tag = (f"{shape} decay_on={decay_on} g={str(gdt)[6:]} "
               f"{str(mdt).split('.')[1]}")
        for what, got, want in zip("pmv", (p, m, v), ref):
            err[name] = max(err[name], check_adam(
                f"{name} {what} {tag}", got, want))
        if guard:
            check_parts(f"{name} parts {tag}", parts, ref_parts)
            rows = slice(bad * br, (bad + 1) * br)
            for what, got, before in zip("pmv", (p, m, v),
                                         (p_in, m_in, v_in)):
                if not torch.equal(got[rows], before[rows]):
                    raise AssertionError(f"{name} {tag}: block {bad}'s "
                                         f"{what} changed under a NaN")
            if regions > 1 and torch.equal(p, p_in):
                raise AssertionError(f"{name} {tag}: no block moved")
            layout = optim._layout(shape)
            chunk = optim._chunk_sumsq(g, layout)
            want = optim._chunk_sumsq_ref(g, layout)
            torch.cuda.synchronize()
            err["adam_guard_sumsq"] = max(err["adam_guard_sumsq"], check_parts(
                f"adam_guard_sumsq {tag}", chunk, want))
    print(f"[adam kernels] agree with their plain versions on {len(cases)} "
          f"cases; max abs err {err}")
    print(f"[adam kernels] largest error as a share of its limit: "
          f"{shares(*err)}")
    return (err, *time_adam_kernels(gen))


def time_adam_kernels(gen):
    """The update (unguarded and guarded) and the sums of squares at each
    path shape, f32 everything as on the path, by CUDA events; then
    per-step sums over GPT-1.3B's 98 rank-2 weights."""
    from paddle_tpu_torch.ops.cuda import cost, optim
    few = dict(reps=10, per_rep=5)
    t = {}
    for shape, count in ADAM_PATH_SHAPES.items():
        n = shape[0] * shape[1]
        copies = max(1, math.ceil(200e6 / (16 * n)))
        sets = [_adam_inputs(shape, gen, torch.float32)
                for _ in range(copies)]
        sc = _adam_sc(True)
        layout = optim._layout(shape)
        parts = [optim._chunk_sumsq(g, layout) for _p, g, _m, _v in sets]
        kw = dict(**ADAM_KW, weight_decay=ADAM_WD)
        upd = [(p, g, m, v, sc) for p, g, m, v in sets]
        upd_guard = [(p, g, m, v, sc, layout, *ADAM_KW.values(), ADAM_WD, cp)
                     for (p, g, m, v), cp in zip(sets, parts)]
        ref = [(p, g, m, v, sc, *ADAM_KW.values(), ADAM_WD, False)
               for p, g, m, v in sets]
        ref_guard = [a[:-1] + (True,) for a in ref]
        steps = [torch.zeros((), device="cuda") for _ in sets]
        lib = [([p], [g], [m], [v], [], [st])
               for (p, g, m, v), st in zip(sets, steps)]

        def fused_adamw(*lists):
            torch._fused_adamw_(*lists, lr=ADAM_LR, beta1=0.9, beta2=0.999,
                                weight_decay=ADAM_WD, eps=1e-8,
                                amsgrad=False, maximize=False)

        regions = layout[2]
        vecdot = [(g.view(regions, -1),) * 2 for _p, g, _m, _v in sets]
        rows = {
            "adam_update": (lambda *a: optim.fused_adam_update(*a, **kw),
                            upd, optim._adam_ref, ref, (fused_adamw, lib)),
            "adam_update_guard": (optim._update, upd_guard, optim._adam_ref,
                                  ref_guard, None),
            "adam_guard_sumsq": (optim._chunk_sumsq, [(g, layout) for
                                 _p, g, _m, _v in sets],
                                 optim._chunk_sumsq_ref,
                                 [(g, layout) for _p, g, _m, _v in sets],
                                 (torch.linalg.vecdot, vecdot)),
        }
        costs = cost.adam(*upd[0], **kw) + cost.adam(*upd[0], **kw,
                                                    guard=True)
        for name, (fn, args, plain, plain_args, lib_call) in rows.items():
            bound, by = _bound(costs, name)
            t[(name, shape)] = {
                "ms": device_ms(fn, args, **few),
                "plain_ms": device_ms(plain, plain_args, **few),
                "bound_ms": bound, "bound_by": by,
                "library_ms": device_ms(lib_call[0], lib_call[1], **few)
                if lib_call else None,
                "shape": list(shape), "dtype": "float32",
                "per_step": count}
        del sets, parts, upd, upd_guard, ref, ref_guard, lib, vecdot
    for key, v in t.items():
        print(f"[adam kernels] {key[0]} {key[1]}: " + ", ".join(
            f"{k} {x:.5f}" if isinstance(x, float) else f"{k} {x}"
            for k, x in v.items() if k not in ("shape", "per_step")))
    per_step = {}
    for name in ("adam_update", "adam_update_guard", "adam_guard_sumsq"):
        rows = [v for key, v in t.items() if key[0] == name]
        total = {k: None if rows[0][k] is None else
                 sum(v[k] * v["per_step"] for v in rows)
                 for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        per_step[name] = total
        print(f"[adam kernels] {name}, one GPT-1.3B step (98 weights): " +
              ", ".join(f"{k} {x:.3f}" if x is not None else f"{k} null"
                        for k, x in total.items()))
    return t, per_step


# -------------------------------------------------------------- training
def phase_train():
    """GPT-1.3B, 10 train steps through the port's entry points: first a
    copy through ``dygraph_function`` (eagerly), then the step captured
    by ``to_static``, which must match it bit for bit."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    t0 = time.perf_counter()
    cfg, twin = _gpt()
    vocab = cfg.vocab_size
    twin_opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=twin.parameters(), fused=False)
    eager_step = _train_step(twin, twin_opt, vocab, guard=False)
    ids, labels = _batch(vocab, 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in twin.parameters())
    print(f"[train] gpt3_1p3b(fused_ln=True, dropout=0): {n_params / 1e9:.3f}"
          f" B f32 params, built in {time.perf_counter() - t0:.1f} s; "
          f"batch {B} x {S} tokens, AdamW(1e-4, fused=False), "
          f"to_static(amp_policy='bf16')")
    # the eager run first: the state tensors its optimizer registers
    # would key a new capture if they came after the first call
    reset_launches()
    eager = []
    for _ in range(TRAIN_STEPS):
        with pt.amp.activation_residency("bf16"):
            eager.append(eager_step.dygraph_function(ids, labels).item())
    eager_launches = read_launches("train, dygraph_function")
    if eager_launches != step_launches(cfg, TRAIN_STEPS, fused=False,
                                       guard=False):
        raise AssertionError(f"dygraph launches {eager_launches}")
    eager_weights = [p.detach() for p in twin.parameters()]
    del twin, twin_opt, eager_step
    gc.collect()
    torch.cuda.empty_cache()

    _, model = _gpt()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters(), fused=False)
    train_step = _train_step(model, opt, vocab, guard=False)
    reset_launches()
    losses, step_s, first = captured_run(train_step, [(ids, labels)] *
                                         TRAIN_STEPS)
    launches = read_launches("train")
    expect = step_launches(cfg, TRAIN_STEPS + WARMUP_CALLS, fused=False,
                           guard=False)
    print(f"[train] losses {losses}")
    print(f"[train] launches {launches} ({TRAIN_STEPS} steps and the "
          f"first call's {WARMUP_CALLS} eager warm-ups)")
    if launches != expect:
        raise AssertionError(f"train launches {launches} != {expect}")
    if len(train_step._compiled) != 1:
        raise AssertionError(f"{len(train_step._compiled)} captures")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] <= losses[0] - LOSS_DROP:
        raise AssertionError(f"loss did not fall by {LOSS_DROP}: {losses}")
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    bad = [n for n, p in model.named_parameters()
           if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    if missing or bad:
        raise AssertionError(f"parameters without a finite gradient: "
                             f"missing {missing}, non-finite {bad}")
    differ = [n for (n, a), b in zip(model.named_parameters(), eager_weights)
              if not torch.equal(a, b)]
    print(f"[train] dygraph_function from the same initial state: losses "
          f"{eager}; {len(differ)} of {len(eager_weights)} final weights "
          f"differ from the captured run's")
    if eager != losses or differ:
        raise AssertionError(f"captured and eager runs differ: losses "
                             f"{losses} / {eager}, weights {differ}")
    del eager_weights
    steady = statistics.median(step_s[1:])
    print(f"[train] every one of {len(list(model.parameters()))} parameters "
          f"has a finite gradient (LayerNorm weights included); the "
          f"captured run's {TRAIN_STEPS} losses and final weights equal "
          f"the eager run's bit for bit")
    print(f"[train] {card_line()}: step {steady * 1e3:.1f} ms (median of "
          f"steps 2-{TRAIN_STEPS}), {B * S / steady:.0f} tokens/s; {first}")
    breakdown(model, opt, ids, labels, vocab, steady)
    profile_train_step(train_step, (ids, labels), steady)
    return launches, losses


def captured_run(train_step, batches, after=None):
    """Call a ``to_static`` step once a batch (and ``after()``, untimed,
    after each): (losses, wall seconds a step, the first call's line).
    The first call discovers, captures and replays once: its time and
    its peak memory are its own, and the peak statistics are reset after
    it for the steady peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        losses.append(train_step(*batch).item())          # synchronises
        step_s.append(time.perf_counter() - t0)
        if after is not None:
            after()
        if i == 0:
            first = (torch.cuda.max_memory_allocated(),
                     torch.cuda.max_memory_reserved())
            torch.cuda.reset_peak_memory_stats()
    gib = 2 ** 30
    line = (f"first call (discovery, capture, first replay) "
            f"{step_s[0] * 1e3:.1f} ms, peak {first[0] / gib:.2f} GiB "
            f"allocated / {first[1] / gib:.2f} reserved; steady peak "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} / "
            f"{torch.cuda.max_memory_reserved() / gib:.2f} GiB")
    return losses, step_s, line


def step_launches(cfg, steps, fused, guard, remat=False):
    """Each kernel's launches over ``steps`` train steps of ``cfg``: the
    model's call sites, and one fused update of each rank-2 weight (four
    a layer, two embeddings), guarded with its sums of squares. With
    dropout in training attention leaves flash for the composition, and
    each forward draws 1 + 3 a layer keep masks (the embeddings', each
    layer's attention probabilities' and two residual dropouts'); under
    ``remat`` every block's forward runs again in the backward, its
    LayerNorm forwards, flash forward and masks with it."""
    n, rank2 = cfg.num_layers, 4 * cfg.num_layers + 2
    again = n if remat else 0
    drop = cfg.dropout > 0 or cfg.attention_dropout > 0
    flash = 0 if cfg.attention_dropout > 0 else n
    per_step = {"flash_fwd": flash + (again if flash else 0),
                "flash_bwd_dq": flash, "flash_bwd_dkv": flash,
                "ln_fwd": n + 1 + again, "ln_res_fwd": n + again,
                "ln_bwd": n + 1, "ln_bwd_res": n,
                "adam_update": rank2 if fused and not guard else 0,
                "adam_update_guard": rank2 if fused and guard else 0,
                "adam_guard_sumsq": rank2 if fused and guard else 0,
                "rms_fwd": 0, "bsa_fwd": 0,
                "keep_mask": 1 + 3 * (n + again) if drop else 0}
    return {k: steps * v for k, v in per_step.items()}


def breakdown(model, opt, ids, labels, vocab, step_s, tag="train"):
    """Where an eager step's time goes: the device time of its two
    halves by CUDA events (median of 3), forward + loss + backward under
    the bf16 policy, then the optimizer update; the host time of
    ``opt.step()``'s call (the time to enqueue it); and the eager step's
    own wall time (host clock to a synchronise), which the halves add up
    to. The captured step (``step_s``) replays the same kernels back to
    back, so its time is printed beside them, not as their whole."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    halves = {"forward+backward": [], "optimizer": [], "optimizer host": [],
              "eager step": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        opt.clear_grad()
        ev[0].record()
        with pt.amp.activation_residency("bf16"):
            loss = F.cross_entropy(model(ids).reshape([-1, vocab]),
                                   labels.reshape([-1]))
            loss.backward()
        ev[1].record()
        t0 = time.perf_counter()
        opt.step()
        halves["optimizer host"].append((time.perf_counter() - t0) * 1e3)
        ev[2].record()
        ev[2].synchronize()
        halves["eager step"].append((time.perf_counter() - t_step) * 1e3)
        halves["forward+backward"].append(ev[0].elapsed_time(ev[1]))
        halves["optimizer"].append(ev[1].elapsed_time(ev[2]))
    print(f"[{tag} breakdown] eager: " + ", ".join(
        f"{k} {statistics.median(v):.1f} ms" for k, v in halves.items())
        + f" (CUDA events and host clock, median of 3); the captured "
        f"step beside it: {step_s * 1e3:.1f} ms")


def profile_train_step(train_step, batch, step_s, tag="train"):
    """Device time by kernel over one train step (``train_step(*batch)``)
    under torch.profiler, and its share of the step's unprofiled wall
    time. The step's own ``record_function`` range, which the profiler
    lists on the device too, spans the kernels and is not counted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        train_step(*batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{tag} profile] one step: {busy_ms:.1f} ms of kernel time in "
          f"{sum(e.count for e in events)} kernels, "
          f"{100 * busy_ms / (step_s * 1e3):.1f} % of the {step_s * 1e3:.1f}"
          f" ms step; by kernel:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"[{tag} profile] {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:110]}")
    ln_fwd = [e for e in events if LN_FWD_KERNEL in e.key]
    print(f"[{tag} profile] the LayerNorm forwards: "
          f"{sum(e.self_device_time_total for e in ln_fwd) / 1e3:.3f} ms in "
          f"{sum(e.count for e in ln_fwd)} launches")


def _gpt(num_layers=None):
    """GPT-1.3B (optionally cut to ``num_layers``) with f32 masters from
    seed 0, in train mode, as phase 7 builds it."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    kw = {} if num_layers is None else {"num_layers": num_layers}
    cfg = gpt3_1p3b(fused_ln=True, dropout=0.0, attention_dropout=0.0, **kw)
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    model.train()
    return cfg, model


def _train_step(model, opt, vocab, guard, host_batch=False):
    """The GPT train step under ``to_static``, its loss under the
    profiler's ``loss`` scope (as ``tools/perfgate.py`` builds it);
    ``host_batch``: it takes its batch on the CPU and moves it to the
    card itself."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.observability import profile

    @pt.jit.to_static(amp_policy="bf16", guard=guard)
    def train_step(ids, labels):
        if host_batch:
            ids, labels = ids.to("cuda"), labels.to("cuda")
        opt.clear_grad()
        logits = model(ids)
        with profile.scope("loss"):
            loss = F.cross_entropy(logits.reshape([-1, vocab]),
                                   labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return train_step


def _batch(vocab, seed):
    data = torch.Generator("cuda").manual_seed(seed)
    return (torch.randint(0, vocab, (B, S), device="cuda", generator=data),
            torch.randint(0, vocab, (B, S), device="cuda", generator=data))


def _check_held_block(opt, emb_name, emb, rows, before):
    """Right after the faulted step: the poisoned row block of the
    embedding kept its p, m and v bytes, every other block moved, and
    the embedding's beta powers held."""
    st = opt.state_dict()
    now = {k: st[f"{emb_name}_{k}"] for k in before if k != "p"}
    now["p"] = emb.detach()
    br = rows.stop - rows.start
    for k in ("p", "moment1", "moment2"):
        moved = (now[k] != before[k]).reshape(-1, br * emb.shape[1]).any(1)
        block = rows.start // br
        if bool(moved[block]):
            raise AssertionError(f"faulted block's {k} changed")
        if int(moved.sum()) != moved.numel() - 1:
            raise AssertionError(f"{k}: only {int(moved.sum())} of "
                                 f"{moved.numel() - 1} clean blocks moved")
    for k in ("beta1_pow", "beta2_pow"):
        if not torch.equal(now[k], before[k]):
            raise AssertionError(f"the embedding's {k} advanced")
    return (f"rows {rows.start}-{rows.stop - 1} of {emb_name} kept their "
            f"p, m and v bytes, the other {moved.numel() - 1} blocks moved, "
            f"beta powers held at {before['beta1_pow'].item():.6f}, "
            f"{before['beta2_pow'].item():.6f}")


def phase_train_guarded(unfused_losses):
    """GPT-1.3B through the reference's optimized, guarded step, watched
    by a TrainingSentinel; a nan_grad fault after 10 clean steps. Steps
    1-10 and 12 run the captured step; step 11, the planted fault, runs
    through ``dygraph_function`` (a fault hook fires in Python, never in
    a replay)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    from paddle_tpu_torch.ops.cuda import optim
    from paddle_tpu_torch.resilience import (FaultInjector, FaultPlan,
                                             FaultSpec, SentinelAction,
                                             TrainingSentinel, sentinel)
    t0 = time.perf_counter()
    cfg, model = _gpt()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters(),
                             fused=True, guard=True)
    train_step = _train_step(model, opt, cfg.vocab_size, guard=True)
    ids, labels = _batch(cfg.vocab_size, 1)              # phase 7's batch
    emb_name, emb = next(iter(model.named_parameters()))
    if emb_name != "gpt.embeddings.word_embeddings.weight":
        raise AssertionError(f"first parameter is {emb_name}")
    # installed around step 11 alone: its first occurrence
    plan = FaultPlan([FaultSpec("optimizer.grads", "nan_grad", at=0)],
                     seed=0)
    # the element corrupt_array poisons, and its 128-row block
    idx = random.Random(plan.seed * 1000003).randrange(emb.numel())
    br, _ = optim._regions(emb.shape)
    block = idx // emb.shape[1] // br
    rows = slice(block * br, (block + 1) * br)
    torch.cuda.synchronize()
    print(f"[guarded train] built in {time.perf_counter() - t0:.1f} s; "
          f"to_static(amp_policy='bf16', guard=True), AdamW(1e-4, "
          f"fused=True, guard=True), TrainingSentinel(skip_limit=3); "
          f"nan_grad at step {TRAIN_STEPS + 1} lands in {emb_name} row "
          f"{idx // emb.shape[1]}, block {block}")

    sent = TrainingSentinel(skip_limit=3)
    losses, step_s, actions, summaries = [], [], [], []
    gib = 2 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sentinel.install(sent)
    try:
        for step in range(1, TRAIN_STEPS + 3):
            if step == TRAIN_STEPS + 1:
                st = opt.state_dict()
                before = {k: st[f"{emb_name}_{k}"].clone() for k in (
                    "moment1", "moment2", "beta1_pow", "beta2_pow")}
                before["p"] = emb.detach().clone()
                with FaultInjector(plan), \
                        pt.amp.activation_residency("bf16"):
                    t0 = time.perf_counter()
                    loss = train_step.dygraph_function(ids, labels).item()
            else:
                t0 = time.perf_counter()
                train_step(ids, labels)
                loss = train_step.last_guard["loss"]
            summary = opt.guard_summary()                # synchronises
            step_s.append(time.perf_counter() - t0)
            if step == 1:
                first = (torch.cuda.max_memory_allocated(),
                         torch.cuda.max_memory_reserved())
                torch.cuda.reset_peak_memory_stats()
            actions.append(sent.observe(step, loss=loss, summary=summary))
            losses.append(loss)
            summaries.append(summary)
            if step == TRAIN_STEPS + 1:
                held = _check_held_block(opt, emb_name, emb, rows, before)
    finally:
        sentinel.uninstall(sent)
    launches = read_launches("guarded train")
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    clean = losses[:TRAIN_STEPS]
    print(f"[guarded train] losses {losses}")
    print(f"[guarded train] actions {[a.name for a in actions]}; "
          f"summaries {summaries}")
    print(f"[guarded train] launches {launches} ({TRAIN_STEPS + 1} captured "
          f"steps, the first call's {WARMUP_CALLS} warm-ups, 1 eager step)")
    expect = step_launches(cfg, TRAIN_STEPS + 2 + WARMUP_CALLS, fused=True,
                           guard=True)
    if launches != expect:
        raise AssertionError(f"guarded launches {launches} != {expect}")
    if len(train_step._compiled) != 1:
        raise AssertionError(f"{len(train_step._compiled)} captures")
    want = [SentinelAction.OK] * TRAIN_STEPS + [SentinelAction.SKIP,
                                                SentinelAction.OK]
    if actions != want:
        raise AssertionError(f"actions {actions} != {want}")
    if any(s.regions != GUARD_REGIONS for s in summaries):
        raise AssertionError(f"regions {[s.regions for s in summaries]} "
                             f"!= {GUARD_REGIONS}")
    evt, faulted = sent.anomalies[0], summaries[TRAIN_STEPS]
    if len(sent.anomalies) != 1 or evt.kind != "nan_grad" or \
            evt.step != TRAIN_STEPS + 1 or faulted.bad_regions != 1:
        raise AssertionError(f"fault misclassified: {sent.anomalies}, "
                             f"{faulted}")
    if any(s.bad_regions for i, s in enumerate(summaries)
           if i != TRAIN_STEPS):
        raise AssertionError("a clean step had a bad region")
    print(f"[guarded train] faulted step: {held}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not clean[-1] <= clean[0] - LOSS_DROP:
        raise AssertionError(f"loss did not fall by {LOSS_DROP}: {clean}")
    delta = max(abs(a - b) for a, b in zip(clean, unfused_losses))
    print(f"[guarded train] clean losses against phase 7's (fused=False, "
          f"no guard): largest |delta| {delta:.3e} (limit {TRAJECTORY_TOL})")
    if delta > TRAJECTORY_TOL:
        raise AssertionError(f"guarded trajectory off by {delta}")
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"non-finite weights: {bad}")
    steady = statistics.median(step_s[1:TRAIN_STEPS])
    print(f"[guarded train] {card_line()}: step {steady * 1e3:.1f} ms "
          f"(median of steps 2-{TRAIN_STEPS}, host clock to the guard "
          f"summary's read), {B * S / steady:.0f} tokens/s; first call "
          f"(discovery, capture, first replay) {step_s[0] * 1e3:.1f} ms, "
          f"peak {first[0] / gib:.2f} GiB allocated / {first[1] / gib:.2f} "
          f"reserved; steady peak {peak[0] / gib:.2f} / "
          f"{peak[1] / gib:.2f} GiB (the eager step 11 included)")
    breakdown(model, opt, ids, labels, cfg.vocab_size, steady,
              tag="guarded train")
    profile_train_step(train_step, (ids, labels), steady,
                       tag="guarded train")
    return launches


def phase_fused_unguarded():
    """AdamW(fused=True) without the guard, at depth 2, against
    AdamW(fused=False) from the same weights on the same batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    runs = {}
    for fused in (False, True):
        cfg, model = _gpt(num_layers=2)
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(), fused=fused)
        step = _train_step(model, opt, cfg.vocab_size, guard=False)
        ids, labels = _batch(cfg.vocab_size, 1)
        reset_launches()
        runs[fused] = [step(ids, labels).item() for _ in range(3)]
        launches = read_launches(f"fused={fused} train")
        if len(step._compiled) != 1:
            raise AssertionError(f"{len(step._compiled)} captures")
        del model, opt, step
    expect = step_launches(cfg, 3 + WARMUP_CALLS, fused=True, guard=False)
    delta = max(abs(a - b) for a, b in zip(runs[True], runs[False]))
    print(f"[fused adamw] depth 2, 3 steps: fused {runs[True]}, unfused "
          f"{runs[False]}, largest |delta| {delta:.3e} (limit 1e-3); "
          f"launches {launches}")
    if launches != expect:
        raise AssertionError(f"fused launches {launches} != {expect}")
    if delta > 1e-3:
        raise AssertionError(f"fused AdamW off the unfused loop by {delta}")
    return launches


def _chaos_run(ckpt_dir, plan):
    """TestChaosAcceptance's loop at GPT-1.3B width and depth 2: one
    seeded batch a step, a checkpoint after step CHAOS_CKPT, rollback
    after CHAOS_SKIPS anomalies in a row. Without a plan the captured
    step runs; with one, ``dygraph_function`` does (a fault hook fires
    in Python, never in a replay)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.resilience import (Checkpointer, FaultInjector,
                                             SentinelAction,
                                             TrainingSentinel, faultinject)
    cfg, model = _gpt(num_layers=2)
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters(),
                             fused=True, guard=True)
    step_fn = _train_step(model, opt, cfg.vocab_size, guard=True)
    ck = Checkpointer(ckpt_dir, keep=2)
    sent = TrainingSentinel(checkpointer=ck, model=model, optimizer=opt,
                            skip_limit=CHAOS_SKIPS, lr_cooldown=1.0)
    inj = faultinject.install(FaultInjector(plan)) if plan else None

    def run(batch):
        if plan is None:
            step_fn(*batch)
            return step_fn.last_guard["loss"]
        with pt.amp.activation_residency("bf16"):
            return step_fn.dygraph_function(*batch).item()

    losses, executed, io_s = {}, 0, 0.0
    try:
        step = 1
        while step <= CHAOS_TOTAL:
            loss = run(_batch(cfg.vocab_size, 1000 + step))
            executed += 1
            act = sent.observe(step, loss=loss, summary=opt.guard_summary())
            if act is SentinelAction.ROLLBACK:
                step = sent.resume_step
                continue
            if act is SentinelAction.OK:
                losses[step] = loss
                if step == CHAOS_CKPT:
                    t0 = time.perf_counter()
                    ck.save_train_state(step, model, opt)
                    io_s += time.perf_counter() - t0
                    sent.note_checkpoint(step)
            step += 1
    finally:
        if inj is not None:
            faultinject.uninstall(inj)
    return cfg, model, opt, step_fn, ck, losses, sent, executed, io_s


def _resume_into_capture(cfg, model, opt, step_fn, ck):
    """Restore the step-CHAOS_CKPT checkpoint into a captured run (in
    place: the graph keeps replaying the same memory) and take the next
    step once by a replay and once eagerly from the same checkpoint:
    loss, weights and accumulators bit for bit."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.resilience import auto_resume
    batch = _batch(cfg.vocab_size, 1000 + CHAOS_CKPT + 1)
    runs = []
    for eager in (False, True):
        if auto_resume(ck, model, opt, step=CHAOS_CKPT)[0] != \
                CHAOS_CKPT + 1:
            raise AssertionError("no step-4 checkpoint to resume from")
        if eager:
            with pt.amp.activation_residency("bf16"):
                loss = step_fn.dygraph_function(*batch).item()
        else:
            step_fn(*batch)
            loss = step_fn.last_guard["loss"]
        runs.append((loss, [p.detach().clone() for p in model.parameters()],
                     [t.clone() for t in opt.state_dict().values()]))
    (replayed, w1, a1), (eager, w2, a2) = runs
    differ = sum(not torch.equal(a, b) for a, b in zip(w1 + a1, w2 + a2))
    print(f"[rollback] step-{CHAOS_CKPT} checkpoint restored into the "
          f"captured run: the replay's loss {replayed}, eager {eager}; "
          f"{differ} of {len(w1 + a1)} weights and accumulators differ")
    if replayed != eager or differ or len(step_fn._compiled) != 1:
        raise AssertionError(f"a replay from the restored checkpoint is "
                             f"not one eager step ({differ} tensors differ, "
                             f"{len(step_fn._compiled)} captures)")


def phase_rollback():
    """The chaos acceptance proof at full width, depth 2: a fault-free
    run (captured) and a run with nan_grad on steps 7 and 8 (eager) end
    with the same losses and weights, bit for bit; then a checkpoint
    restored into the captured run replays as one eager step."""
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    from paddle_tpu_torch.resilience import FaultPlan, FaultSpec
    plan = FaultPlan([FaultSpec("optimizer.grads", "nan_grad",
                                at=CHAOS_FAULT - 1, times=CHAOS_SKIPS)],
                     seed=3, name="chaos-nan_grad")
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        (cfg, clean_model, clean_opt, clean_fn, clean_ck, clean, _, n_clean,
         io_clean) = _chaos_run(str(Path(tmp) / "clean"), None)
        clean_weights = [p.detach().clone()
                         for p in clean_model.parameters()]
        # before the faulted run, whose optimizer registers new state
        # tensors, which would key a new capture
        _resume_into_capture(cfg, clean_model, clean_opt, clean_fn,
                             clean_ck)
        del clean_model, clean_opt, clean_fn
        _, model, _, _, _, faulted, sent, n_fault, io_fault = _chaos_run(
            str(Path(tmp) / "faulted"), plan)
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*.pkl"))
    print(f"[rollback] depth 2, {n_clean} captured + {n_fault} eager steps "
          f"in {time.perf_counter() - t0:.1f} s (checkpoint saves "
          f"{io_clean + io_fault:.1f} s, {ckpt_bytes / 2**30:.2f} GiB on "
          f"disk at the end); anomalies "
          f"{[a.to_dict() for a in sent.anomalies]}, skips "
          f"{sent.skips_total}, rollbacks {sent.rollbacks}, resumed at step "
          f"{sent.resume_step}")
    print(f"[rollback] fault-free losses {clean}")
    print(f"[rollback] resumed losses    {faulted}")
    if faulted != clean:
        raise AssertionError("resumed losses differ from the fault-free run")
    differ = [n for (n, a), b in zip(model.named_parameters(), clean_weights)
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"resumed weights differ: {differ}")
    print(f"[rollback] the resumed (eager) run's {len(faulted)} losses and "
          f"{len(clean_weights)} weights equal the fault-free (captured) "
          f"run's bit for bit")
    launches = read_launches("rollback")
    expect = step_launches(cfg, n_clean + WARMUP_CALLS + n_fault + 2,
                           fused=True, guard=True)
    if launches != expect:
        raise AssertionError(f"rollback launches {launches} != {expect}")
    if not sent.anomalies or sent.anomalies[0].step != CHAOS_FAULT or \
            sent.anomalies[0].kind != "nan_grad":
        raise AssertionError(f"not detected at step {CHAOS_FAULT}: "
                             f"{sent.anomalies}")
    if (sent.skips_total, sent.rollbacks) != (CHAOS_SKIPS, 1):
        raise AssertionError(f"{sent.skips_total} skips, {sent.rollbacks} "
                             f"rollbacks")
    return launches


def phase_lr_schedule():
    """The lr as device state under capture. A 2-layer GPT-1.3B (full
    width, ``AdamW(fused=True, guard=True)``, whose fused kernel, rank-1
    loop and decoupled decay all read the lr tensor) under
    ``LinearWarmup``, stepped between calls: LR_STEPS captured steps
    against the same steps of a copy through ``dygraph_function``, bit
    for bit, with one capture. Then the fault hooks' occurrences over a
    first call, two more, a new batch shape, ``set_lr`` and a call of a
    guarded ``Linear(6, 3)`` step, beside the reference's (which fires
    them at trace time only)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    from paddle_tpu_torch.optimizer import lr
    from paddle_tpu_torch.resilience import FaultInjector, FaultPlan

    def build(host_batch=False):
        cfg, model = _gpt(num_layers=2)
        sched = lr.LinearWarmup(1e-3, warmup_steps=4, start_lr=1e-5,
                                end_lr=1e-3)
        opt = pt.optimizer.AdamW(learning_rate=sched,
                                 parameters=model.named_parameters(),
                                 fused=True, guard=True)
        return cfg, model, sched, _train_step(model, opt, cfg.vocab_size,
                                              guard=True,
                                              host_batch=host_batch)

    # the eager copy first: its optimizer's state registers before the
    # captured step's first call
    cfg, twin, sched, step = build()
    batches = [_batch(cfg.vocab_size, 2000 + i) for i in range(LR_STEPS)]
    eager, lrs = [], []
    for batch in batches:
        lrs.append(sched())
        with pt.amp.activation_residency("bf16"):
            eager.append(step.dygraph_function(*batch).item())
        sched.step()
    eager_weights = [p.detach() for p in twin.parameters()]
    del twin, sched, step
    cfg, model, sched, step = build()
    reset_launches()
    losses = []
    for batch in batches:
        step(*batch)
        losses.append(step.last_guard["loss"])
        sched.step()
    launches = read_launches("lr schedule")
    differ = sum(not torch.equal(a, b)
                 for a, b in zip(model.parameters(), eager_weights))
    print(f"[lr schedule] depth 2, LinearWarmup lrs {lrs}: captured losses "
          f"{losses}, eager {eager}; {differ} of {len(eager_weights)} "
          f"weights differ; {len(step._compiled)} capture(s)")
    expect = step_launches(cfg, LR_STEPS + WARMUP_CALLS, fused=True,
                           guard=True)
    if launches != expect:
        raise AssertionError(f"lr schedule launches {launches} != {expect}")
    if losses != eager or differ or len(step._compiled) != 1:
        raise AssertionError("the captured step did not follow the "
                             "schedule as the eager one did")
    del model, step
    gc.collect()
    check_host_batches(build, batches, eager, eager_weights)
    del eager_weights
    gc.collect()
    check_linear_replays()

    lin = pt.nn.Linear(6, 3, device="cuda")
    opt = pt.optimizer.AdamW(learning_rate=0.05,
                             parameters=lin.named_parameters(), guard=True)

    @pt.jit.to_static(guard=True)
    def linear_step(X, y):
        opt.clear_grad()
        loss = ((lin(X) - y) ** 2).mean()
        loss.backward()
        opt.step()
        return loss

    gen = torch.Generator("cuda").manual_seed(5)
    counts, entries = [], []
    with FaultInjector(FaultPlan([])) as inj:
        for i, n in enumerate((8, 8, 8, 5, 5)):
            if i == 4:
                opt.set_lr(0.01)
            linear_step(torch.randn(n, 6, device="cuda", generator=gen),
                        torch.randn(n, 3, device="cuda", generator=gen))
            counts.append(inj.occurrences("optimizer.step"))
            entries.append(len(linear_step._compiled))
    print(f"[lr schedule] optimizer.step hook over first call, 2 more, a "
          f"new batch shape, set_lr + a call: {counts} with {entries} "
          f"captures (the reference on the CPU: [2, 2, 2, 3, 3] with "
          f"[1, 1, 1, 2, 2]: it fires at its traces, twice for a first "
          f"call that registers state; here the first warm-up and the "
          f"capture fire, the first warm-up's firings taken back when it "
          f"registered nothing, a replay fires none)")
    want = [2, 2, 2, 3, 3]
    if counts != want or entries != [1, 1, 1, 2, 2]:
        raise AssertionError(f"hook counts {counts} != {want} or captures "
                             f"{entries}")

    # random numbers: a generator the graph was not given refuses the
    # capture; the default one is registered, and each replay draws anew
    X = torch.ones(8, 6, device="cuda")

    @pt.jit.to_static
    def own_generator(X):
        opt.clear_grad()
        loss = (lin(X) + torch.rand(8, 3, device="cuda", generator=gen)).sum()
        loss.backward()
        opt.step()
        return loss

    @pt.jit.to_static
    def dropout_step(X):
        opt.clear_grad()
        y = torch.nn.functional.dropout(lin(X), 0.5)
        y.sum().backward()
        opt.step()
        return y.detach() != 0

    try:
        own_generator(X)
    except RuntimeError as e:
        if "capturing own_generator failed" not in str(e):
            raise
    else:
        raise AssertionError("a step drawing from its own generator captured")
    masks = [dropout_step(X) for _ in range(3)]
    fresh = [bool((a != b).any()) for a, b in zip(masks, masks[1:])]
    print(f"[lr schedule] a step drawing from its own torch.Generator fails "
          f"its capture; dropout on the default generator: "
          f"{len(dropout_step._compiled)} capture, masks of 3 calls differ "
          f"{fresh}")
    if len(dropout_step._compiled) != 1 or not all(fresh):
        raise AssertionError("replays do not draw fresh dropout masks")
    return launches


def check_host_batches(build, batches, eager, eager_weights):
    """The step of :func:`phase_lr_schedule` given its batches on the
    CPU (it moves them to the card itself): ``to_static`` places it by
    the state it changes, on the card, captures it and stages each
    batch into the graph's buffers. One capture; losses and weights
    equal the eager steps'; launches exact (the placing call, the
    warm-ups and the steps)."""
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    cfg, model, sched, step = build(host_batch=True)
    host = [(ids.cpu(), labels.cpu()) for ids, labels in batches]
    reset_launches()
    losses = []
    for batch in host:
        step(*batch)
        losses.append(step.last_guard["loss"])
        sched.step()
    launches = read_launches("lr schedule, CPU batches")
    differ = sum(not torch.equal(a, b)
                 for a, b in zip(model.parameters(), eager_weights))
    graphs = [e.graph is not None for e in step._compiled.values()]
    print(f"[lr schedule] batches on the CPU: captured losses {losses}; "
          f"{differ} weights differ from the eager steps'; captures with "
          f"a graph {graphs}")
    expect = step_launches(cfg, len(host) + WARMUP_CALLS + 1, fused=True,
                           guard=True)
    if launches != expect:
        raise AssertionError(f"CPU-batch launches {launches} != {expect}")
    if losses != eager or differ or graphs != [True]:
        raise AssertionError("a step given CPU batches was not captured "
                             "on the card as the eager steps ran")


def check_linear_replays():
    """The replay's host side on a captured ``Linear(6, 3)`` step, each
    against the same 3 calls of an eager twin from the same weights
    (run first, so its state registers before the capture): a step that
    runs backward without clearing adds each call's gradient to
    ``.grad`` (the reference's ``_apply``); steps that clear by
    ``zero_grad()`` or ``zero_grad(set_to_none=False)`` leave one call's
    gradient and the weights of eager steps, bit for bit; each returned
    loss is as it came back after the later calls."""
    import paddle_tpu_torch as pt
    gen = torch.Generator("cuda").manual_seed(11)
    xs = [(torch.randn(8, 6, device="cuda", generator=gen),
           torch.randn(8, 3, device="cuda", generator=gen))
          for _ in range(3)]
    for clear in ("none", "zero_grad", "zero_grad_in_place"):
        runs = []
        for captured in (False, True):
            lin = pt.nn.Linear(6, 3, device="cuda")
            if runs:
                with torch.no_grad():
                    for p, q in zip(lin.parameters(), first):
                        p.copy_(q)
            else:
                first = [p.detach().clone() for p in lin.parameters()]
            opt = pt.optimizer.AdamW(learning_rate=0.05,
                                     parameters=lin.named_parameters())

            def step(X, y, lin=lin, opt=opt):
                if clear == "zero_grad":
                    lin.zero_grad()
                elif clear == "zero_grad_in_place":
                    lin.zero_grad(set_to_none=False)
                loss = ((lin(X) - y) ** 2).mean()
                loss.backward()
                if clear != "none":
                    opt.step()
                return loss

            fn = pt.jit.to_static(step) if captured else step
            losses = [(loss, loss.clone()) for loss in
                      (fn(X, y) for X, y in xs)]
            kept = all(torch.equal(a, b) for a, b in losses)
            runs.append(([p.detach().clone() for p in lin.parameters()],
                         [p.grad.clone() for p in lin.parameters()],
                         [b for _, b in losses], kept))
            if captured:
                (entry,) = fn._compiled.values()
                cleared = len(entry.cleared)
        (w0, g0, l0, _), (w1, g1, l1, kept) = runs
        same = all(map(torch.equal, w0 + g0 + l0, w1 + g1 + l1))
        print(f"[linear replays] {clear}: captured weights, grads and "
              f"losses equal eager's {same}; returned losses kept {kept}; "
              f"{cleared} of 2 gradients seen cleared")
        if not (same and kept and cleared == (0 if clear == "none" else 2)):
            raise AssertionError(f"captured {clear} step differs from "
                                 f"its eager twin")


# ------------------------------------------- RMSNorm, block-sparse attention
def _token_window_mask(nq, nk, block_q, block_k, window):
    """[nq, nk] causal window at block level when block_q != block_k:
    q-block i holds the k-blocks that meet its tokens or the `window`
    tokens before them, none past its last token."""
    qi, kj = np.arange(nq)[:, None], np.arange(nk)[None, :]
    return ((kj * block_k < (qi + 1) * block_q)
            & ((kj + 1) * block_k > qi * block_q - window))


def _bsa_case(name, gen):
    """q, k, v, the block mask and its block_q, block_k of check shape
    `name`: (a) the sparse block path's, (b) long context, (c)
    BigBird-base's head, (d) f32 with a ragged sequence, (e) a non-causal
    mask with an empty q-row, (f) bf16 ragged at blocks of 128 (a box past
    seq_k in the last k-block), (g) block_q 256 over block_k 64 (stages
    pair two k-blocks of one long mask row)."""
    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    bf16, f32 = torch.bfloat16, torch.float32
    shape, dtype, bq, bk, bm = {
        "a": ((SB_B, H, SB_S, D), bf16, SB_BLOCK, SB_BLOCK,
              bsa.make_global_plus_window_mask(64, 64, 3, 2)),
        "b": ((1, 16, 16384, 128), bf16, 512, 512,
              bsa.make_global_plus_window_mask(32, 32, 2, 1)),
        "c": ((2, 12, 4096, 64), bf16, 64, 64,
              bsa.make_global_plus_window_mask(64, 64, 3, 2)),
        "d": ((1, 4, 4000, 128), f32, 64, 64,
              bsa.make_global_plus_window_mask(63, 63, 3, 2)),
        "e": ((1, 4, 1024, 128), bf16, 64, 64,
              bsa.make_sliding_window_mask(16, 16, 2, causal=False)),
        "f": ((1, 4, 4000, 128), bf16, 128, 128,
              bsa.make_global_plus_window_mask(32, 32, 3, 2)),
        "g": ((2, 8, 2048, 128), bf16, 256, 64,
              _token_window_mask(8, 32, 256, 64, 512)),
    }[name]
    if name == "e":
        bm[5, :] = False
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    return q, k, v, bm, bq, bk


def _bsa_terms(q, k, v, lse, tables, scale):
    """Each output element's sum over its active keys of p * |v| (p from
    the plain version's lse), ``[b, h, sq, d]`` f32: the products whose
    bf16 factor p the kernel (against a running maximum every 64 keys)
    and the plain version (every mask block) round at other points."""
    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    b, h, sq, d = q.shape
    sk = k.shape[2]
    t = tables.on(q.device)
    kt, cnt = t["kt"].long(), t["cnt"].long()
    bq, bk = tables.block_q, tables.block_k
    nq, nk = kt.shape[0], -(-sk // bk)
    qb, kb = bsa._blocks(q, bq, nq), bsa._blocks(k, bk, nk)
    vb = bsa._blocks(v, bk, nk).abs()
    ok = bsa._key_ok(sk, bk, nk, q.device)
    lse2 = bsa._rows(lse, bq, nq)[..., None] * bsa._LOG2E
    terms = torch.zeros_like(qb)
    for j in range(kt.shape[1]):
        kj = kt[:, j]
        s = torch.matmul(qb, kb[:, kj].transpose(-1, -2)) * (scale
                                                             * bsa._LOG2E)
        p = torch.exp2(s - lse2).masked_fill(~ok[kj][None, :, None, :], 0.0)
        terms += torch.where((j < cnt)[None, :, None, None],
                             torch.matmul(p, vb[:, kj]), 0.0)
    return terms.reshape(b, h, -1, d)[:, :, :sq]


BSA_CASES = "abcdefg"


def check_bsa(gen):
    """bsa_fwd against its plain version at shapes (a)-(g): o per element
    as the flash forward (``check_terms``), lse within 1e-5; rows with no
    active block o = 0 and lse finite and equal to the plain version's;
    a second launch on the same inputs gives the same bits."""
    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    err = 0.0
    for name in BSA_CASES:
        q, k, v, bm, bq, bk = _bsa_case(name, gen)
        tables = bsa.prepare_block_mask(bm, bq, bk)
        t = tables.on(q.device)
        scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = bsa.bsa_fwd(q, k, v, tables)
        o2, lse2 = bsa.bsa_fwd(q, k, v, tables)
        o_ref, lse_ref = bsa._bsa_fwd_ref(q, k, v, t["kt"], t["cnt"], scale,
                                          bq, bk)
        torch.cuda.synchronize()
        sq = q.shape[2]
        rows = torch.from_numpy(np.repeat(bm.any(1), bq)[:sq]).cuda()
        tag = f"({name}) {list(q.shape)} blocks {bq}/{bk} " \
              f"{str(q.dtype).split('.')[1]}"
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"bsa_fwd {tag}: a second launch on the "
                                 f"same inputs gave other bits")
        terms = _bsa_terms(q, k, v, lse_ref, tables, scale)
        err = max(err, check_terms(f"bsa_fwd o {tag}", o[:, :, rows],
                                   o_ref[:, :, rows], terms[:, :, rows]),
                  check_sum(f"bsa_fwd lse {tag}", lse[:, rows],
                            lse_ref[:, rows]))
        if not bool(rows.all()):
            empty = ~rows
            if not bool((o[:, :, empty] == 0).all()) or not bool(
                    torch.isfinite(lse[:, empty]).all()) or not torch.equal(
                    lse[:, empty], lse_ref[:, empty]):
                raise AssertionError(f"bsa_fwd {tag}: a row with no active "
                                     f"block is not o = 0 with the plain "
                                     f"version's finite lse")
            print(f"[sparse kernels] bsa_fwd {tag}: {int(empty.sum())} rows "
                  f"with no active block: o = 0, lse "
                  f"{lse[0, empty][0].item():.6e}")
        del q, k, v, o, lse, o2, lse2, o_ref, lse_ref, terms
    return err


def time_bsa_case(name, gen):
    """bsa_fwd at check shape `name`: kernel, plain version, bound and
    SDPA with the block mask expanded to an additive bias, by CUDA
    events over two input sets."""
    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from paddle_tpu_torch.ops.cuda import cost
    few = dict(reps=10, per_rep=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sets = [_bsa_case(name, gen) for _ in range(2)]
    _q, _k, _v, bm, bq, bk = sets[0]
    tables = bsa.prepare_block_mask(bm, bq, bk)
    tb = tables.on("cuda")
    b, h, sq, d = sets[0][0].shape
    scale = 1.0 / math.sqrt(d)
    # the token-level mask as SDPA's additive bias, made once (every row
    # of (a), (b) and (c) has an active block)
    tok = torch.from_numpy(np.kron(bm, np.ones((bq, bk), bool))[
        :sq, :sq]).cuda()
    bias = torch.zeros(tok.shape, dtype=torch.bfloat16,
                       device="cuda").masked_fill(~tok, float("-inf"))
    bound, by = _bound(cost.bsa_fwd(*sets[0][:3], tables))
    return {
        "ms": device_ms(bsa.bsa_fwd, [(q, k, v, tables)
                                      for q, k, v, *_ in sets], **few),
        "plain_ms": device_ms(bsa._bsa_fwd_ref, [
            (q, k, v, tb["kt"], tb["cnt"], scale, bq, bk)
            for q, k, v, *_ in sets], **few),
        "bound_ms": bound, "bound_by": by,
        "library_ms": device_ms(
            lambda q, k, v: sdpa(q, k, v, attn_mask=bias),
            [(q, k, v) for q, k, v, *_ in sets], **few),
        "shape": [b, h, sq, d], "block": bq,
        "active_blocks": int(bm.sum()), "dtype": "bfloat16"}


def time_sparse_kernels(gen):
    """rms_fwd at the path's rows (8192 x 2048) and a decode row block
    (8), bf16 x and an f32 weight; bsa_fwd at (a), (b) and (c). Kernel,
    plain version, bound and library call, by CUDA events."""
    from paddle_tpu_torch.ops.cuda import cost, norm
    t = {}
    for rows in (8192, 8):
        copies = max(1, min(64, math.ceil(150e6 / (2 * rows * HIDDEN * 2))))
        w = (1.0 + 0.1 * torch.randn(HIDDEN, device="cuda", generator=gen))
        xs = [torch.randn(rows, HIDDEN, device="cuda", generator=gen).to(
            torch.bfloat16) for _ in range(copies)]
        args = [(x, w, RMS_EPS) for x in xs]
        # F.rms_norm's fused path takes one dtype: bf16 weights
        lib = [(x, (HIDDEN,), w.to(torch.bfloat16), RMS_EPS) for x in xs]
        bound, by = _bound(cost.rms_fwd(*args[0]))
        t[("rms_fwd", rows)] = {
            "ms": device_ms(norm.rms_fwd, args),
            "plain_ms": device_ms(norm._rms_fwd_ref, args),
            "bound_ms": bound, "bound_by": by,
            "library_ms": device_ms(torch.nn.functional.rms_norm, lib),
            "rows": rows, "hidden": HIDDEN, "dtype": "bfloat16",
            "weight_dtype": "float32"}
    for name in "abc":
        t[("bsa_fwd", name)] = time_bsa_case(name, gen)
    for key, v in t.items():
        print(f"[sparse kernels] {key[0]} {key[1]}: " + ", ".join(
            f"{k} {x:.5f}" if isinstance(x, float) else f"{k} {x}"
            for k, x in v.items()))
    return t


def phase_sparse_kernels():
    """Kernels #5 (rms_fwd) and #10 (bsa_fwd) against their plain
    versions, then their times."""
    from paddle_tpu_torch.ops.cuda import norm
    gen = torch.Generator(device="cuda").manual_seed(3)
    err = {"rms_fwd": 0.0}
    cases = 0
    for hidden in RMS_HIDDEN:
        for rows in RMS_ROWS:
            x32 = torch.randn(rows, hidden, device="cuda", generator=gen)
            w32 = 1.0 + 0.1 * torch.randn(hidden, device="cuda",
                                          generator=gen)
            for xdt in (torch.float32, torch.bfloat16):
                for w in (w32, w32.to(torch.bfloat16), None):
                    x = x32.to(xdt)
                    got = norm.rms_fwd(x, w, RMS_EPS)
                    torch.cuda.synchronize()
                    wname = "none" if w is None else str(w.dtype)[6:]
                    err["rms_fwd"] = max(err["rms_fwd"], check_close(
                        f"rms_fwd rows={rows} hidden={hidden} w={wname} "
                        f"{str(xdt).split('.')[1]}", got,
                        norm._rms_fwd_ref(x, w, RMS_EPS)))
                    cases += 1
    err["bsa_fwd"] = check_bsa(gen)
    print(f"[sparse kernels] agree with their plain versions (rms_fwd "
          f"{cases} cases, bsa_fwd {len(BSA_CASES)} shapes); max abs err "
          f"{err}")
    print(f"[sparse kernels] largest error as a share of its limit: "
          f"{shares(*err)}")
    return err, time_sparse_kernels(gen)


class SparseBlock(torch.nn.Module):
    """The sparse block path's user code: ``x -> RMSNorm -> qkv ->
    sparse_attention -> out -> + x`` at GPT-1.3B's widths."""

    def __init__(self, gen):
        from paddle_tpu_torch import nn
        super().__init__()
        self.norm = nn.RMSNorm(HIDDEN, device="cuda")
        self.qkv = nn.Linear(HIDDEN, 3 * HIDDEN, device="cuda", generator=gen)
        self.out = nn.Linear(HIDDEN, HIDDEN, device="cuda", generator=gen)

    def forward(self, x, offs, cols):
        from paddle_tpu_torch.nn import functional as F
        b, s, _ = x.shape
        qkv = self.qkv(self.norm(x)).reshape(b, s, 3, H, D)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.sparse_attention(q, k, v, offs, cols)
        return self.out(o.transpose(1, 2).reshape(b, s, HIDDEN)) + x


def phase_sparse_block():
    """The sparse block path: 5 captured train steps through the port's
    public layers, with exact launch counts; the CSR lives outside the
    step's arguments, so the captured step finds it in the pattern's
    identity memo. A step that takes the CSR as an argument must fail
    its capture: a replay would reuse the first call's pattern."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    from paddle_tpu_torch.nn.functional import transformer
    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    gen = torch.Generator("cuda").manual_seed(4)
    model = SparseBlock(gen)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters(), fused=True)
    bm = bsa.make_global_plus_window_mask(SB_S // SB_BLOCK, SB_S // SB_BLOCK,
                                          3, 2)
    tok = np.kron(bm, np.ones((SB_BLOCK, SB_BLOCK), bool))
    offs = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(tok.sum(1))]).astype(np.int32)).cuda()
    cols = torch.from_numpy(np.nonzero(tok)[1].astype(np.int32)).cuda()
    offs = offs.expand(SB_B, H, -1).contiguous()
    cols = cols.expand(SB_B, H, -1).contiguous()
    del tok
    x = torch.randn(SB_B, SB_S, HIDDEN, device="cuda", generator=gen)
    target = torch.randn(SB_B, SB_S, HIDDEN, device="cuda", generator=gen)

    @pt.jit.to_static(amp_policy="bf16")
    def train_step(x, target):
        opt.clear_grad()
        y = model(x, offs, cols)
        loss = ((y.float() - target) ** 2).mean()
        loss.backward()
        opt.step()
        return loss

    transformer._block_mask_cache.clear()
    transformer._pattern_identity_memo.clear()
    stats = transformer.PATTERN_STATS
    for k in stats:
        stats[k] = type(stats[k])(0)
    torch.cuda.synchronize()
    print(f"[sparse block] RMSNorm({HIDDEN}) -> Linear({HIDDEN}, "
          f"{3 * HIDDEN}) -> sparse_attention ({H} heads of {D}; CSR of "
          f"global+window blocks of {SB_BLOCK}: {int(bm.sum())} of "
          f"{bm.size} active, {cols.shape[-1]} entries a head) -> "
          f"Linear({HIDDEN}, {HIDDEN}) -> + x; batch {SB_B} x {SB_S}, "
          f"to_static(amp_policy='bf16'), AdamW(1e-3, fused=True)")
    reset_launches()
    losses, step_s, first = captured_run(train_step,
                                         [(x, target)] * SB_STEPS)
    first_analysis = stats["analysis_s"]
    launches = read_launches("sparse block")
    steps = SB_STEPS + WARMUP_CALLS          # the first call's warm-ups
    expect = {k: 0 for k in launches}
    expect.update(rms_fwd=steps, bsa_fwd=steps, adam_update=2 * steps)
    print(f"[sparse block] losses {losses}")
    print(f"[sparse block] launches {launches}; pattern cache "
          f"{[(h[1], int(h[0].sum())) if h else None for h in transformer._block_mask_cache.values()]}, "
          f"stats {stats}")
    if launches != expect:
        raise AssertionError(f"sparse block launches {launches} != {expect}")
    hits = list(transformer._block_mask_cache.values())
    if len(hits) != 1 or hits[0] is None or hits[0][1] != SB_BLOCK or \
            not np.array_equal(hits[0][0], bm):
        raise AssertionError(f"the CSR was not recognised as the block "
                             f"pattern at {SB_BLOCK}")
    # the first warm-up analyses; the second and the capture hit the
    # memo; replays run no Python
    if stats["analyses"] != 1 or stats["memo_hits"] != WARMUP_CALLS or \
            len(train_step._compiled) != 1:
        raise AssertionError(f"the pattern was not analysed once and then "
                             f"memoised: {stats}, "
                             f"{len(train_step._compiled)} captures")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad:
        raise AssertionError(f"parameters without a finite gradient: {bad}")
    steady = statistics.median(step_s[1:])
    print(f"[sparse block] {card_line()}: step {steady * 1e3:.2f} ms "
          f"(median of steps 2-{SB_STEPS}), {SB_B * SB_S / steady:.0f} "
          f"tokens/s; {first}; the host-side pattern analysis "
          f"{first_analysis:.3f} s of the first call; every parameter has "
          f"a finite gradient")
    profile_train_step(train_step, (x, target), steady, tag="sparse block")

    @pt.jit.to_static(amp_policy="bf16")
    def csr_step(x, target, offs, cols):
        opt.clear_grad()
        loss = ((model(x, offs, cols).float() - target) ** 2).mean()
        loss.backward()
        opt.step()
        return loss

    try:
        csr_step(x, target, offs, cols)
    except RuntimeError as e:
        if "capturing csr_step failed" not in str(e):
            raise
        print(f"[sparse block] a step taking the CSR as an argument fails "
              f"its capture: {str(e)[:160]}")
    else:
        raise AssertionError("a step with the CSR as an argument captured")
    torch.cuda.synchronize()
    return launches


# ------------------------------------------ the keep-mask kernel (dropout)
def _keep_cases():
    """(shape, dtype) the dropout drive hands the keep-mask kernel (the
    attention probabilities, bf16; the residual dropouts, bf16; the
    embeddings', f32), ragged sizes past a vector's and a block's edge,
    every output type, and a split alone."""
    return [((B, H, S, S), torch.bfloat16), ((B, S, HIDDEN), torch.bfloat16),
            ((B, S, HIDDEN), torch.float32), ((1000, 1001), torch.bool),
            ((3, 7, 11), torch.float16), ((5,), torch.float32), ((0,),
                                                                  torch.bool)]


def phase_keep_mask():
    """The keep-mask kernel against its plain version (the torch
    threefry) at each case of :func:`_keep_cases`: the mask, the subkey
    and the advanced key bit for bit, from two keys; then its time at
    the attention mask's shape beside its bound and the plain version's.
    No PyTorch call draws threefry bits: no library time."""
    from paddle_tpu_torch.ops.cuda import cost, random
    gen = torch.Generator().manual_seed(11)
    for shape, dtype in _keep_cases():
        for _ in range(2):
            words = torch.randint(0, 2 ** 32, (2,), generator=gen,
                                  dtype=torch.int64)
            key, ref_key = words.cuda(), words.clone().cuda()
            got, sub = random.keep_mask(key, 1.0 - DROPOUT, shape, dtype)
            want, ref_sub = random._keep_mask_ref(ref_key, 1.0 - DROPOUT,
                                                  shape, dtype)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(sub, ref_sub)
                    and torch.equal(key, ref_key)):
                raise AssertionError(
                    f"keep_mask {shape} {dtype}: "
                    f"{int((got != want).sum())} elements differ, sub "
                    f"{sub.tolist()} / {ref_sub.tolist()}, key "
                    f"{key.tolist()} / {ref_key.tolist()}")
        kept = got.float().mean().item() if got.numel() else float("nan")
        print(f"[keep_mask] {shape} {str(dtype).split('.')[1]}: bit-identical "
              f"to the plain version (mask, subkey, new key), kept share "
              f"{kept:.4f}")
    shape, dtype = _keep_cases()[0]
    keys = [(torch.randint(0, 2 ** 32, (2,), generator=gen,
                           dtype=torch.int64).cuda(),) for _ in range(4)]
    ms = device_ms(lambda k: random.keep_mask(k, 1.0 - DROPOUT, shape,
                                              dtype), keys)
    plain_ms = device_ms(lambda k: random._keep_mask_ref(
        k, 1.0 - DROPOUT, shape, dtype), keys, reps=3, per_rep=1)
    (c,) = cost.keep_mask(keys[0][0], 1.0 - DROPOUT, shape, dtype)
    bound = _bound([c])
    print(f"[keep_mask] {card_line()}: {list(shape)} bf16 {ms:.5f} ms, "
          f"bound {bound[0]:.5f} ms ({bound[1]}: {c.flops} int32 ops over "
          f"{cost.PEAKS['int32'] / 1e12:.2f} T/s; the bytes "
          f"{c.bytes / cost.HBM_BYTES_PER_S * 1e3:.5f} ms), plain "
          f"{plain_ms:.3f} ms, library: none")
    return {"keep_mask": 0.0}, {"keep_mask": {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": None, "shape": list(shape),
        "dtype": "bfloat16"}}


# --------------------------------- GPT-1.3B at its own defaults (dropout)
def _dropout_build(remat=None, dropout=DROPOUT, num_layers=None):
    """GPT-1.3B at ``dropout`` (attention and residual), f32 masters
    from seed 0, with the flagship's optimizer (AdamW(1e-4,
    weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(1.0), fused=True))
    and criterion (GPTPretrainingCriterion with a loss_mask), the step
    under ``to_static(amp_policy="bf16", remat=remat)``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt3_1p3b)
    kw = {} if num_layers is None else {"num_layers": num_layers}
    cfg = gpt3_1p3b(fused_ln=True, dropout=dropout,
                    attention_dropout=dropout, **kw)
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    model.train()
    opt = pt.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters(), weight_decay=0.01,
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0), fused=True)
    crit = GPTPretrainingCriterion()

    @pt.jit.to_static(amp_policy="bf16", remat=remat)
    def train_step(ids, labels, mask):
        opt.clear_grad()
        loss = crit(model(ids), labels, mask)
        loss.backward()
        opt.step()
        return loss

    return cfg, model, train_step


def _masked_batch(vocab):
    ids, labels = _batch(vocab, 7)
    mask = torch.ones(B, S, device="cuda")
    mask[:, -MASK_TAIL:] = 0
    return ids, labels, mask


def _dropout_run(tag, remat=None, dropout=DROPOUT):
    """One captured run of ``TRAIN_STEPS`` steps from ``SEED``: (losses,
    keys after each step, the first call's line, steady step seconds,
    launches, the model)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    cfg, model, step = _dropout_build(remat, dropout)
    batch = _masked_batch(cfg.vocab_size)
    pt.seed(SEED)
    torch.cuda.synchronize()
    reset_launches()
    keys = []

    def run():
        for _ in range(TRAIN_STEPS):
            yield batch
            keys.append(pt.get_rng_state())

    losses, step_s, first = captured_run(step, run())
    launches = read_launches(tag)
    expect = step_launches(cfg, TRAIN_STEPS + WARMUP_CALLS, fused=True,
                           guard=False, remat=bool(remat))
    if launches != expect or len(step._compiled) != 1:
        raise AssertionError(f"{tag}: launches {launches} != {expect}, "
                             f"{len(step._compiled)} captures")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] <= losses[0] - LOSS_DROP:
        raise AssertionError(f"{tag}: losses {losses}")
    steady = statistics.median(step_s[1:])
    print(f"[{tag}] losses {losses}")
    print(f"[{tag}] {card_line()}: step {steady * 1e3:.1f} ms (median of "
          f"steps 2-{TRAIN_STEPS}), {B * S / steady:.0f} tokens/s; {first}; "
          f"keep_mask {launches['keep_mask']}, flash_fwd "
          f"{launches['flash_fwd']} launches over {TRAIN_STEPS} steps and "
          f"{WARMUP_CALLS} warm-ups")
    return losses, [k.tolist() for k in keys], first, steady, launches, \
        model, step


def phase_train_dropout():
    """GPT-1.3B at its own defaults, dropout 0.1 and attention dropout
    0.1, with clipping, decay and the masked criterion: ``TRAIN_STEPS``
    steps of 4 x 1024 tokens through ``dygraph_function`` (eager), then
    the same through the ``to_static`` capture from the same key: losses,
    the key after every step and the final weights bit-identical; the key
    advances every step and two steps' masks differ; every forward
    launches the keep-mask kernel 1 + 3 x 24 times. Then the same step
    under ``remat=True`` (losses within 1e-6), ``remat="bf16"`` (within
    0.05), at dropout 0, and under ``remat=True`` at dropout 0 (flash on
    the path), each with its first call's peak and its steady reserved
    memory."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import random
    t0 = time.perf_counter()
    cfg, twin, twin_step = _dropout_build()
    batch = _masked_batch(cfg.vocab_size)
    pt.seed(SEED)
    reset_launches()
    eager, eager_keys = [], []
    for _ in range(TRAIN_STEPS):
        with pt.amp.activation_residency("bf16"):
            eager.append(twin_step.dygraph_function(*batch).item())
        eager_keys.append(pt.get_rng_state().tolist())
    launches = read_launches("dropout train, dygraph_function")
    if launches != step_launches(cfg, TRAIN_STEPS, fused=True, guard=False):
        raise AssertionError(f"dygraph launches {launches}")
    eager_weights = [p.detach().cpu() for p in twin.parameters()]
    del twin, twin_step
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dropout train] gpt3_1p3b(fused_ln=True) at dropout "
          f"{cfg.dropout} / attention {cfg.attention_dropout}, "
          f"AdamW(1e-4, weight_decay=0.01, grad_clip=ClipGradByGlobalNorm"
          f"(1.0), fused=True), GPTPretrainingCriterion with the last "
          f"{MASK_TAIL} tokens of each row masked, batch {B} x {S}; the "
          f"eager run: {eager}")

    losses, keys, first, steady, launches, model, step = _dropout_run(
        "dropout train")
    differ = [n for (n, a), b in zip(model.named_parameters(), eager_weights)
              if not torch.equal(a.cpu(), b)]
    if losses != eager or keys != eager_keys or differ:
        raise AssertionError(f"captured and eager runs differ: losses "
                             f"{losses} / {eager}, keys {keys} / "
                             f"{eager_keys}, weights {differ}")
    if len({tuple(k) for k in keys}) != TRAIN_STEPS:
        raise AssertionError(f"the key did not advance every step: {keys}")
    masks = [random.keep_mask(torch.tensor(k, device="cuda"), 1 - DROPOUT,
                              (B, H, S, S), torch.bool)[0] for k in keys[:2]]
    same = float((masks[0] == masks[1]).float().mean())
    if bool(torch.equal(*masks)):
        raise AssertionError("two steps' keys draw the same mask")
    print(f"[dropout train] the captured run's {TRAIN_STEPS} losses, keys "
          f"and {len(eager_weights)} final weights equal the eager run's bit "
          f"for bit; the key advanced every step ({keys[0]} .. {keys[-1]}); "
          f"masks of steps 1 and 2 agree on {same:.4f} of their elements")
    del eager_weights, masks
    profile_train_step(step, batch, steady, tag="dropout train")
    del model, step
    gc.collect()
    torch.cuda.empty_cache()

    runs = {"plain": (losses, first, steady)}
    for tag, remat, dropout in (("remat", True, DROPOUT),
                                ("remat bf16", "bf16", DROPOUT),
                                ("dropout 0", None, 0.0),
                                ("remat, dropout 0", True, 0.0)):
        got, got_keys, got_first, got_steady, got_launches, model, step = \
            _dropout_run(f"dropout train, {tag}", remat, dropout)
        runs[tag] = (got, got_first, got_steady)
        if dropout:
            tol = REMAT_TOL[remat]
            worst = max(abs(a - b) for a, b in zip(got, losses))
            print(f"[dropout train, {tag}] losses within {worst:.3g} of the "
                  f"run without remat (limit {tol}); keys equal: "
                  f"{got_keys == keys}")
            if worst > tol or got_keys != keys:
                raise AssertionError(f"{tag}: losses {got} against {losses}")
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[dropout train] {card_line()}: " + "; ".join(
        f"{tag}: step {v[2] * 1e3:.1f} ms, {v[1]}" for tag, v in runs.items()))
    print(f"[dropout train] {time.perf_counter() - t0:.1f} s in all")
    return launches


def phase_head_and_scaler():
    """At depth 2 of GPT-1.3B's widths, f32, dropout 0: the untied head
    with ``loss_with_fused_head`` (chunks of ``HEAD_CHUNK`` tokens)
    against the same weights' logits + ``cross_entropy``, loss within
    1e-5 relative and every gradient within 1e-4 of its tensor's largest
    magnitude (f32 sums over 50304 classes and 4096 tokens in another
    order), with each one's peak memory; then one eager ``GradScaler``
    step (scale 2^15) against an unscaled step from the same weights."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn import functional as F
    cfg = gpt3_1p3b(fused_ln=True, num_layers=2, dropout=0.0,
                    attention_dropout=0.0, tie_word_embeddings=False)
    fused = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    plain = copy.deepcopy(fused)
    ids, labels = _batch(cfg.vocab_size, 9)
    peaks, losses = {}, {}
    for tag, model in (("fused head", fused), ("logits + cross_entropy",
                                                plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if model is fused:
            loss = model.loss_with_fused_head(ids, labels,
                                              chunk_size=HEAD_CHUNK)
        else:
            loss = F.cross_entropy(model(ids).reshape([-1, cfg.vocab_size]),
                                   labels.reshape([-1]))
        loss.backward()
        torch.cuda.synchronize()
        peaks[tag] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        losses[tag] = loss.item()
    a, b = losses.values()
    if not abs(a - b) <= 1e-5 * abs(b):
        raise AssertionError(f"fused head loss {a} against {b}")
    worst = 0.0
    for (name, p), q in zip(fused.named_parameters(), plain.parameters()):
        top = q.grad.abs().max().item()
        err = (p.grad - q.grad).abs().max().item()
        worst = max(worst, err / max(top, 1e-30))
        if err > 1e-4 * top:
            raise AssertionError(f"fused head gradient {name}: {err} of "
                                 f"{top}")
    print(f"[head] untied head, depth 2, f32: loss_with_fused_head {a:.6f} "
          f"against logits + cross_entropy {b:.6f}; gradients within "
          f"{worst:.3g} of each tensor's largest magnitude (limit 1e-4); "
          f"peak above the weights: " + ", ".join(
              f"{k} {v:.2f} GiB" for k, v in peaks.items()))
    del fused
    for p in plain.parameters():
        p.grad = None
    twin = copy.deepcopy(plain)
    stepped = []
    for model, scaler in ((plain, pt.amp.GradScaler()), (twin, None)):
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
        loss = F.cross_entropy(model(ids).reshape([-1, cfg.vocab_size]),
                               labels.reshape([-1]))
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            found = scaler._found_inf
            scale = scaler.get_init_loss_scaling()
        stepped.append([p.detach() for p in model.parameters()])
    worst = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(*stepped))
    same = sum(torch.equal(a, b) for a, b in zip(*stepped))
    print(f"[scaler] one eager GradScaler step (scale 2^15): found_inf "
          f"{found}, scale after {scale}; {same} of {len(stepped[0])} "
          f"weights bit-identical to the unscaled step's, the rest within "
          f"{worst:.3g} of their largest magnitude")
    if found or scale != 2.0 ** 15 or worst > 1e-6:
        raise AssertionError("the scaled step differs from the unscaled one")
    return peaks


OPT_STEPS = 3                        # captured steps of each optimizer
MERGE_STEPS = 4                      # the merge (k = 2) fires at 2 and 4


def _not_decayed(p):
    return "bias" in p.name or "ln" in p.name


def _optimizers():
    """name -> (a factory of the optimizer over named parameters, steps,
    whether it runs the fused AdamW kernel)."""
    import paddle_tpu_torch as pt
    o = pt.optimizer
    return {
        "SGD": (lambda ps: o.SGD(1e-3, parameters=ps), OPT_STEPS, False),
        "Momentum(use_nesterov=True)": (lambda ps: o.Momentum(
            1e-4, momentum=0.9, parameters=ps, use_nesterov=True),
            OPT_STEPS, False),
        "LarsMomentum": (lambda ps: o.LarsMomentum(
            1e-2, parameters=ps, exclude_from_weight_decay=["bias", "ln"]),
            OPT_STEPS, False),
        "RMSProp(centered=True)": (lambda ps: o.RMSProp(
            1e-5, momentum=0.5, centered=True, parameters=ps),
            OPT_STEPS, False),
        "Adagrad": (lambda ps: o.Adagrad(
            1e-3, parameters=ps, initial_accumulator_value=0.1),
            OPT_STEPS, False),
        "Adadelta": (lambda ps: o.Adadelta(1.0, parameters=ps), OPT_STEPS,
                     False),
        "Adamax": (lambda ps: o.Adamax(1e-4, parameters=ps), OPT_STEPS,
                   False),
        "Lamb": (lambda ps: o.Lamb(1e-3, parameters=ps,
                                   exclude_from_weight_decay_fn=_not_decayed),
                 OPT_STEPS, False),
        "GradientMergeOptimizer(AdamW(fused=True), k_steps=2)": (
            lambda ps: o.GradientMergeOptimizer(
                o.AdamW(1e-4, parameters=ps, fused=True), k_steps=2),
            MERGE_STEPS, True),
    }


def phase_optimizers():
    """At depth 2 of GPT-1.3B's widths (f32 masters,
    ``to_static(amp_policy="bf16")``, one seeded batch of 4 x 1024 a
    step), each optimizer of ``_optimizers()``: its steps through
    ``dygraph_function`` first, then captured, losses and final weights
    bit for bit, one capture, finite losses, launches exact (the merge's
    inner fused AdamW launches its kernel every step, and its weights
    move only on the firing steps); then ``SGD(guard=True)`` with a
    planted ``nan_grad``: that parameter kept, every other one moved."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    from paddle_tpu_torch.resilience import (FaultInjector, FaultPlan,
                                             FaultSpec)
    total = None
    for name, (make, steps, fused) in _optimizers().items():
        cfg, twin = _gpt(num_layers=2)
        vocab = cfg.vocab_size
        batches = [(_batch(vocab, 3000 + i)) for i in range(steps)]
        twin_step = _train_step(twin, make(twin.named_parameters()), vocab,
                                guard=False)
        reset_launches()
        eager = []
        for batch in batches:
            with pt.amp.activation_residency("bf16"):
                eager.append(twin_step.dygraph_function(*batch).item())
        eager_launches = read_launches(f"{name}, dygraph_function")
        if eager_launches != step_launches(cfg, steps, fused=fused,
                                           guard=False):
            raise AssertionError(f"{name}: dygraph launches "
                                 f"{eager_launches}")
        eager_weights = [p.detach() for p in twin.parameters()]
        del twin, twin_step
        gc.collect()
        _, model = _gpt(num_layers=2)
        step = _train_step(model, make(model.named_parameters()), vocab,
                           guard=False)
        reset_launches()
        losses, moved, step_s = [], [], []
        for batch in batches:
            before = [p.detach().clone() for p in model.parameters()]
            t0 = time.perf_counter()
            losses.append(step(*batch).item())
            step_s.append(time.perf_counter() - t0)
            moved.append(any(not torch.equal(a, p) for a, p in
                             zip(before, model.parameters())))
            del before
        launches = read_launches(name)
        expect = step_launches(cfg, steps + WARMUP_CALLS, fused=fused,
                               guard=False)
        differ = sum(not torch.equal(a, b)
                     for a, b in zip(model.parameters(), eager_weights))
        print(f"[optimizers] {name}: captured losses {losses}, eager "
              f"{eager}; {differ} of {len(eager_weights)} weights differ; "
              f"weights moved at steps "
              f"{[i + 1 for i, m in enumerate(moved) if m]}; "
              f"{len(step._compiled)} capture(s); replayed step "
              f"{statistics.median(step_s[1:]) * 1e3:.1f} ms")
        if launches != expect:
            raise AssertionError(f"{name}: launches {launches} != {expect}")
        if losses != eager or differ or len(step._compiled) != 1:
            raise AssertionError(f"{name}: the captured steps differ from "
                                 f"the eager ones")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        want_moved = [fused and i % 2 == 0 or not fused
                      for i in range(1, steps + 1)]
        if moved != want_moved:
            raise AssertionError(f"{name}: weights moved {moved}, expected "
                                 f"{want_moved}")
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
        del model, step, eager_weights
        gc.collect()
        torch.cuda.empty_cache()

    cfg, model = _gpt(num_layers=2)
    opt = pt.optimizer.SGD(1e-3, parameters=model.named_parameters(),
                           guard=True)
    step = _train_step(model, opt, cfg.vocab_size, guard=True)
    target = "gpt.layers.0.attn.qkv_proj.weight"
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    plan = FaultPlan([FaultSpec("optimizer.grads", "nan_grad", at=0,
                                payload={"param": target})])
    with FaultInjector(plan), pt.amp.activation_residency("bf16"):
        step.dygraph_function(*_batch(cfg.vocab_size, 3000))
    summary = opt.guard_summary()
    kept = [n for n, p in model.named_parameters()
            if torch.equal(p, before[n])]
    print(f"[optimizers] SGD(guard=True), nan_grad in {target}: kept "
          f"{kept}, {summary}")
    if kept != [target] or summary.good or summary.bad_regions != 1:
        raise AssertionError("the guarded SGD step did not hold exactly the "
                             "faulted parameter")
    return total


# serving runs of one engine after a warm-up: spans on with a spool
# armed, spans on, spans off, in turns
OBS_PLAN = ("on+spool", "off", "on", "off", "off", "on", "off", "on+spool")
OBS_STEPS = 6                        # uninterrupted preempt-phase steps
OBS_PREEMPT = 3                      # the step the preempt fault drains at
OBS_LAST_GOOD, OBS_POISON, OBS_TOTAL = 2, 5, 8    # localize_poison's run


def _spans_by_name():
    from paddle_tpu_torch import observability as obs
    return {k: v["count"] for k, v in obs.recorder().aggregates().items()}


def _spans_since(before):
    return {k: n - before.get(k, 0) for k, n in _spans_by_name().items()
            if n != before.get(k, 0)}


def _obs_serve(eng, prompts, sps, spans_on):
    """One generate() of the batch with spans on or off, under a fresh
    TraceContext: (tokens, tokens/s, mean decode step ms, the spans the
    run should record by name)."""
    from paddle_tpu_torch import observability as obs
    m = eng.metrics
    gen0, n0, s0 = (m.generated_tokens, m.decode_step_s.count,
                    m.decode_step_s.sum)
    p0, f0 = m.prefill_steps, m.requests_finished
    prev = obs.set_enabled(spans_on)
    try:
        t0 = time.perf_counter()
        with obs.use_context(obs.TraceContext.new("smoke")):
            res = eng.generate(prompts, sps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        obs.set_enabled(prev)
    spans = {"serving.prefill": m.prefill_steps - p0,
             "serving.decode": m.decode_step_s.count - n0,
             "serving.finish": m.requests_finished - f0}
    return ([r.output_token_ids for r in res],
            (m.generated_tokens - gen0) / wall,
            (m.decode_step_s.sum - s0) / (m.decode_step_s.count - n0) * 1e3,
            spans if spans_on else {})


def _span_cost(n=100_000):
    """Host µs of one empty span: off, on, on under a TraceContext, and
    that with Python's cyclic collector off (no spool armed); with the
    process's tracked objects and one full collection's ms."""
    from paddle_tpu_torch import observability as obs
    out = {}
    for tag, on, ctx in (("off", False, None), ("on", True, None),
                         ("on+trace", True, obs.TraceContext("cost")),
                         ("on+trace, gc off", True,
                          obs.TraceContext("cost"))):
        prev = obs.set_enabled(on)
        if tag.endswith("gc off"):
            gc.disable()
        try:
            with obs.use_context(ctx):
                t0 = time.perf_counter()
                for _ in range(n):
                    with obs.span("obs.cost"):
                        pass
                out[tag] = (time.perf_counter() - t0) / n * 1e6
        finally:
            obs.set_enabled(prev)
            gc.enable()
    t0 = time.perf_counter()
    gc.collect()
    out["gc_collect_ms"] = (time.perf_counter() - t0) * 1e3
    out["tracked_objects"] = len(gc.get_objects())
    return out


def _per_call_us(fn, n=200_000):
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def span_overhead(rounds=3):
    """What the spans cost on the serving path, outside the phases (run
    after ``phase_device()`` and ``phase_build()``): one engine of
    ``_obs_serving``'s setup serves the batch once to warm up, then
    ``rounds`` times with spans on and off in turns; then the host µs of
    a span's pieces (a clock read, ``os.getpid``,
    ``threading.get_ident``, a lock, the profiler flag) and of an empty
    span, and one run with spans on and one off under ``cProfile`` (each
    run's profiled seconds and its ten functions of most own time).
    Prints and returns one dict."""
    import cProfile
    import os
    import pstats
    import threading

    cfg, model = _serving_model("span overhead")
    prompts, sps = _serving_requests(cfg.vocab_size)
    eng = _serving_engine(model, metrics_name="span-overhead")
    eng.warmup()
    _obs_serve(eng, prompts, sps, False)             # warm-up, not counted
    runs = {"on": [], "off": []}
    for i in range(rounds):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            _, tps, decode_ms, _ = _obs_serve(eng, prompts, sps, on)
            runs["on" if on else "off"].append((tps, decode_ms))
    lock = threading.Lock()

    def lock_cycle():
        with lock:
            pass

    pieces = {"perf_counter_ns": _per_call_us(time.perf_counter_ns),
              "os.getpid": _per_call_us(os.getpid),
              "threading.get_ident": _per_call_us(threading.get_ident),
              "lock": _per_call_us(lock_cycle),
              "profiler_enabled": _per_call_us(
                  torch._C._autograd._profiler_enabled)}
    profiles = {}
    for on in (True, False):
        prof = cProfile.Profile()
        prof.enable()
        _obs_serve(eng, prompts, sps, on)
        prof.disable()
        stats = pstats.Stats(prof)
        rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:10]
        profiles["on" if on else "off"] = {
            "profiled_s": stats.total_tt,
            "top": [(f"{Path(f).name}:{line}({name})", v[1],
                     round(v[2] * 1e3, 3)) for (f, line, name), v in rows]}
    eng.shutdown()
    out = {"card": card_line(), "runs": runs, "pieces_us": pieces,
           "span_us": _span_cost(), "profiles": profiles}
    print(f"[span overhead] {json.dumps(out)}")
    return out


def _obs_serving():
    """GPT-1.3B serving under the observability plane: the smoke engine
    (``metrics_name="smoke"``) built inside a telemetry spool, its
    programs as ``serving-aot`` events, its span counts, a scrape, the
    spool merged into a Chrome trace. After a warm-up run, the same
    requests with spans on and the spool armed, with spans on alone, and
    with spans off, in turns (``OBS_PLAN``), give the same tokens. Then
    an empty span's host cost. Returns (launches, numbers)."""
    import urllib.request

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.observability import export, fleettrace
    cfg, model = _serving_model("observability")
    prompts, sps = _serving_requests(cfg.vocab_size)
    log = obs.recompile_log()
    since = log.count
    runs = {tag: [] for tag in OBS_PLAN}
    with tempfile.TemporaryDirectory() as spool_dir:
        fleettrace.arm_spool(spool_dir, rank=0, metrics_interval_s=0.5)
        try:
            eng = _serving_engine(model, metrics_name="smoke")
            bound = eng.config.compile_bound
            eng.warmup()
            aot = [e for e in log.events() if e.seq > since
                   and e.kind == "serving-aot"
                   and e.attrs.get("engine") == "smoke"]
            compiles = obs.registry().counter(
                "serving_compile_total", labels={"engine": "smoke"}).value
            print(f"[observability] warmup: {len(aot)} serving-aot events "
                  f"of the smoke engine ({[e.fn for e in aot]}), "
                  f"serving_compile_total {compiles}, build ms "
                  f"{[e.compile_ms for e in aot]}")
            if len(aot) != bound or compiles != bound or bound != 10:
                raise AssertionError(f"{len(aot)} serving-aot events, "
                                     f"{compiles} compiles, bound {bound}")
            m = eng.metrics
            _obs_serve(eng, prompts, sps, False)     # warm-up, not counted
            f0 = m.requests_finished
            spans0 = _spans_by_name()
            torch.cuda.synchronize()
            reset_launches()
            forwards = m.prefill_steps + m.decode_steps
            for tag in OBS_PLAN:
                spooled = fleettrace.active_spool() is not None
                if tag == "on+spool" and not spooled:
                    fleettrace.arm_spool(spool_dir, rank=0,
                                         metrics_interval_s=0.5)
                elif tag != "on+spool" and spooled:
                    fleettrace.disarm()
                runs[tag].append(_obs_serve(eng, prompts, sps,
                                            tag != "off"))
            launches = read_launches("observability serving")
            spans = _spans_since(spans0)
            forwards = m.prefill_steps + m.decode_steps - forwards
            expect = {k: 0 for k in launches}
            expect.update(ln_fwd=forwards * (cfg.num_layers + 1),
                          ln_res_fwd=forwards * cfg.num_layers)
            if launches != expect:
                raise AssertionError(f"launches {launches} != {expect}")
            want = {}
            for rs in runs.values():
                for r in rs:
                    for name, n in r[3].items():
                        want[name] = want.get(name, 0) + n
            print(f"[observability] spans of the runs with spans on: "
                  f"{spans}; their prefills, decode steps and finished "
                  f"requests: {want}")
            if any(spans.get(name) != n for name, n in want.items()):
                raise AssertionError("a span count differs from its "
                                     "engine count")
            if m.requests_finished - f0 != len(OBS_PLAN) * len(prompts) \
                    or m.compile_count != bound:
                raise AssertionError("the engine built past warmup() or "
                                     "lost a request")
            first = runs["on+spool"][0][0]
            if any(r[0] != first for rs in runs.values() for r in rs):
                raise AssertionError("spans on and off serve other tokens")
            with export.serve_prometheus(port=0) as server:
                with urllib.request.urlopen(server.url, timeout=10) as r:
                    body = r.read().decode()
            series = [ln for ln in body.splitlines()
                      if 'engine="smoke"' in ln]
            print(f"[observability] scrape of {server.url}: {len(series)} "
                  f"series of the smoke engine, e.g. "
                  f"{[s for s in series if 'compile' in s]}")
            if f'serving_compile_total{{engine="smoke"}} {bound}' not in \
                    body or 'serving_ttft_seconds_count{engine="smoke"}' \
                    not in body:
                raise AssertionError("the scrape lacks the smoke engine")
            eng.shutdown()
        finally:
            fleettrace.disarm()
        fleet = fleettrace.merge_spools(spool_dir)
        trace = fleet.chrome_trace()
        names = {e["name"] for e in trace["traceEvents"]}
        # the first request after the warm-up run
        first_req = f"req-{len(prompts)}"
        line = fleet.timeline(first_req)
        print(f"[observability] spool merged: {fleet.summary()}; its "
              f"Chrome trace holds {len(trace['traceEvents'])} events; "
              f"request {first_req}'s timeline stages {line['stages']}")
        if not {"serving.prefill", "serving.decode", "serving.finish",
                "recompile:decode"} <= names or \
                "prefill_s" not in line["stages"]:
            raise AssertionError(f"the merged trace lacks spans: {names}")
    card = card_line()
    numbers = {}
    for tag, rs in runs.items():
        numbers[tag] = {"tokens_per_s": [r[1] for r in rs],
                        "decode_ms": [r[2] for r in rs]}
        print(f"[observability] {card}: spans {tag}: tokens/s by run "
              f"{numbers[tag]['tokens_per_s']}, mean decode step ms by run "
              f"{numbers[tag]['decode_ms']}")
    numbers["span_us"] = _span_cost()
    print(f"[observability] an empty span's host µs: {numbers['span_us']}")
    return launches, numbers


def _obs_model():
    """A depth-2 GPT-1.3B (f32 masters), ``AdamW(1e-4, fused=True,
    guard=True)`` and its captured guarded step."""
    import paddle_tpu_torch as pt
    cfg, model = _gpt(num_layers=2)
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters(),
                             fused=True, guard=True)
    return cfg, model, opt, _train_step(model, opt, cfg.vocab_size,
                                         guard=True)


def _eager(step_fn, batch):
    import paddle_tpu_torch as pt
    with pt.amp.activation_residency("bf16"):
        return step_fn.dygraph_function(*batch).item()


def _captured(step_fn, batch):
    step_fn(*batch)
    return step_fn.last_guard["loss"]


def _obs_recompiles():
    """The recompile log's causes for a first call, a changed batch
    shape and a new registry version of the captured step; (the first
    call's ms, the attribution's ms a build)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.jit.api import StaticFunction
    cfg, model, opt, step_fn = _obs_model()
    vocab = cfg.vocab_size
    since = obs.recompile_log().count
    noted = []
    note_build = StaticFunction._note_build

    def timed(self, *args):
        t0 = time.perf_counter()
        event = note_build(self, *args)
        noted.append((time.perf_counter() - t0) * 1e3)
        return event

    StaticFunction._note_build = timed
    try:
        _captured(step_fn, _batch(vocab, 4000))
        ids, labels = _batch(vocab, 4001)
        _captured(step_fn, (ids[:, :S // 2], labels[:, :S // 2]))
        pt.optimizer.SGD(0.1, parameters=[torch.nn.Parameter(
            torch.zeros(2, device="cuda"))])
        _captured(step_fn, _batch(vocab, 4002))
    finally:
        StaticFunction._note_build = note_build
    events = [e for e in obs.recompile_log().events() if e.seq > since]
    got = [(e.fn, e.kind, e.cause) for e in events]
    print(f"[observability] recompile events: "
          f"{[(e.cause, e.changes, e.trace_ms, e.compile_ms) for e in events]}"
          f"; attribution ms a build {noted}")
    want = [("train_step", "jit", "first compile of this function"),
            ("train_step", "jit", "shape change in ids, labels"),
            ("train_step", "jit", "state change in <state-registry>")]
    if got != want or events[1].changes[0]["after"] != [B, S // 2]:
        raise AssertionError(f"recompile events {got}")
    first_ms = events[0].trace_ms + events[0].compile_ms
    del model, opt, step_fn
    return first_ms, noted


def _obs_preempt(ckpt_dir):
    """Six captured steps; then the same six with a ``preempt`` fault at
    the third ``optimizer.step`` (eager steps, under a PreemptionHandler):
    it drains a checkpoint of step 3 (losses 1-3 bit for bit), and a
    fresh model and optimizer resumed from it take steps 4-6 captured.
    The fresh optimizer drops the saved moments, as the reference's
    does, so the resumed steps are held bit for bit to a twin resumed
    the same way that takes them eagerly; the parameters' digest is
    equal before the save and after the load."""
    from paddle_tpu_torch.framework.io import numpy_state_dict
    from paddle_tpu_torch.resilience import (Checkpointer, FaultInjector,
                                             FaultPlan, FaultSpec,
                                             PreemptionHandler, auto_resume,
                                             tree_digest)
    cfg, model, _, step_fn = _obs_model()
    vocab = cfg.vocab_size
    batches = {s: _batch(vocab, 5000 + s) for s in range(1, OBS_STEPS + 1)}
    clean = [_captured(step_fn, batches[s]) for s in range(1, OBS_STEPS + 1)]
    del model, step_fn
    gc.collect()
    cfg, model, opt, step_fn = _obs_model()
    ck = Checkpointer(ckpt_dir, keep=1)
    plan = FaultPlan([FaultSpec("optimizer.step", "preempt",
                                at=OBS_PREEMPT - 1)], name="smoke-preempt")
    losses, digest = [], None
    with PreemptionHandler(checkpointer=ck) as pre, FaultInjector(plan):
        for s in range(1, OBS_STEPS + 1):
            losses.append(_eager(step_fn, batches[s]))

            def state(s=s):
                nonlocal digest
                weights = numpy_state_dict(model)
                digest = tree_digest(weights)
                return {"step": s, "model": weights,
                        "optimizer": opt.state_dict()}

            if pre.check(s, state):
                break
    drain_ms = pre.drain_ms
    del model, opt, step_fn
    gc.collect()
    cfg, model, opt, step_fn = _obs_model()
    start, _ = auto_resume(ck, model, opt)
    twin = [_eager(step_fn, batches[s]) for s in range(start, OBS_STEPS + 1)]
    del model, opt, step_fn
    gc.collect()
    cfg, model, opt, step_fn = _obs_model()
    start, _ = auto_resume(ck, model, opt)
    loaded = tree_digest(numpy_state_dict(model))
    drained = list(losses)
    losses += [_captured(step_fn, batches[s])
               for s in range(start, OBS_STEPS + 1)]
    print(f"[observability] preempt fault at step {OBS_PREEMPT}: drained "
          f"at step {pre.drain_step} ({pre.reason}) in {drain_ms} ms; "
          f"resumed at step {start}; digest before the save {digest}, "
          f"after the load {loaded}")
    print(f"[observability] uninterrupted losses {clean}")
    print(f"[observability] resumed losses       {losses}")
    print(f"[observability] eager twin's resumed {twin}")
    if pre.drain_step != OBS_PREEMPT or start != OBS_PREEMPT + 1:
        raise AssertionError(f"drained at {pre.drain_step}, resumed at "
                             f"{start}")
    if digest != loaded:
        raise AssertionError("the parameters' digest changed through the "
                             "checkpoint")
    if drained != clean[:OBS_PREEMPT]:
        raise AssertionError("the drained run's losses differ from the "
                             "uninterrupted run's")
    if losses[OBS_PREEMPT:] != twin:
        raise AssertionError("the captured resumed steps differ from the "
                             "eager twin's")
    return drain_ms


def _obs_localize(ckpt_dir):
    """localize_poison over a BatchLineage: 8 guarded steps, a checkpoint
    at step 2, a nan_grad planted at step 5 (that step eager under its
    plan, the others captured); bisecting replays from the checkpoint
    name step 5."""
    from paddle_tpu_torch.resilience import (BatchLineage, Checkpointer,
                                             FaultInjector, FaultPlan,
                                             FaultSpec, auto_resume,
                                             localize_poison)
    cfg, model, opt, step_fn = _obs_model()
    vocab = cfg.vocab_size
    ck = Checkpointer(ckpt_dir, keep=1)
    lineage = BatchLineage()

    def run(step):
        e = lineage.get(step)
        batch = _batch(vocab, e["seed"])
        if not e["faults"]:
            _captured(step_fn, batch)
        else:
            with FaultInjector(FaultPlan([FaultSpec(*f)
                                          for f in e["faults"]])):
                _eager(step_fn, batch)
        return opt.guard_summary().good

    flagged = None
    for s in range(1, OBS_TOTAL + 1):
        lineage.record(s, seed=6000 + s, faults=[
            ("optimizer.grads", "nan_grad", 0)] if s == OBS_POISON else [])
        if not run(s) and flagged is None:
            flagged = s
        if s == OBS_LAST_GOOD:
            ck.save_train_state(s, model, opt)
    replays = []

    def replay(upto):
        replays.append(upto)
        auto_resume(ck, model, opt, step=OBS_LAST_GOOD)
        good = [run(s) for s in range(OBS_LAST_GOOD + 1, upto + 1)]
        return not all(good)

    found = localize_poison(replay, OBS_LAST_GOOD, OBS_TOTAL)
    print(f"[observability] nan_grad planted at step {OBS_POISON}: flagged "
          f"at step {flagged}, localize_poison names step {found} after "
          f"replays to {replays}")
    if found != OBS_POISON or flagged != OBS_POISON:
        raise AssertionError(f"localize_poison named {found}")


def phase_observability():
    """The observability and resilience slice on the main paths: GPT-1.3B
    serving with spans, the recompile log, a scrape and a spool, spans
    on and off; a depth-2 GPT-1.3B guarded, fused train step's
    recompile causes, a preempt-and-resume bit for bit, and a poison
    step localized. Prints the numbers as JSON; returns the launches of
    both drives."""
    launches, numbers = _obs_serving()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_launches()
    first_ms, attribution_ms = _obs_recompiles()
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        drain_ms = _obs_preempt(str(Path(tmp) / "preempt"))
        gc.collect()
        _obs_localize(str(Path(tmp) / "localize"))
    train = read_launches("observability train")
    path = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ln_fwd",
            "ln_res_fwd", "ln_bwd", "ln_bwd_res", "adam_update_guard",
            "adam_guard_sumsq")
    if not all(train[k] for k in path):
        raise AssertionError(f"a train kernel never launched: {train}")
    print(f"[observability] train drives in {time.perf_counter() - t0:.1f} "
          f"s: first call (discovery, capture, first replay) {first_ms} ms, "
          f"its attribution {attribution_ms[0]} ms, drain {drain_ms} ms; "
          f"launches {train}")
    numbers.update(first_call_ms=first_ms, attribution_ms=attribution_ms,
                   drain_ms=drain_ms)
    print(f"[observability] {card_line()}: {json.dumps(numbers)}")
    return {k: launches[k] + train[k] for k in launches}


# ------------------------------------ router, traffic, profiler and drift
ROUTER_CRASH_AT = 6        # serving.decode occurrence the crash plan hits
TRAFFIC_QUANTUM = 0.02     # virtual seconds a fleet step models
TRAFFIC_SPEC = dict(name="smoke-poisson", seed=14,
                    arrival={"kind": "poisson", "rate_qps": 40.0},
                    duration_s=0.5, prompt_len=((1.0, 16, 256),),
                    output_tokens=((1.0, 8, 32),),
                    classes=({"name": "interactive", "ttft_slo_s": 0.25},))
BURST_SPEC = dict(name="smoke-burst", seed=15,
                  arrival={"kind": "onoff", "base_qps": 4.0,
                           "burst_qps": 120.0, "period_s": 0.5,
                           "duty": 0.4},
                  duration_s=1.0, prompt_len=((1.0, 16, 128),),
                  output_tokens=((1.0, 16, 32),),
                  classes=({"name": "interactive", "ttft_slo_s": 0.5},))
PROFILE_TOP = 5            # layers predicted beside their kernel time
PROFILE_REPLAYS = 3        # captured step replays the profile is held to
DRIFT_STEPS = 3            # decode steps before the replay (the
                           # router drive's crash migrates at 4 tokens)
DRIFT_FOLLOW = 48          # decode steps the two paths continue for
# PERF.md's kernel table: the bound ms of each kernel at its shape
TABLE_BOUNDS = {
    ("flash_fwd", "[4,1024,16,128] causal bf16"): 0.02011,
    ("flash_bwd_dq", "[4,1024,16,128] causal bf16"): 0.02608,
    ("flash_bwd_dkv", "[4,1024,16,128] causal bf16"): 0.03478,
    ("ln_fwd", "rows 8 bf16"): 0.00002,
    ("ln_fwd", "rows 1000 bf16"): 0.00245,
    ("ln_fwd", "rows 4096 bf16"): 0.01002,
    ("ln_fwd", "rows 4096 train mix"): 0.01002,
    ("ln_res_fwd", "rows 8 bf16"): 0.00004,
    ("ln_res_fwd", "rows 1000 bf16"): 0.00489,
    ("ln_res_fwd", "rows 4096 bf16"): 0.02003,
    ("ln_res_fwd", "rows 4096 train mix"): 0.02004,
    ("ln_bwd", "rows 4096 bf16"): 0.01503,
    ("ln_bwd", "rows 8 bf16"): 0.00004,
    ("ln_bwd_res", "rows 4096 bf16"): 0.02004,
    ("ln_bwd_res", "rows 8 bf16"): 0.00005,
    ("rms_fwd", "rows 8192 bf16, f32 w"): 0.02003,
    ("rms_fwd", "rows 8 bf16, f32 w"): 0.00002,
    ("adam_update", "[50304,2048] f32"): 0.86108,
    ("adam_update_guard", "[50304,2048] f32"): 0.86108,
    ("adam_guard_sumsq", "[50304,2048] f32"): 0.12301,
    ("bsa_fwd", "(a) [2,16,4096,128] bf16"): 0.04022,
    ("keep_mask", "[4,16,1024,1024] bf16"): 0.16048,
}


def _replica_factory(model, cache, created, clock=None):
    """The router's engine factory: the serving cell's engine over the
    shared program cache, with a decode exception failing the replica
    (the router's failover path); every engine made lands in
    ``created``, and every ``adopt_request`` notes the tokens a request
    brought (``eng.adopted``)."""
    from paddle_tpu_torch.serving import EngineConfig, LLMEngine

    def factory(index):
        eng = LLMEngine(model, EngineConfig(
            max_num_seqs=8, page_size=16, max_model_len=1024,
            dtype=torch.bfloat16, crash_safe_decode=False),
            program_cache=cache, clock=clock)
        eng.adopted = []
        adopt = eng.adopt_request

        def noted(prompt, sp, generated_token_ids=(), **kw):
            eng.adopted.append(len(generated_token_ids))
            return adopt(prompt, sp, generated_token_ids=generated_token_ids,
                         **kw)

        eng.adopt_request = noted
        created.append(eng)
        return eng

    return factory


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def _router_drive(cfg, model, single, cache):
    """GPT-1.3B behind a Router of 2 replicas sharing the model: replica
    0 boots cold into the AOT cache, replica 1 warm from it; phase 4's 8
    requests served with replica 0 drained before its first step (its 4
    queued requests migrate before any token), then again under a
    planted ``serving.decode`` crash (the failed replica's running
    requests migrate with their tokens and replay). Returns the launches
    and the numbers."""
    from paddle_tpu_torch.resilience.faultinject import (FaultInjector,
                                                         FaultPlan, FaultSpec)
    from paddle_tpu_torch.serving.router import Router, RouterConfig
    prompts, sps = _serving_requests(cfg.vocab_size)
    created = []
    t0 = time.perf_counter()
    with _span_window() as window:
        router = Router(engine_factory=_replica_factory(model, cache,
                                                        created),
                        num_replicas=2,
                        config=RouterConfig(sleep=lambda s: None))
        torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    boots = [dict(h.boot_info) for h in router.replicas]
    bound = created[0].config.compile_bound
    print(f"[router] {card_line()}: 2 replicas in {boot_s:.2f} s: replica 0 "
          f"{boots[0]}, replica 1 {boots[1]}; each build's ms in order "
          f"(cold, then warm) {_build_ms(window)}")
    if not (boots[0]["compiled"] == boots[0]["programs"] == bound == 10
            and boots[0]["warm"] is False and boots[0]["cache_loads"] == 0):
        raise AssertionError(f"replica 0 did not boot cold: {boots[0]}")
    if not (boots[1]["compiled"] == 0 and boots[1]["warm"] is True
            and boots[1]["cache_loads"] == boots[1]["programs"] == bound):
        raise AssertionError(f"replica 1 did not boot warm: {boots[1]}")
    if cache.error_count:
        raise AssertionError(f"a cache record failed its digest: "
                             f"{cache.stats()}")
    reset_launches()
    n_boot = len(created)
    t0 = time.perf_counter()
    rids = [router.add_request(p, sp) for p, sp in zip(prompts, sps)]
    router.drain(0)
    while router.has_unfinished():
        router.step()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    res_a = [router.finished_results.pop(r) for r in rids]
    plan = FaultPlan([FaultSpec("serving.decode", "exception",
                                at=ROUTER_CRASH_AT)], name="router-crash")
    t0 = time.perf_counter()
    with FaultInjector(plan) as inj:
        rids = [router.add_request(p, sp) for p, sp in zip(prompts, sps)]
        while router.has_unfinished():
            router.step()
    torch.cuda.synchronize()
    crash_s = time.perf_counter() - t0
    res_b = [router.finished_results.pop(r) for r in rids]
    launches = read_launches("router")
    snap = router.snapshot()
    respawned = created[n_boot:]
    forwards = sum(e.metrics.prefill_steps + e.metrics.decode_steps
                   for e in created) \
        + len(respawned) * (len(created[0].config.prefill_buckets) + 1)
    expect = {k: 0 for k in launches}
    expect.update(ln_fwd=forwards * (cfg.num_layers + 1),
                  ln_res_fwd=forwards * cfg.num_layers)
    print(f"[router] drain run {drain_s:.2f} s, crash run {crash_s:.2f} s; "
          f"faults {[(s, sp.kind, o) for s, sp, o in inj.injected]}; "
          f"counters drains {snap['drains']} failovers {snap['failovers']} "
          f"adoptions {snap['adoptions']} respawns {snap['respawns']}, "
          f"engines {len(created)}, forwards {forwards} (boot replays of "
          f"{len(respawned)} respawns included); launches {launches}")
    if launches != expect:
        raise AssertionError(f"router launches {launches} != {expect}")
    if (snap["drains"], snap["failovers"], snap["respawns"]) != (1, 1, 2):
        raise AssertionError(f"router counters {snap}")
    warm_respawns = [e.metrics.aot_cache_loads for e in respawned]
    if any(e.metrics.compile_count for e in respawned) or \
            warm_respawns != [bound] * 2:
        raise AssertionError(f"a respawn built cold: {warm_respawns}")
    adopted = [n for e in created for n in e.adopted]
    diverged = []
    for run, res in (("drain", res_a), ("crash", res_b)):
        for i, r in enumerate(res):
            if len(r.output_token_ids) != 64 or r.finish_reason != "length":
                raise AssertionError(f"{run} run request {i}: "
                                     f"{len(r.output_token_ids)} tokens, "
                                     f"{r.finish_reason}")
            d = _first_diff(r.output_token_ids, single[i])
            if r.migrations == 0 or run == "drain":
                if d is not None:
                    raise AssertionError(f"{run} run request {i} (migrations"
                                         f" {r.migrations}) differs from the"
                                         f" single engine at token {d}")
            elif d is not None:
                diverged.append((i, d))
    crashed = [n for n in adopted if n > 0]
    if adopted.count(0) != 4 or not crashed or \
            min(d for _, d in diverged or [(0, 99)]) < min(crashed):
        raise AssertionError(f"migrations {adopted}: a migrated request "
                             f"differs before its migration {diverged}")
    print(f"[router] {card_line()}: the drain migrated 4 requests before "
          f"their first token, the crash {len(crashed)} requests with "
          f"{sorted(set(crashed))} tokens each; 64 tokens a request; every "
          f"request not migrated after a token equals the single engine's;"
          f" migrated after a token and then differing (request, first "
          f"differing token): {diverged}; boot ms cold {snap['boot_cold_ms']}"
          f", warm (replica 1 and both respawns) {snap['boot_warm_ms']}")
    numbers = {"boot_ms_cold": boots[0]["boot_ms"],
               "boot_ms_warm": boots[1]["boot_ms"],
               "boot_warm_ms": snap["boot_warm_ms"],
               "migrated_tokens": crashed, "diverged": diverged,
               "drain_run_s": drain_s, "crash_run_s": crash_s}
    router.shutdown()
    return launches, numbers


def fresh_boot(cache_dir, out_path):
    """Run in a process of its own by :func:`_fresh_boot_check`: the
    router's replica engine over GPT-1.3B from the serving seed, booted
    where no program has run yet, from ``cache_dir``'s records (each
    warm build warms up once before its capture) or, with ``cache_dir``
    None, cold; then phase 4's requests. Writes the boot, the warm-up
    calls of each program, the cache's errors and the tokens to
    ``out_path`` as JSON."""
    phase_device()
    from paddle_tpu_torch.serving.aot_cache import AOTProgramCache
    cfg, model = _serving_model("fresh boot")
    cache = AOTProgramCache(cache_dir) if cache_dir else None
    eng = _replica_factory(model, cache, [])(0)
    with _span_window() as window:
        boot = eng.warmup()
    prompts, sps = _serving_requests(cfg.vocab_size)
    results = eng.generate(prompts, sps)
    torch.cuda.synchronize()
    Path(out_path).write_text(json.dumps({
        "boot": boot, "errors": cache.error_count if cache else 0,
        "build_ms": _build_ms(window),
        "warmups": sorted({p.warmups for p in eng._programs.values()}),
        "tokens": [r.output_token_ids for r in results]}))
    eng.shutdown()


def _build_ms(window):
    """{program: ms} of each cold build (``serving.compile``) and warm
    one (``serving.aot_load``) a span window saw, in build order."""
    return [[(r.attrs or {}).get("program"), round(r.dur_ns / 1e6, 1)]
            for r in window.spans()
            if r.name in ("serving.compile", "serving.aot_load")]


def _fresh_boot_check(cache, single):
    """One engine booted in a fresh process cold, then one from
    ``cache`` (the router's warm boots all run where replica 0 built
    cold): the cold one 10 builds of 2 warm-up calls, the warm one no
    cold build and 10 cache loads after one warm-up call each, no digest
    mismatch; both serve phase 4's tokens. Returns their boot ms and
    wall seconds."""
    numbers = {}
    for kind, cache_dir, want in (("cold", None, (10, 0, [2])),
                                  ("warm", cache.cache_dir, (0, 10, [1]))):
        out = Path(cache.cache_dir) / f"fresh_{kind}.json"
        call = (f"import chip_smoke as c; c.fresh_boot({cache_dir!r}, "
                f"{str(out)!r})")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", call],
                              cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"the fresh {kind} boot exited "
                                 f"{proc.returncode}: {proc.stderr[-4000:]}")
        got = json.loads(out.read_text())
        boot = got["boot"]
        print(f"[router] {card_line()}: a fresh process booted {kind}: "
              f"{boot}, warm-up calls a program {got['warmups']}, cache "
              f"errors {got['errors']}, each build's ms in order "
              f"{got['build_ms']}, wall {wall:.1f} s (the process's start "
              f"and the model's build included)")
        if (boot["compiled"], boot["cache_loads"], got["warmups"]) != want \
                or got["errors"]:
            raise AssertionError(f"fresh {kind} boot: {got['boot']}, "
                                 f"warm-ups {got['warmups']}, errors "
                                 f"{got['errors']}")
        for i, (a, b) in enumerate(zip(got["tokens"], single)):
            if a != b:
                raise AssertionError(f"fresh {kind} boot: request {i} "
                                     f"differs from phase 4 at token "
                                     f"{_first_diff(a, b)}")
        numbers[f"boot_ms_fresh_{kind}"] = boot["boot_ms"]
        numbers[f"build_ms_fresh_{kind}"] = got["build_ms"]
        numbers[f"fresh_{kind}_wall_s"] = wall
    return numbers


def _traffic_metrics(name):
    from paddle_tpu_torch.observability import registry
    snap = {}
    for m in registry().collect():
        if m.labels.get("traffic") != name:
            continue
        key = (m.name, tuple(sorted(m.labels.items())))
        snap[key] = m.summary() if m.kind == "histogram" else m.value
    return snap


def _traffic_drive(cfg, model, cache):
    """A seeded Poisson trace through 2 replicas on a VirtualClock, twice
    (identical reports and registry snapshots), then an on/off burst
    under the SLO autoscaler scaling 1 -> 2 replicas warm."""
    from paddle_tpu_torch.serving import traffic
    from paddle_tpu_torch.serving.router import Router, RouterConfig
    vocab = (1, cfg.vocab_size)
    spec = traffic.TrafficSpec(**TRAFFIC_SPEC, vocab=vocab)
    runs = []
    for _ in range(2):
        clock = traffic.VirtualClock()
        router = Router(engine_factory=_replica_factory(model, cache, [],
                                                        clock),
                        num_replicas=2, clock=clock,
                        config=RouterConfig(sleep=lambda s: None))
        driver = traffic.TrafficDriver(router, spec, clock,
                                       quantum_s=TRAFFIC_QUANTUM,
                                       name="smoke-traffic")
        t0 = time.perf_counter()
        rep = driver.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((rep, _traffic_metrics("smoke-traffic"), wall,
                     [h.boot_info["warm"] for h in router.replicas]))
        driver.release()
        router.shutdown()
    (rep, snap, wall, warm), (rep2, snap2, wall2, _) = runs
    print(f"[traffic] {card_line()}: {json.dumps(rep)}; wall {wall:.2f} s "
          f"and {wall2:.2f} s, replicas warm {warm}")
    if rep != rep2 or snap != snap2:
        raise AssertionError(f"same-seed traffic runs differ: {rep2}")
    if rep["token_loss"] or rep["completed"] != rep["offered"] or \
            rep["offered"] != len(traffic.compile_trace(spec)) or \
            not all(warm):
        raise AssertionError(f"traffic run {rep}, warm {warm}")
    burst = traffic.TrafficSpec(**BURST_SPEC, vocab=vocab)
    clock = traffic.VirtualClock()
    router = Router(engine_factory=_replica_factory(model, cache, [], clock),
                    num_replicas=2, clock=clock,
                    config=RouterConfig(sleep=lambda s: None))
    router.park(1)
    router.step()                            # replica 1 drains out: parked
    scaler = traffic.SLOAutoscaler(
        router, slo=traffic.SLO(queue_high=4.0, queue_low=0.5),
        config=traffic.AutoscalerConfig(up_after=2, down_after=10 ** 6,
                                        cooldown=4), clock=clock)
    driver = traffic.TrafficDriver(router, burst, clock,
                                   quantum_s=TRAFFIC_QUANTUM,
                                   name="smoke-burst",
                                   on_tick=lambda d: scaler.observe())
    t0 = time.perf_counter()
    brep = driver.run()
    bwall = time.perf_counter() - t0
    ssnap = scaler.snapshot()
    up = router.replicas[1].boot_info
    print(f"[traffic] {card_line()}: on/off burst {json.dumps(brep)}; "
          f"autoscaler {json.dumps(ssnap)}; replica 1 respawned "
          f"{up}; wall {bwall:.2f} s")
    if ssnap["scale_ups"] != 1 or not up.get("warm") or brep["token_loss"] \
            or brep["completed"] != brep["offered"]:
        raise AssertionError(f"burst run {brep}, autoscaler {ssnap}, "
                             f"boot {up}")
    scaler.release()
    driver.release()
    router.shutdown()
    return {"poisson": rep, "burst": brep, "autoscaler": ssnap,
            "scale_up_boot_ms": up["boot_ms"]}


def _table_launches(gen):
    """Each kernel at its row of the kernel table, launched on the card
    under the profiler's walk: (row, booked costs)."""
    from paddle_tpu_torch.observability import profile
    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import norm, optim, random as rnd
    bf16, f32 = torch.bfloat16, torch.float32

    def rn(*shape, dtype=bf16):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    q, k, v, do = (rn(B, S, H, D) for _ in range(4))
    lse = torch.zeros(B * H, S, device="cuda")
    w2, b2 = rn(HIDDEN, dtype=f32), rn(HIDDEN, dtype=f32)
    wb, bb = rn(HIDDEN), rn(HIDDEN)
    sq, sk, sv, bm, bq, bk = _bsa_case("a", gen)
    p_, g_, m_, v_ = (rn(50304, 2048, dtype=f32) for _ in range(4))
    sc = torch.tensor([1e-4, 0.1, 0.001, 1.0], device="cuda")
    adam = dict(beta1=0.9, beta2=0.999, eps=1e-8)
    calls = [
        ("[4,1024,16,128] causal bf16",
         lambda: fa.flash_fwd(q, k, v, True)),
        ("[4,1024,16,128] causal bf16",
         lambda: fa.flash_bwd_dq(q, k, v, do, lse, lse, True)),
        ("[4,1024,16,128] causal bf16",
         lambda: fa.flash_bwd_dkv(q, k, v, do, lse, lse, True)),
        *[(f"rows {r} bf16", lambda r=r: norm.ln_fwd(rn(r, HIDDEN), wb, bb))
          for r in (8, 1000, 4096)],
        ("rows 4096 train mix", lambda: norm.ln_fwd(rn(4096, HIDDEN), w2,
                                                    b2)),
        *[(f"rows {r} bf16", lambda r=r: norm.ln_res_fwd(
            rn(r, HIDDEN), rn(r, HIDDEN), wb, bb)) for r in (8, 1000, 4096)],
        ("rows 4096 train mix", lambda: norm.ln_res_fwd(
            rn(4096, HIDDEN), rn(4096, HIDDEN), w2, b2)),
        *[(f"rows {r} bf16", lambda r=r, gh=gh: norm.ln_bwd(
            rn(r, HIDDEN), rn(r, HIDDEN), w2, b2,
            gh=rn(r, HIDDEN) if gh else None))
          for gh in (False, True) for r in (4096, 8)],
        *[(f"rows {r} bf16, f32 w", lambda r=r: norm.rms_fwd(
            rn(r, HIDDEN), w2)) for r in (8192, 8)],
        ("[50304,2048] f32", lambda: optim.fused_adam_update(
            p_, g_, m_, v_, sc, **adam)),
        ("[50304,2048] f32", lambda: optim.fused_adam_update(
            p_, g_, m_, v_, sc, guard=True, **adam)),
        ("(a) [2,16,4096,128] bf16", lambda: bsa.bsa_fwd(
            sq, sk, sv, bsa.prepare_block_mask(bm, bq, bk))),
        ("[4,16,1024,1024] bf16", lambda: rnd.keep_mask(
            torch.zeros(2, dtype=torch.int64, device="cuda"), 0.9,
            (B, H, S, S), bf16)),
    ]
    booked = []
    for row, call in calls:
        trace = profile.trace_call(call)
        booked += [(row, c) for _path, c in trace.kernels]
    torch.cuda.synchronize()
    return booked


@contextlib.contextmanager
def _span_window():
    """A span recorder of its own that sees every span closed while this
    is open (a sink on the process's recorder), for :func:`profile.
    reconcile` to read the spans of one run alone."""
    from paddle_tpu_torch.observability import spans
    window = spans.SpanRecorder()
    sink = window.record
    spans.recorder().add_sink(sink)
    try:
        yield window
    finally:
        spans.recorder().remove_sink(sink)


def _innermost_kernel_ms(prof, paths):
    """{scope path: device ms} of a torch.profiler run: each event's
    kernels booked to its innermost enclosing record_function that is one
    of ``paths`` (the rest under "")."""
    out = {}
    for e in prof.events():
        kernels = getattr(e, "kernels", None) or []
        if not kernels:
            continue
        node, path = e, ""
        while node is not None:
            if node.name in paths:
                path = node.name
                break
            node = node.cpu_parent
        out[path] = out.get(path, 0.0) + sum(k.duration for k in kernels) / 1e3
    return out


def _profile_drive(cfg, model):
    """The roofline profiler on the card: every serving program of the
    1.3B engine, the depth-2 guarded train step (attributed >= 90 %),
    each kernel's booked cost against the kernel table's bound, the
    reports reconciled with their spans, and the prefill's five most
    costly layers predicted beside their kernel time in a profiled
    call."""
    from paddle_tpu_torch.framework.state import state_tensors
    from paddle_tpu_torch.observability import profile
    eng = _serving_engine(model)
    t0 = time.perf_counter()
    reports = profile.profile_engine(eng)
    walk_s = time.perf_counter() - t0
    names = sorted(reports)
    want = sorted([f"prefill_{b}" for b in eng.config.prefill_buckets]
                  + ["decode", "sample_1", "sample_8"])
    if names != want:
        raise AssertionError(f"profile_engine: {names}")
    card = card_line()
    for name in ("prefill_1024", "prefill_64", "decode", "sample_8"):
        r = reports[name]
        print(f"[profile] {card}: {name}: {r.total_flops / 1e9:.3f} GFLOP, "
              f"{r.total_bytes / 1e9:.4f} GB, attributed bytes "
              f"{100 * r.frac_attributed_bytes:.2f} % flops "
              f"{100 * r.frac_attributed_flops:.2f} %, predicted "
              f"{r.predicted_ms:.4f} ms, floor {r.floor_ms:.4f} ms, top "
              f"layer {r.top_layer}, {len(r.kernels or [])} kernel launches")
    # the floor against this engine's own decode replays: phase 4's
    # requests served after its boot, the spans of that run alone
    eng.warmup()
    with _span_window() as window:
        eng.generate(*_serving_requests(cfg.vocab_size))
        torch.cuda.synchronize()
    dec = profile.reconcile(reports["decode"], "serving.decode",
                            recorder=window)
    if dec.measured_ms is None:
        raise AssertionError("no serving.decode span to reconcile with")
    print(f"[profile] {card}: decode floor {dec.floor_ms:.4f} ms against "
          f"this engine's decode replays ({dec.measured_source}): "
          f"{dec.measured_ms:.4f} ms ({dec.floor_ms / dec.measured_ms:.3f} "
          f"of it); walked the ten programs in {walk_s:.1f} s")
    # the prefill at its largest bucket, eager under torch.profiler: its
    # kernels grouped by the module scopes' record_function paths
    prefill = reports["prefill_1024"]
    fn, example = eng.audit_programs()["prefill_1024"]
    with torch.no_grad(), profile.module_scopes():
        fn(*example)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn(*example)
            torch.cuda.synchronize()
    measured = _innermost_kernel_ms(prof, {l.name for l in prefill.layers})
    top = sorted(prefill.layers, key=lambda l: -l.floor_ms)[:PROFILE_TOP]
    rows = [{"layer": l.name, "predicted_ms": round(l.floor_ms, 5),
             "measured_kernel_ms": round(measured.get(l.name, 0.0), 5)}
            for l in top]
    kinds = {}
    for l in prefill.layers:
        kind = "/".join(p for p in l.name.split("/")
                        if not p.startswith("gptdecoderlayer_"))
        agg = kinds.setdefault(kind, [0.0, 0.0])
        agg[0] += l.floor_ms
        agg[1] += measured.get(l.name, 0.0)
    kinds = {k: [round(a, 4), round(b, 4)] for k, (a, b) in sorted(
        kinds.items(), key=lambda kv: -kv[1][1])}
    print(f"[profile] {card}: prefill_1024's {PROFILE_TOP} most costly "
          f"layers, floor beside kernel time: {json.dumps(rows)}; by kind "
          f"over the 24 layers, [floor ms, kernel ms]: {json.dumps(kinds)};"
          f" kernel ms outside every layer {measured.get('', 0.0):.4f}, in "
          f"all {sum(measured.values()):.4f}")
    if not all(r["measured_kernel_ms"] > 0 for r in rows):
        raise AssertionError(f"a layer without kernel time: {rows}")
    del reports, fn, example, prof
    eng.shutdown()
    gc.collect()
    # the depth-2 guarded step: one captured call, then a profile
    pcfg, pmodel, opt, step_fn = _obs_model()
    batch = _batch(pcfg.vocab_size, 6000)
    _captured(step_fn, batch)
    before = [t.detach().clone() for t in state_tensors()]
    t0 = time.perf_counter()
    rep = profile.profile_static_function(step_fn, *batch, include_xla=True)
    torch.cuda.synchronize()
    step_walk_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(before, state_tensors()))
    with _span_window() as window:           # replays of the step alone
        for _ in range(PROFILE_REPLAYS):
            _captured(step_fn, batch)
    profile.reconcile(rep, "jit.train_step", recorder=window)
    kernels = {}
    for row in rep.kernels:
        kernels[row["kernel"]] = kernels.get(row["kernel"], 0) + 1
    print(f"[profile] {card}: depth-2 guarded step: attributed bytes "
          f"{100 * rep.frac_attributed_bytes:.2f} % flops "
          f"{100 * rep.frac_attributed_flops:.2f} %, "
          f"{rep.total_flops / 1e12:.3f} TFLOP against FlopCounterMode's "
          f"{rep.xla['flops'] / 1e12:.3f}, {rep.total_bytes / 1e9:.2f} GB, "
          f"predicted {rep.predicted_ms:.3f} ms, floor {rep.floor_ms:.3f} "
          f"ms, a captured replay's span {rep.measured_ms:.3f} ms "
          f"({rep.measured_source}); "
          f"booked launches {kernels}; top layer {rep.top_layer}; state "
          f"unchanged {same}; walked in {step_walk_s:.1f} s")
    if rep.frac_attributed_bytes < 0.90 or rep.frac_attributed_flops < 0.90 \
            or not same:
        raise AssertionError(f"depth-2 profile: {rep.to_dict()['layers']}")
    del pmodel, opt, step_fn, before
    gc.collect()
    booked = _table_launches(torch.Generator(device="cuda").manual_seed(21))
    got = {(c.name, row): round(c.bound_ms(), 5) for row, c in booked}
    print(f"[profile] {card}: booked bounds at the kernel table's shapes: "
          f"{json.dumps({f'{k[0]} {k[1]}': v for k, v in got.items()})}")
    if got != TABLE_BOUNDS:
        raise AssertionError(f"booked bounds differ from the table: "
                             f"{got} != {TABLE_BOUNDS}")
    return {"decode_floor_ms": dec.floor_ms, "decode_replay_span_ms":
            dec.measured_ms, "prefill_top": rows, "prefill_kinds": kinds,
            "step_attributed": [rep.frac_attributed_bytes,
                                rep.frac_attributed_flops],
            "step_floor_ms": rep.floor_ms, "step_replay_span_ms":
            rep.measured_ms}


def _pool_rows(pools, table, positions, page):
    """[layers, positions, heads, d] of each layer's pool at
    ``positions`` through the row ``table``."""
    pages = table[positions // page]
    return torch.stack([p[pages, :, positions % page, :] for p in pools])


def _max_diff(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def drift_probe(cfg, model, prompt):
    """Where a replayed request first drifts on the card: one greedy
    request, A decoded ``DRIFT_STEPS`` steps after its prefill, and B its
    replay (one prefill of the prompt and A's tokens, as after an
    eviction or an adoption), both through the engine's uncaptured
    programs on pools of their own. Compares their K/V pages layer by
    layer, layer 0's operations on the rows both computed (ln1, the qkv
    GEMM, attention, the output projection), each of those operations
    alone on one input at the two paths' shapes, and the logits at the
    first token where the two paths part. Returns the findings."""
    from paddle_tpu_torch.incubate.nn.paged_attention import \
        paged_decode_step
    from paddle_tpu_torch.serving.engine import _dense_causal_attention
    eng = _serving_engine(model)
    ec = eng.config
    page, nb = ec.page_size, ec.max_num_seqs
    L = len(prompt)
    total = L + DRIFT_STEPS + 1 + DRIFT_FOLLOW
    table = torch.zeros(ec.max_pages_per_seq, dtype=torch.int64,
                        device="cuda")
    n_pages = -(-total // page)
    table[:n_pages] = torch.arange(1, n_pages + 1)
    layer0 = model.gpt.layers[0]
    seen = {}

    def hook(name):
        def fn(_m, inputs, output):
            seen.setdefault(name, []).append(
                (inputs[0].detach().clone(), output.detach().clone()))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in (
        ("ln1", layer0.ln1), ("qkv", layer0.attn.qkv_proj),
        ("out_proj", layer0.attn.out_proj), ("fc1", layer0.mlp.fc1))]

    def pools():
        return ([torch.zeros_like(p) for p in eng._k_pools],
                [torch.zeros_like(p) for p in eng._v_pools])

    def prefill(pl, tokens):
        bucket = eng.scheduler.bucket_for_len(len(tokens))
        fn, _ = eng._prefill_program(bucket, pools=pl)
        ids = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
        ids[0, :len(tokens)] = torch.tensor(tokens)
        pos = torch.arange(bucket, device="cuda")[None]
        return fn(table[None], ids, pos, torch.tensor([len(tokens)],
                                                      device="cuda"))[0]

    def decoder(pl):
        fn, _ = eng._decode_program(pools=pl)
        tables = torch.zeros(nb, ec.max_pages_per_seq, dtype=torch.int64,
                             device="cuda")
        tables[0] = table

        def step(length, token):
            lens = torch.zeros(nb, dtype=torch.int64, device="cuda")
            lens[0] = length
            toks = torch.zeros(nb, 1, dtype=torch.int64, device="cuda")
            toks[0, 0] = token
            return fn(tables, lens, toks)[0]
        return step

    with torch.no_grad():
        pa = pools()
        tokens = [int(prefill(pa, prompt).argmax())]
        step_a = decoder(pa)
        for i in range(DRIFT_STEPS):
            tokens.append(int(step_a(L + i, tokens[-1]).argmax()))
        marks = {n: len(v) for n, v in seen.items()}
        logits_a = [step_a(L + DRIFT_STEPS, tokens[-1])]
        pb = pools()
        logits_b = [prefill(pb, prompt + tokens)]
        positions = torch.arange(L + DRIFT_STEPS + 1, device="cuda")
        kv = {}
        for name, (a, b) in (("k", (pa[0], pb[0])), ("v", (pa[1], pb[1]))):
            ra, rb = (_pool_rows(p, table, positions, page) for p in (a, b))
            diff = (ra.float() - rb.float()).abs()
            kv[name] = {
                "prompt_max": [round(float(d), 6) for d in
                               diff[:, :L].amax(dim=(1, 2, 3))],
                "decoded_max": [round(float(d), 6) for d in
                                diff[:, L:].amax(dim=(1, 2, 3))]}
        # layer 0 on the rows both paths computed: A's prefill (prompt
        # rows) and decode steps (row 0 of each batch) against B's prefill
        rep_b = {n: v[-1] for n, v in seen.items()}
        ops = {}
        # in layer 0's order: ln1's output, the qkv GEMM's, attention's
        # (out_proj's input), out_proj's, fc1's
        for label, n, side in (("ln1", "ln1", 1), ("qkv GEMM", "qkv", 1),
                               ("attention", "out_proj", 0),
                               ("out_proj GEMM", "out_proj", 1),
                               ("fc1 GEMM", "fc1", 1)):
            calls = seen[n][:marks[n] + 1]
            pre_a = calls[0][side][0, :L]
            dec_a = torch.stack([c[side][0, 0] for c in calls[1:]])
            out_b = rep_b[n][side][0]
            ops[label] = {"prompt_rows": _max_diff(pre_a, out_b[:L]),
                          "decoded_rows": _max_diff(
                              dec_a, out_b[L:L + dec_a.shape[0]])}
        # each operation alone, one input, the two paths' shapes
        x = rep_b["qkv"][0][0]                      # ln1's rows, B's
        w, bias = layer0.attn.qkv_proj.weight, layer0.attn.qkv_proj.bias
        whole = torch.nn.functional.linear(x, w.t(), bias)
        bucket_a = eng.scheduler.bucket_for_len(L)
        first = torch.nn.functional.linear(x[:bucket_a], w.t(), bias)
        row = torch.zeros(nb, x.shape[1], dtype=x.dtype, device="cuda")
        row[0] = x[L]
        one = torch.nn.functional.linear(row, w.t(), bias)[0]
        ln_x = rep_b["ln1"][0][0]
        ln_whole = layer0.ln1(ln_x)
        ln_row = torch.zeros(nb, ln_x.shape[1], dtype=ln_x.dtype,
                             device="cuda")
        ln_row[0] = ln_x[L]
        heads, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        qkv = whole[:L + DRIFT_STEPS + 1].reshape(1, -1, heads, 3 * d)
        q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
        dense = _dense_causal_attention(q, k, v)[0, :, -1]
        kp = torch.zeros_like(eng._k_pools[0])
        vp = torch.zeros_like(eng._v_pools[0])
        last = L + DRIFT_STEPS
        pages = table[torch.arange(last, device="cuda") // page]
        offs = torch.arange(last, device="cuda") % page
        kp[pages, :, offs] = k[0, :, :last].transpose(0, 1)
        vp[pages, :, offs] = v[0, :, :last].transpose(0, 1)
        tables = torch.zeros(nb, ec.max_pages_per_seq, dtype=torch.int64,
                             device="cuda")
        tables[0] = table
        lens = torch.zeros(nb, dtype=torch.int64, device="cuda")
        lens[0] = last
        qd, kd, vd = (torch.zeros(nb, heads, 1, d, dtype=t.dtype,
                                  device="cuda") for t in (q, k, v))
        qd[0], kd[0], vd[0] = q[0, :, last:last + 1], k[0, :, last:last + 1], \
            v[0, :, last:last + 1]
        paged = paged_decode_step(qd, kd, vd, kp, vp, tables, lens, page)[0]
        # the two paths' query scalings, the reference's both:
        # q / sqrt(d) rounded to q's type, and q * (1 / sqrt(d))
        q_last = q[0, :, last]
        dense_q = q_last / float(torch.tensor(d ** 0.5).to(q.dtype))
        paged_q = q_last * (1.0 / d ** 0.5)
        alone = {
            "query scaling, q * (1/sqrt d) vs q / sqrt(d)": _max_diff(
                paged_q, dense_q),
            "query scaling, elements that differ": int(
                (paged_q != dense_q).sum()),
            "qkv GEMM, M=bucket(L) vs M=bucket(L+g)": _max_diff(
                first[:L], whole[:L]),
            "qkv GEMM, M=8 vs M=bucket(L+g)": _max_diff(one, whole[L]),
            "ln1, 8 rows vs bucket rows": _max_diff(layer0.ln1(ln_row)[0],
                                                    ln_whole[L]),
            "attention, paged_attend vs _dense_causal_attention": _max_diff(
                paged[0, :, 0], dense)}
        # continue both paths until their tokens part
        step_b = decoder(pb)
        ta, tb = tokens + [int(logits_a[0].argmax())], \
            tokens + [int(logits_b[0].argmax())]
        part = None
        for i in range(DRIFT_FOLLOW):
            if ta[-1] != tb[-1]:
                part = len(ta) - 1
                break
            n = L + len(ta) - 1
            logits_a.append(step_a(n, ta[-1]))
            logits_b.append(step_b(n, tb[-1]))
            ta.append(int(logits_a[-1].argmax()))
            tb.append(int(logits_b[-1].argmax()))
        if part is None and ta[-1] != tb[-1]:
            part = len(ta) - 1
        la, lb = logits_a[-1].float(), logits_b[-1].float()
        margin = [float(t[0] - t[1]) for t in (la.topk(2).values,
                                                lb.topk(2).values)]
    for h in handles:
        h.remove()
    eng.shutdown()
    found = {"prompt_len": L, "decode_steps": DRIFT_STEPS, "kv": kv,
             "layer0_rows": ops, "alone": alone,
             "first_parting_token": part,
             "logits_max_diff_there": _max_diff(la, lb),
             "top2_margins_there": margin,
             "next_logits_max_diff": _max_diff(logits_a[0], logits_b[0])}
    print(f"[drift] {card_line()}: {json.dumps(found)}")
    if alone["ln1, 8 rows vs bucket rows"] != 0.0:
        raise AssertionError("the LayerNorm forward depends on its row "
                             "count (phase 3 holds it invariant)")
    return found


def phase_router_traffic(bf16_serving):
    """The router, the AOT program cache, the traffic harness and the
    roofline profiler over GPT-1.3B's serving cell, then the drift of a
    replayed request. Returns the router drive's launches."""
    cfg, model = _serving_model("router")
    single = bf16_serving["tokens"]
    from paddle_tpu_torch.serving.aot_cache import AOTProgramCache
    with tempfile.TemporaryDirectory() as tmp:
        cache = AOTProgramCache(tmp)
        launches, router = _router_drive(cfg, model, single, cache)
        router.update(_fresh_boot_check(cache, single))
        gc.collect()
        traffic = _traffic_drive(cfg, model, cache)
    gc.collect()
    torch.cuda.empty_cache()
    profiled = _profile_drive(cfg, model)
    gc.collect()
    torch.cuda.empty_cache()
    drift = drift_probe(cfg, model, _serving_requests(cfg.vocab_size)[0][0])
    print(f"[router and traffic] {card_line()}: " + json.dumps(
        {"router": router, "traffic": {k: v for k, v in traffic.items()
                                       if k != "autoscaler"},
         "profile": profiled, "drift_first_parting": drift[
             "first_parting_token"]}))
    return launches


# ------------------------------------------------- the serving fleet
FLEET_NODES = 5            # controller, 3 replicas, a spare
FLEET_KILL_RANK, FLEET_WEDGE_RANK, FLEET_SPARE_RANK = 2, 3, 4
FLEET_KILL_AT, FLEET_WEDGE_AT = 5, 7   # serving.fleet.step occurrences
FLEET_NEW_TOKENS = 64
DISAGG_LENS = (128, 384, 900)
DISAGG_NEW_TOKENS = 16
FLEET_ENV = {"PTPU_FLEET_TIMEOUT_S": "60", "PTPU_FLEET_KV_SLICE_S": "0.25",
             "PTPU_FLEET_HB_INTERVAL_S": "0.5",
             "PTPU_FLEET_RENDEZVOUS_TIMEOUT_S": "180",
             "TORCH_CPP_LOG_LEVEL": "ERROR"}
FLEET_DEADLINE_S = 480     # the whole multi-process drive


def _handoff_drive(model, prompts, sps, want, tag, **options):
    """Two engines in this process: all of ``prompts`` prefilled on one,
    each request exported with its pages after its first tokens, packed
    into the wire's blob, through a TCPStore on 127.0.0.1 and imported
    into the other, which decodes them to the end. Before the first
    decode there the decode graph is held bit-identical to its
    uncaptured program over the imported pages; the tokens must equal
    ``want`` (one engine's run), with no program built after the
    warm-ups. Returns the launches and the numbers."""
    from torch.distributed import TCPStore

    from paddle_tpu_torch.distributed.launch import StoreKVClient
    from paddle_tpu_torch.observability import recompile_log
    from paddle_tpu_torch.resilience import fleet
    from paddle_tpu_torch.serving.fleet import wire
    kv = StoreKVClient(TCPStore("127.0.0.1", 0, 1, True,
                                wait_for_workers=False))
    pre = _serving_engine(model, **options)
    dec = _serving_engine(model, **options)
    pre.warmup()
    dec.warmup()
    events = recompile_log().count
    torch.cuda.synchronize()
    reset_launches()
    rids = [pre.add_request(p, sp) for p, sp in zip(prompts, sps)]
    pre.step()                       # prefills all, one decode step
    splits = []
    moved = {}
    for i, rid in enumerate(rids):
        t = [time.perf_counter()]

        def lap():
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            return round((t[-1] - t[-2]) * 1e3, 3)

        state = pre.export_page_state(rid)
        ms = {"export": lap()}
        blob = wire.pack_state(state)
        ms["pack"] = lap()
        fleet.kv_set_bytes(kv, f"handoff/{i}", blob)
        ms["store_set"] = lap()
        got = fleet.kv_get_bytes(kv, f"handoff/{i}", 30.0)
        ms["store_get"] = lap()
        state = wire.unpack_state(got)
        ms["unpack"] = lap()
        moved[dec.import_page_state(state)] = i
        ms["import"] = lap()
        kv.key_value_delete(f"handoff/{i}")
        splits.append({"tokens": state["len"], "bytes": len(blob), **ms})
    err = decode_graph_vs_program(dec)
    tokens = [None] * len(prompts)
    while dec.has_unfinished():
        dec.step()
        for rid in list(dec.finished_requests):
            tokens[moved[rid]] = dec.finished_requests.pop(
                rid).output_token_ids
    torch.cuda.synchronize()
    launches = read_launches(f"fleet handoff ({tag})")
    # the graph check ran one replay and one uncaptured call
    forwards = sum(e.metrics.prefill_steps + e.metrics.decode_steps
                   for e in (pre, dec)) + 2
    built = (pre.metrics.compile_count, dec.metrics.compile_count,
             recompile_log().count - events)
    pre.shutdown()
    dec.shutdown()
    bound = pre.config.compile_bound
    n_layers = model.config.num_layers
    expect = {k: 0 for k in launches}
    expect.update(ln_fwd=forwards * (n_layers + 1),
                  ln_res_fwd=forwards * n_layers)
    print(f"[fleet] {card_line()}: handoff over {tag} pools, 8 requests "
          f"exported after their first 2 tokens: bytes, ms a request "
          f"(export, pack, store set, store get, unpack, import) "
          f"{json.dumps(splits)}; decode graph max abs err {err}; builds "
          f"after the warm-ups {built}; launches {launches}")
    for i, (a, b) in enumerate(zip(tokens, want)):
        if a != b:
            raise AssertionError(f"{tag} handoff: request {i} differs from "
                                 f"one engine's run at token "
                                 f"{_first_diff(a, b)}")
    if err != 0.0:
        raise AssertionError(f"{tag} handoff: the decode graph's logits "
                             f"over the imported pages differ from the "
                             f"uncaptured program's by {err}")
    if built != (bound, bound, 0):
        raise AssertionError(f"{tag} handoff built programs: {built}")
    if launches != expect:
        raise AssertionError(f"{tag} handoff launches {launches} != "
                             f"{expect}")
    return launches, splits


def _fleet_scenario(tmp, vocab):
    """The multi-process drive's scenario (``serving/fleet/worker.py``):
    GPT-1.3B bf16 from seed 0 in every process, the serving cell's
    engine, 9 requests of 64-900 tokens (64 new, odd ones sampled), 3
    for the disaggregated run, the two faults."""
    prompts = _prompts(15, vocab, n=9)
    sampling = [{"max_new_tokens": FLEET_NEW_TOKENS,
                 "temperature": 0.0 if i % 2 == 0 else 0.8,
                 "top_k": 0 if i % 2 == 0 else 50, "seed": 300 + i}
                for i in range(len(prompts))]
    rng = np.random.default_rng(16)
    dprompts = [rng.integers(1, vocab, n).tolist() for n in DISAGG_LENS]
    dsampling = [{"max_new_tokens": DISAGG_NEW_TOKENS,
                  "temperature": 0.8 if i == 1 else 0.0,
                  "top_k": 50 if i == 1 else 0, "seed": 400 + i}
                 for i in range(len(dprompts))]
    return {
        "seed": 0, "device": "cuda",
        "model": {"preset": "gpt3_1p3b", "kwargs": {"fused_ln": True},
                  "dtype": "bfloat16"},
        "engine": {"max_num_seqs": 8, "page_size": 16,
                   "max_model_len": 1024, "dtype": "bfloat16"},
        "cache_dir": str(tmp / "cache"), "out_dir": str(tmp / "out"),
        "controller_rank": 0, "worker_ranks": [1, 2, 3],
        "spare_ranks": [FLEET_SPARE_RANK],
        "prompts": prompts, "sampling": sampling,
        "disagg_prompts": dprompts, "disagg_sampling": dsampling,
        "faults": {
            str(FLEET_KILL_RANK): [{"site": "serving.fleet.step",
                                    "kind": "rank_kill",
                                    "at": FLEET_KILL_AT}],
            str(FLEET_WEDGE_RANK): [{"site": "serving.fleet.step",
                                     "kind": "wedge",
                                     "at": FLEET_WEDGE_AT}]},
        "serve_budget_s": 240.0, "finalize_s": 6.0}


def _proc_state(pid):
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


def _run_fleet(tmp, scenario):
    """Start the fleet's processes through the launcher, wait for the
    controller's result, SIGKILL the wedged (SIGSTOPped) rank, reap the
    rest; every child is killed in ``finally``. Returns the controller's
    result, each rank's exit code, the wedged rank's state before the
    kill and the wall seconds."""
    (tmp / "out").mkdir()
    (tmp / "cache").mkdir()
    (tmp / "spool").mkdir()
    path = tmp / "scenario.json"
    path.write_text(json.dumps(scenario))
    root = Path(__file__).resolve().parent
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, **FLEET_ENV, "PYTHONPATH": str(root),
           "PADDLE_LAUNCH_ID": "smokefleet",
           "PTPU_OBS_SPOOL_DIR": str(tmp / "spool")}
    worker = root / "paddle_tpu_torch" / "serving" / "fleet" / "worker.py"
    logs = {r: open(tmp / f"rank{r}.log", "w") for r in range(FLEET_NODES)}
    result_path = tmp / "out" / "controller.json"
    t0 = time.perf_counter()
    procs = {}
    try:
        for r in range(FLEET_NODES):
            procs[r] = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                 "--master", f"127.0.0.1:{port}", "--nnodes",
                 str(FLEET_NODES), "--rank", str(r), str(worker), str(path)],
                cwd=root, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        deadline = time.monotonic() + FLEET_DEADLINE_S
        while not result_path.exists():
            if procs[0].poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"the fleet's controller wrote no result (exit "
                    f"{procs[0].poll()}):\n" + _fleet_logs(tmp))
            time.sleep(0.2)
        wedged = (_proc_state(procs[FLEET_WEDGE_RANK].pid)
                  if procs[FLEET_WEDGE_RANK].poll() is None else None)
        if procs[FLEET_WEDGE_RANK].poll() is None:
            procs[FLEET_WEDGE_RANK].kill()
        codes = {}
        for r, p in procs.items():
            codes[r] = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        wall = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    return json.loads(result_path.read_text()), codes, wedged, wall


def _fleet_logs(tmp, tail=3000):
    """The end of every rank's log."""
    return "\n".join(f"--- rank {r} ---\n"
                     + (tmp / f"rank{r}.log").read_text()[-tail:]
                     for r in range(FLEET_NODES))


def _fleet_checks(res, codes, wedged, n_layers):
    """The drive's exact checks; returns the migrated requests' first
    differing positions."""
    bad = {r: c for r, c in codes.items()
           if c != (-9 if r in (FLEET_KILL_RANK, FLEET_WEDGE_RANK) else 0)}
    if bad or wedged != "T":
        raise AssertionError(f"fleet exit codes {codes} (the killed and "
                             f"wedged ranks -9, the rest 0), the wedged "
                             f"rank's state before its kill {wedged!r}")
    ref, got = res["ref"], res["fleet"]
    adopted = {}
    for rank, moves in res["adopted"].items():
        for prompt_index, n in moves:
            adopted.setdefault(prompt_index, []).append(n)
    parted = []
    for i, (want, r) in enumerate(zip(ref, got)):
        if r["tokens"] is None or len(r["tokens"]) != FLEET_NEW_TOKENS \
                or r["finish_reason"] != "length":
            raise AssertionError(f"fleet request {i} unfinished: {r}")
        if r["stream_tokens"] != r["tokens"] or r["stream_fins"] != 1:
            raise AssertionError(f"fleet request {i}: its stream is not "
                                 f"its tokens exactly once")
        d = _first_diff(r["tokens"], want["tokens"])
        if not r["migrations"]:
            if d is not None:
                raise AssertionError(f"fleet request {i} (never on a "
                                     f"faulted replica) differs from the "
                                     f"monolithic run at token {d}")
            continue
        first = min(adopted[i])
        if d is not None and d < first:
            raise AssertionError(f"fleet request {i} differs at token {d}, "
                                 f"before its migration at {first}")
        parted.append({"request": i, "migrated_with": adopted[i],
                       "first_differing_token": d})
    if not parted:
        raise AssertionError("no request migrated")
    dead = {int(r) for r in res["verdicts"]}
    dets = {d["rank"]: d for d in res["detections"]}
    if dead != {FLEET_KILL_RANK, FLEET_WEDGE_RANK} or set(dets) != dead \
            or any(d["verdict"] != "dead-verdict" for d in dets.values()):
        raise AssertionError(f"fleet verdicts {res['verdicts']}, "
                             f"detections {res['detections']}")
    boots = res["boots"]
    slot = [1, 2, 3].index(FLEET_KILL_RANK)
    if res["assigned"][str(slot)] != FLEET_SPARE_RANK or not (
            boots[slot]["warm"] and boots[slot]["compiled"] == 0
            and boots[slot]["cache_loads"] == 10):
        raise AssertionError(f"the respawn: assigned {res['assigned']}, "
                             f"boot {boots[slot]}")
    for rank, a in res["audits"].items():
        forwards = a["prefill_steps"] + a["decode_steps"] + a["boot_forwards"]
        want_ln = {"ln_fwd": forwards * (n_layers + 1),
                   "ln_res_fwd": forwards * n_layers}
        if "error" in a or a["compiled"] > 10 or a["ln_launches"] != want_ln:
            raise AssertionError(f"replica {rank}'s audit {a}, LN launches "
                                 f"for {forwards} forwards {want_ln}")
    if [d["tokens"] for d in res["disagg"]] != \
            [d["tokens"] for d in res["disagg_ref"]]:
        raise AssertionError(f"the disaggregated run differs from the "
                             f"monolithic one: {res['disagg']} "
                             f"{res['disagg_ref']}")
    for r in (FLEET_KILL_RANK, FLEET_WEDGE_RANK):
        pm = res["postmortems"].get(str(r))
        if not pm or not pm["in_flight_requests"]:
            raise AssertionError(f"no post-mortem naming rank {r}'s "
                                 f"requests: {res['postmortems']}")
    return parted


def phase_fleet(bf16_serving):
    """The multi-process serving fleet (needs phase 4's result): the page
    handoff in this process over bf16 and int8 pools, then the fleet of
    ``FLEET_NODES`` fresh processes through the port's launcher."""
    from paddle_tpu_torch.observability import fleettrace
    cfg, model = _serving_model("fleet")
    prompts, sps = _serving_requests(cfg.vocab_size)
    launches, bf16_splits = _handoff_drive(
        model, prompts, sps, bf16_serving["tokens"], "bf16")
    int8_want = _serve(model, prompts, sps, kv_cache_dtype="int8")[0]
    int8_launches, int8_splits = _handoff_drive(
        model, prompts, sps, int8_want, "int8", kv_cache_dtype="int8")
    for k, v in int8_launches.items():
        launches[k] += v
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        scenario = _fleet_scenario(tmp, cfg.vocab_size)
        res, codes, wedged, wall = _run_fleet(tmp, scenario)
        if any(c != (-9 if r in (FLEET_KILL_RANK, FLEET_WEDGE_RANK) else 0)
               for r, c in codes.items()):
            print(_fleet_logs(tmp))
        tel = fleettrace.merge_spools(str(tmp / "spool"))
        clocks = {p.rank: p.clock.get("offset_ns") for p in tel.processes}
        replicas = {}
        for r in range(1, FLEET_NODES):
            f = tmp / "out" / f"replica-rank{r}.json"
            replicas[r] = json.loads(f.read_text()) if f.exists() else None
    parted = _fleet_checks(res, codes, wedged, cfg.num_layers)
    if sorted(clocks) != list(range(FLEET_NODES)) or clocks[0] != 0 or \
            any(v is None for v in clocks.values()):
        raise AssertionError(f"the merged fleet trace's clocks {clocks}")
    for a in res["audits"].values():
        for k, v in a["ln_launches"].items():
            launches[k] += v
    peaks = {0: res.get("peak_reserved")}
    for r in range(1, FLEET_NODES):
        rep = replicas[r] or res["telemetry"].get(str(r)) or {}
        peaks[r] = rep.get("peak_reserved")
    handoff = [{**e, **h} for e, h in zip(
        res["exports"], res["audits"][str(res["disagg_ranks"][1])]
        ["handoffs"])]
    numbers = {
        "dead_after_s": res["dead_after_s"],
        "verdict_s_since_last_beat": {r: v["since_last_beat_s"]
                                      for r, v in res["verdicts"].items()},
        "rpc_abort_s": {d["rank"]: d["detect_s"]
                        for d in res["detections"]},
        "respawn_ms": res["respawn_ms"],
        "boot_ms_warm": [b["boot_ms"] for b in res["boots"]],
        "boot_ms_cold_reference": res["ref_boot"]["boot_ms"],
        "tokens_per_s": res["tokens_per_s"], "serve_s": res["serve_s"],
        "reference_serve_s": res["ref_serve_s"],
        "disagg_s": res["disagg_s"], "handoffs": handoff,
        "peak_reserved_gib": {r: None if v is None else v / 2**30
                              for r, v in peaks.items()},
        "wall_s": wall,
        "migrated": parted,
        "handoff_in_process_bf16": bf16_splits,
        "handoff_in_process_int8": int8_splits}
    print(f"[fleet] {card_line()}: {FLEET_NODES} processes, both faults "
          f"drew DEAD verdicts, the respawn booted warm on rank "
          f"{FLEET_SPARE_RANK}, every unmigrated request and the "
          f"disaggregated run equal the monolithic run; migrated requests "
          f"(tokens they brought, first differing token; a replayed "
          f"request may part from its decoded self on the card: the "
          f"reference's two query scalings, PERF.md §6): {parted}")
    print(f"[fleet] {card_line()}: " + json.dumps(numbers))
    return launches


# ------------------------------------------------------- mixture of experts
MOE = dict(moe_num_experts=8, moe_top_k=2, moe_every=2, moe_gate="gshard")
MOE_TRAIN_LAYERS = 12                # 2.12 B params: the f32 state fits
MOE_TRAIN_STEPS = 5
MOE_AUX = 0.01                       # examples/train_gpt_moe.py's weight


def _moe_cfg(**kw):
    """GPT-1.3B's widths with GShard's top-2 of 8 experts in every other
    block, at the repo's capacity (2.0, 2.0)."""
    from paddle_tpu_torch.models.gpt import gpt3_1p3b
    return gpt3_1p3b(fused_ln=True, **MOE, **kw)


def _moe_serving():
    """The 24-layer MoE GPT in bf16 serving phase 4's 8 requests as CUDA
    graphs: 10 programs, 64 tokens a request, finite logits, the
    LayerNorm launches of every forward, the decode graph bit-identical
    to its uncaptured program; continuous against sequential printed
    (capacity depends on the batch: at capacity x top_k 4 < 8 experts a
    token may be dropped). Returns the launches."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    cfg = _moe_cfg()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[moe serving] gpt3_1p3b(fused_ln=True, {MOE}): "
          f"{n_params / 1e9:.3f} B params in bf16, built in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts, sps = _serving_requests(cfg.vocab_size)
    eng = _serving_engine(model)
    bound = eng.config.compile_bound
    boot = eng.warmup()
    if not boot["programs"] == boot["compiled"] == bound == 10:
        raise AssertionError(f"warmup built {boot}, bound {bound}")
    finite = []
    originals = _watch_finite(eng, finite)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = eng.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("moe serving")
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    m = eng.metrics
    if m.compile_count != bound:
        raise AssertionError(f"generate captured {m.compile_count - bound} "
                             f"more programs")
    forwards = m.prefill_steps + m.decode_steps
    expect = {k: 0 for k in launches}
    expect.update(ln_fwd=forwards * (cfg.num_layers + 1),
                  ln_res_fwd=forwards * cfg.num_layers)
    print(f"[moe serving] {m.prefill_steps} prefills + {m.decode_steps} "
          f"decode steps, all graph replays; launches {launches}")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")
    if len(finite) != forwards or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits (or a forward not seen)")
    if any(len(r.output_token_ids) != 64 for r in results):
        raise AssertionError("a request without 64 tokens")
    eng._programs.update(originals)
    eng.shutdown()
    tokens = [r.output_token_ids for r in results]
    seq = _serving_engine(model)
    alone = [seq.generate([p], [sp])[0].output_token_ids
             for p, sp in zip(prompts, sps)]
    seq.shutdown()
    same = [a == b for a, b in zip(alone, tokens)]
    parts = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
             for a, b in zip(alone, tokens)]
    print(f"[moe serving] sequential == continuous for {sum(same)} of 8 "
          f"requests (not asserted: a prefill routes its padded bucket, a "
          f"decode all 8 rows, so capacity and drops depend on the batch); "
          f"first differing token {parts}")
    err = check_decode_graph(_serving_engine(model), prompts, sps,
                             exact=True)
    snap = m.snapshot()
    print(f"[moe serving] {card_line()}: {m.generated_tokens / wall:.1f} "
          f"tokens/s ({m.generated_tokens} tokens in {wall:.2f} s), mean "
          f"decode step {snap['decode_step_ms']['mean']:.2f} ms, mean "
          f"prefill {snap['prefill_step_ms']['mean']:.2f} ms, TTFT p50 "
          f"{snap['ttft_ms']['p50']:.1f} ms p99 {snap['ttft_ms']['p99']:.1f}"
          f" ms, boot {boot['boot_ms']:.1f} ms, peak {peak[0] / 2**30:.2f} "
          f"GiB allocated / {peak[1] / 2**30:.2f} reserved; decode graph "
          f"vs program max abs err {err}")
    return launches


def _moe_train_step(model, opt, guard):
    """The MoE train step: the criterion plus 0.01 x the gates' balance
    losses (``examples/train_gpt_moe.py``), under
    ``to_static(amp_policy="bf16")``; returns ``[loss, aux]``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    crit = GPTPretrainingCriterion()

    @pt.jit.to_static(amp_policy="bf16", guard=guard)
    def train_step(ids, labels):
        opt.clear_grad()
        loss = crit(model(ids), labels)
        aux = model.gpt.moe_aux_loss()
        total = loss + MOE_AUX * aux
        total.backward()
        opt.step()
        return torch.stack([total.detach(), aux.detach()])

    return train_step


def _moe_step_launches(cfg, steps, guard):
    """Each kernel's launches over ``steps`` MoE train steps: the dense
    path's call sites, one fused guarded update of each rank-2 parameter
    (qkv and out_proj a block, then fc1 and fc2, or the router and the
    experts' stacked biases b1 and b2; the two embeddings) with its sums
    of squares (the rank-3 expert weights take the per-parameter loop),
    and one keep-mask launch a MoE block (the random routing's draw
    splits the key)."""
    n = cfg.num_layers
    moe = sum((i + 1) % cfg.moe_every == 0 for i in range(n))
    rank2 = 4 * (n - moe) + 5 * moe + 2
    per_step = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                "ln_fwd": n + 1, "ln_res_fwd": n, "ln_bwd": n + 1,
                "ln_bwd_res": n, "adam_update": 0,
                "adam_update_guard": rank2 if guard else 0,
                "adam_guard_sumsq": rank2 if guard else 0,
                "rms_fwd": 0, "bsa_fwd": 0, "keep_mask": moe}
    return {k: steps * v for k, v in per_step.items()}


def _moe_split(step_fn, batch, cfg):
    """Where a MoE step's kernel time goes: one eager step under
    ``torch.profiler`` with input shapes, each operator's own kernel time
    booked to the experts (rank-3 operands of E experts over C, d and h),
    the routing, dispatch and combine (an operand holding E x C, or one
    of the routing tensors [n, E], [n, K], [n, K, E], [n, E, C], [n, K, E,
    C]) or the rest. Returns the three ms."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.moe import _capacity
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    n, e, k = B * S, cfg.moe_num_experts, cfg.moe_top_k
    c = _capacity(n, e, k, cfg.moe_capacity_factor[0])
    d, h = cfg.hidden_size, cfg.ffn_hidden_size
    routing = {(n, k, e, c), (n, e, c), (n, k, e), (n, e), (n, k)}
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        with pt.amp.activation_residency("bf16"):
            step_fn.dygraph_function(*batch)
        torch.cuda.synchronize()
    split = {"experts": 0.0, "routing, dispatch and combine": 0.0,
             "rest": 0.0}
    for ev in prof.key_averages(group_by_input_shape=True):
        # the operators' rows: a kernel's own row repeats its time
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        us = ev.self_device_time_total
        if not us:
            continue
        shapes = [tuple(s) for s in (ev.input_shapes or []) if s]
        if any(e * c in s or s in routing for s in shapes):
            split["routing, dispatch and combine"] += us / 1e3
        elif any(len(s) == 3 and s[0] == e and set(s[1:]) <= {c, d, h, 1}
                 for s in shapes):
            split["experts"] += us / 1e3
        else:
            split["rest"] += us / 1e3
    return split


def _moe_train(guard):
    """The MoE GPT at ``MOE_TRAIN_LAYERS``, full width, 4 x 1024 tokens,
    dropout 0 (flash on the path): an eager twin through
    ``dygraph_function`` first, then the captured run from the same
    weights and seed, equal bit for bit (losses, aux losses, weights);
    losses falling, aux losses finite and positive, launches exact."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    tag = "moe train, guarded fused" if guard else "moe train, unfused"
    cfg = _moe_cfg(num_layers=MOE_TRAIN_LAYERS, dropout=0.0,
                   attention_dropout=0.0)

    def build():
        model = GPTForCausalLM(
            cfg, device="cuda",
            generator=torch.Generator("cuda").manual_seed(0))
        model.train()
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 fused=guard, guard=guard)
        return model, opt, _moe_train_step(model, opt, guard)

    ids, labels = _batch(cfg.vocab_size, 1)
    twin, twin_opt, eager_step = build()
    n_params = sum(p.numel() for p in twin.parameters())
    pt.seed(SEED)
    reset_launches()
    eager = []
    for _ in range(MOE_TRAIN_STEPS):
        with pt.amp.activation_residency("bf16"):
            eager.append(eager_step.dygraph_function(ids, labels).tolist())
    eager_launches = read_launches(f"{tag}, dygraph_function")
    if eager_launches != _moe_step_launches(cfg, MOE_TRAIN_STEPS, guard):
        raise AssertionError(f"dygraph launches {eager_launches}")
    eager_weights = [p.detach().cpu() for p in twin.parameters()]
    # one more eager step of the twin, profiled: it runs before any
    # capture holds its own pool on the card
    split = _moe_split(eager_step, (ids, labels), cfg) if guard else None
    del twin, twin_opt, eager_step
    gc.collect()
    torch.cuda.empty_cache()

    model, opt, step_fn = build()
    pt.seed(SEED)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, step_s = [], []
    for i in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        out.append(step_fn(ids, labels).tolist())         # synchronises
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            first = (torch.cuda.max_memory_allocated(),
                     torch.cuda.max_memory_reserved())
            torch.cuda.reset_peak_memory_stats()
    launches = read_launches(tag)
    expect = _moe_step_launches(cfg, MOE_TRAIN_STEPS + WARMUP_CALLS, guard)
    losses, aux = [o[0] for o in out], [o[1] for o in out]
    print(f"[{tag}] {MOE_TRAIN_LAYERS} layers, {n_params / 1e9:.3f} B f32 "
          f"params; losses {losses}; aux losses {aux}; launches {launches}")
    if launches != expect:
        raise AssertionError(f"launches {launches} != {expect}")
    if len(step_fn._compiled) != 1:
        raise AssertionError(f"{len(step_fn._compiled)} captures")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if not all(math.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"aux losses not finite and positive: {aux}")
    differ = [n for (n, a), b in zip(model.named_parameters(), eager_weights)
              if not torch.equal(a.cpu(), b)]
    if eager != out or differ:
        raise AssertionError(f"captured and eager runs differ: {out} / "
                             f"{eager}, weights {differ}")
    del eager_weights
    steady = statistics.median(step_s[1:])
    gib = 2 ** 30
    print(f"[{tag}] {card_line()}: captured == eager bit for bit (losses, "
          f"aux losses, {len(list(model.parameters()))} weights); step "
          f"{steady * 1e3:.1f} ms (median of steps 2-{MOE_TRAIN_STEPS}), "
          f"{B * S / steady:.0f} tokens/s; first call {step_s[0] * 1e3:.1f}"
          f" ms, peak {first[0] / gib:.2f} GiB allocated / "
          f"{first[1] / gib:.2f} reserved; steady peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} / "
          f"{torch.cuda.max_memory_reserved() / gib:.2f} GiB")
    if guard:
        profile_train_step(step_fn, (ids, labels), steady, tag=tag)
        print(f"[{tag}] an eager step's kernel time by part: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in split.items())
            + f" ({sum(split.values()):.1f} ms in all)")
    return launches


def phase_moe():
    """GPT-1.3B's widths with 8 GShard experts in every other block:
    served at 24 layers in bf16, trained at ``MOE_TRAIN_LAYERS`` with the
    guarded fused and the unfused AdamW."""
    launches = _moe_serving()
    gc.collect()
    torch.cuda.empty_cache()
    for guard in (True, False):
        for k, v in _moe_train(guard).items():
            launches[k] += v
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ eager collectives
COLL_ENV = {"PTPU_FLEET_TIMEOUT_S": "60", "PTPU_FLEET_KV_SLICE_S": "0.25",
            "PTPU_FLEET_HB_INTERVAL_S": "0.5",
            "PTPU_FLEET_RENDEZVOUS_TIMEOUT_S": "60",
            "TORCH_CPP_LOG_LEVEL": "ERROR"}
COLL_KILL_RANK, COLL_KILL_STEP, COLL_CKPT_STEP, COLL_STEPS = 2, 8, 5, 12
COLL_DEADLINE_S = 240


def _run_workers(tmp, nnodes, mode, launch_id):
    """``nnodes`` processes of ``tests/_torch_fleet_worker.py`` through
    the launcher, tensors on the card; every child killed in
    ``finally``. Returns each rank's exit code and the wall seconds."""
    root = Path(__file__).resolve().parent
    worker = root / "tests" / "_torch_fleet_worker.py"
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, **COLL_ENV, "PYTHONPATH": str(root),
           "PADDLE_LAUNCH_ID": launch_id}
    args = [str(tmp / "out"), "cuda", mode, str(tmp / "ckpt"),
            *map(str, (COLL_KILL_RANK, COLL_KILL_STEP, COLL_CKPT_STEP,
                       COLL_STEPS))]
    logs = {r: open(tmp / f"{mode}-rank{r}.log", "w") for r in range(nnodes)}
    procs = {}
    t0 = time.perf_counter()
    try:
        for r in range(nnodes):
            procs[r] = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                 "--master", f"127.0.0.1:{port}", "--nnodes", str(nnodes),
                 "--rank", str(r), str(worker), *args], cwd=root, env=env,
                stdout=logs[r], stderr=subprocess.STDOUT)
        deadline = time.monotonic() + COLL_DEADLINE_S
        codes = {r: p.wait(timeout=max(1.0, deadline - time.monotonic()))
                 for r, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    return codes, time.perf_counter() - t0


def phase_collectives():
    """The eager collectives over the fleet's store with the training
    chaos proof: 3 launcher processes, one AVG all_reduce of [loss, grad]
    a step with its tensor on the card, a quorum checkpoint after step
    5, rank 2 SIGKILLed at step 8; the survivors name it, reconfigure to
    2, reload resharded and resume; then the fault-free 2-rank baseline
    from the same checkpoint. The resumed losses equal it exactly."""
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        (tmp / "out").mkdir()
        runs = {}
        for nnodes, mode in ((3, "chaos"), (2, "baseline")):
            codes, wall = _run_workers(tmp, nnodes, mode, f"smoke{mode}")
            want = {r: -9 if mode == "chaos" and r == COLL_KILL_RANK else 0
                    for r in range(nnodes)}
            logs = "\n".join(
                f"--- {f.name} ---\n{f.read_text()[-3000:]}"
                for f in sorted(tmp.glob(f"{mode}-rank*.log")))
            if codes != want:
                raise AssertionError(f"{mode}: exit codes {codes} != {want}"
                                     f"\n{logs}")
            runs[mode] = ({r: json.loads((tmp / "out" /
                                          f"{mode}-rank{r}.json").read_text())
                           for r in range(nnodes) if want[r] == 0}, wall)
    chaos, chaos_s = runs["chaos"]
    base, base_s = runs["baseline"]
    for r, res in chaos.items():
        det = res["detection"]
        if det is None or det["missing_rank"] != COLL_KILL_RANK:
            raise AssertionError(f"rank {r} did not name the dead rank: "
                                 f"{det}")
        nw = res["new_world"]
        if nw["members"] != [0, 1] or not res["reshard_ok"]:
            raise AssertionError(f"rank {r}: world {nw}, reshard "
                                 f"{res['reshard_ok']}")
    resumed = [chaos[r]["losses_resumed"] for r in (0, 1)]
    baseline = [base[r]["losses_resumed"] for r in (0, 1)]
    if len(resumed[0]) != COLL_STEPS - COLL_CKPT_STEP or \
            not resumed[0] == resumed[1] == baseline[0] == baseline[1]:
        raise AssertionError(f"resumed {resumed} != baseline {baseline}")
    ms = [t for res in (*chaos.values(), *base.values())
          for t in res["allreduce_ms"]]
    numbers = {
        "allreduce_ms_median": statistics.median(ms),
        "allreduce_ms_p90": sorted(ms)[int(0.9 * (len(ms) - 1))],
        "dead_after_s": chaos[0]["dead_after_s"],
        "verdict_s_since_last_beat": {r: res.get("verdict_s")
                                      for r, res in chaos.items()},
        "detection": {r: res["detection"] for r, res in chaos.items()},
        "reconfigure_s": {r: res["reconfigure_s"]
                          for r, res in chaos.items()},
        "recovery_s": {r: res["recovery_s"] for r, res in chaos.items()},
        "chaos_wall_s": chaos_s, "baseline_wall_s": base_s}
    print(f"[collectives] {card_line()}: rank {COLL_KILL_RANK} named DEAD "
          f"by both survivors, the resumed losses equal the 2-rank "
          f"baseline's exactly: {resumed[0]}")
    print(f"[collectives] {card_line()}: " + json.dumps(numbers))


# ------------------------------------------------ the headline trainers
ENC_B, ENC_S = 16, 512               # bench.py's BERT / ERNIE MLM batch
RESNET_B, RESNET_SIDE = 256, 224     # bench.py's ResNet-50 batch
VIT_B, VIT_TOKENS = 128, 197         # tools/profile_vit.py's; 14^2 + 1
HEADLINE_STEPS = 4
# the flash kernels at head_dim 64: BERT's and ViT-B/16's attention
FLASH64 = {"bert": (ENC_B, ENC_S, 12, 64), "vit": (VIT_B, VIT_TOKENS, 12, 64),
           "transformer": (16, 256, 8, 64)}
FLASH64_CASES = [(False, dict(b=ENC_B, sq=ENC_S, sk=ENC_S, h=12, d=64)),
                 (False, dict(b=VIT_B, sq=VIT_TOKENS, sk=VIT_TOKENS, h=12,
                              d=64)),
                 (True, dict(b=4, sq=1024, sk=1024, h=16, d=64)),
                 # Transformer-base: its attention, cross-attention
                 # between lengths that differ, and the decode's one
                 # query row against a cache and the 256-token memory
                 (False, dict(b=16, sq=256, sk=256, h=8, d=64)),
                 (False, dict(b=2, sq=200, sk=328, h=8, d=64)),
                 (False, dict(b=2, sq=328, sk=200, h=8, d=64)),
                 (True, dict(b=2, sq=200, sk=328, h=8, d=64)),
                 (True, dict(b=2, sq=328, sk=200, h=8, d=64)),
                 (False, dict(b=16, sq=1, sk=256, h=8, d=64)),
                 (False, dict(b=16, sq=1, sk=255, h=8, d=64)),
                 # the cached decode's first self-attention: one key
                 (False, dict(b=16, sq=1, sk=1, h=8, d=64))]


def phase_flash64():
    """The flash kernels' head_dim-64 instances: each kernel against its
    plain version, f32 and bf16, at BERT's shape ([16, 512, 12, 64]),
    ViT-B/16's ragged one ([128, 197, 12, 64]: TMA fills the rows past
    197 with zeros), a causal [4, 1024, 16, 64], Transformer-base's
    [16, 256, 8, 64], sq != sk both ways (200 / 328, causal and not) and
    one query row against 256, 255 and 1 keys (the decode); then their
    bf16 times at BERT's, ViT's and Transformer-base's shapes beside
    bound, plain version and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(64)
    err = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        check_flash_cases(err, gen, dtype, FLASH64_CASES)
    print(f"[flash64] head_dim 64 agrees with the plain versions; max abs "
          f"err {err}; largest share of its limit "
          f"{shares('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')}")
    timings = {}
    for tag, shape in FLASH64.items():
        timings[tag] = time_flash(gen, shape, False)[0]
        for key, v in timings[tag].items():
            print(f"[flash64] {tag} {key}: " + ", ".join(
                f"{k} {x:.5f}" if isinstance(x, float) else f"{k} {x}"
                for k, x in v.items()))
    return err, timings


def _state_tensors(model, opt=None):
    """A train path's state by name: the model's and, given its
    optimizer, each accumulator (the Adam moments and beta powers), the
    lr tensor and the global key."""
    from paddle_tpu_torch.framework.state import key_tensor
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if opt is not None:
        state.update({f"opt:{k}": v.detach().clone()
                      for k, v in opt.state_dict().items()
                      if isinstance(v, torch.Tensor)})
        state["opt:lr"] = opt._lr_tensor.detach().clone()
        state["rng:key"] = key_tensor().detach().clone()
    return state


def _headline_path(tag, build, batch, per_step, items, unit, falling=True):
    """One trainer through its reference step (``build()`` gives the
    model and its ``to_static`` step, from seed 0, and may add its
    optimizer and a callable run after each step, untimed: a scheduler's
    step): ``HEADLINE_STEPS`` steps of a twin through
    ``dygraph_function`` (eagerly), then of a fresh build captured, which
    must equal the eager run bit for bit, its losses and every state
    tensor (the weights and any BatchNorm statistics; given the
    optimizer, its accumulators, the lr and the global key too); losses
    finite, and with ``falling`` the last below the first; the kernels'
    launches exactly ``per_step`` a step (the captured run counts its
    first call's warm-ups too) and nothing routed to a composition.
    Prints the step's time, ``items`` / step in ``unit`` a second, the
    first call's time and peaks, and one replay's kernels by time
    (``profile_train_step``). Returns (launches, numbers, model)."""
    from paddle_tpu_torch.core.cuda_graph import WARMUP_CALLS
    t0 = time.perf_counter()
    twin, step, *more = build()
    opt, after = more or (None, None)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in twin.parameters())
    print(f"[{tag}] {n_params / 1e6:.1f} M f32 params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    expect = dict.fromkeys(_launches(), 0)
    expect.update(per_step)
    reset_launches()
    eager = []
    for _ in range(HEADLINE_STEPS):
        eager.append(step.dygraph_function(*batch).item())
        if after is not None:
            after()
    got = read_launches(f"{tag}, dygraph_function")
    if got != {k: HEADLINE_STEPS * v for k, v in expect.items()}:
        raise AssertionError(f"{tag} dygraph launches {got}")
    eager_state = _state_tensors(twin, opt)
    del twin, step, opt, after, more
    gc.collect()
    torch.cuda.empty_cache()

    model, step, *more = build()
    opt, after = more or (None, None)
    reset_launches()
    losses, step_s, first = captured_run(step, [batch] * HEADLINE_STEPS,
                                         after)
    launches = read_launches(tag)
    want = {k: (HEADLINE_STEPS + WARMUP_CALLS) * v for k, v in expect.items()}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches} != {want}")
    if len(step._compiled) != 1:
        raise AssertionError(f"{tag}: {len(step._compiled)} captures")
    if not all(math.isfinite(x) for x in losses) or \
            (falling and not losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: losses not finite (or not falling): "
                             f"{losses}")
    state = _state_tensors(model, opt)
    differ = [k for k, v in state.items()
              if v.shape != eager_state[k].shape
              or not torch.equal(v, eager_state[k])]
    stats = sum(k.endswith(("_mean", "_variance")) for k in state)
    if eager != losses or differ or set(state) != set(eager_state):
        raise AssertionError(f"{tag}: captured and eager runs differ: losses "
                             f"{losses} / {eager}, state {differ[:8]}")
    steady = statistics.median(step_s[1:])
    print(f"[{tag}] losses {losses}: the captured run equals the eager one "
          f"bit for bit, losses and all {len(state)} state tensors ({stats} "
          f"BatchNorm statistics); launches a step {per_step}")
    print(f"[{tag}] {card_line()}: step {steady * 1e3:.2f} ms (median of "
          f"steps 2-{HEADLINE_STEPS}), {items / steady:.1f} {unit}/s; "
          f"{first}")
    profile_train_step(step, batch, steady, tag)
    return launches, {"step_ms": steady * 1e3, f"{unit}_per_s": items / steady,
                      "first_ms": step_s[0] * 1e3}, model


def _mlm_build(kind):
    """``bench.py:_bench_ernie`` / ``_bench_bert``: ERNIE-3.0-base or
    BERT-base at dropout 0, ``AdamW(1e-4)``, the masked-LM step under
    ``to_static`` and ``auto_cast(level="O1", dtype="bfloat16")``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator("cuda").manual_seed(0)
    if kind == "ernie":
        cfg = models.ernie_3_0_base(dropout=0.0, attention_dropout=0.0)
        model = models.ErnieForPretraining(cfg, generator=gen)
    else:
        cfg = models.BertConfig(dropout=0.0, attention_dropout=0.0)
        model = models.BertForPretraining(cfg, generator=gen)
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    vocab = cfg.vocab_size

    @pt.jit.to_static
    def train_step(ids, task_ids, labels):
        opt.clear_grad()
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            if kind == "ernie":
                pred = model(ids, task_type_ids=task_ids)
            else:
                pred, _ = model(ids)
        loss = F.cross_entropy(pred.reshape([-1, vocab]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return model, train_step


def _vision_build(kind):
    """``bench.py:_resnet_variant`` (ResNet-50 NHWC, ``Momentum(0.1,
    momentum=0.9)``) or ``tools/profile_vit.py`` (ViT-B/16 at dropout 0,
    ``AdamW(1e-4)``): the step under ``to_static`` and
    ``auto_cast(level="O1", dtype="bfloat16")``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision.models import resnet50
    gen = torch.Generator("cuda").manual_seed(0)
    if kind == "resnet":
        model = resnet50(num_classes=1000, data_format="NHWC", remat=False,
                         generator=gen)
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
    else:
        model = models.VisionTransformer(
            models.vit_b_16(dropout=0.0, attention_dropout=0.0),
            generator=gen)
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())

    @pt.jit.to_static
    def train_step(x, y):
        opt.clear_grad()
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(x)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        opt.step()
        return loss

    return model, train_step


def phase_encoders():
    """ERNIE-3.0-base and BERT-base masked-LM steps at 16 x 512 tokens
    (``_headline_path``): a step launches each LayerNorm kernel 26 times
    (the embeddings', two a layer, the LM head's) and each flash kernel
    12 times, at head_dim 64."""
    data = torch.Generator("cuda").manual_seed(3)
    out = {}
    for kind, vocab in (("ernie", 40000), ("bert", 30522)):
        ids = torch.randint(0, vocab, (ENC_B, ENC_S), device="cuda",
                            generator=data)
        labels = torch.randint(0, vocab, (ENC_B, ENC_S), device="cuda",
                               generator=data)
        task = torch.zeros_like(ids)
        out[kind] = _headline_path(
            kind, lambda kind=kind: _mlm_build(kind), (ids, task, labels),
            {"ln_fwd": 26, "ln_bwd": 26, "flash_fwd": 12, "flash_bwd_dq": 12,
             "flash_bwd_dkv": 12}, ENC_B * ENC_S, "tokens")[:2]
    return out


def phase_vision():
    """ResNet-50 NHWC at 256 x 224^2 (no kernel of the port on its path:
    its convs, BatchNorm and pools are cuDNN and torch, as they are XLA
    in the reference; cuDNN deterministic, so the captured step can equal
    the eager one) and ViT-B/16 at 128 x 224^2 (LayerNorm 25 launches a
    step each way, flash 12 each at 197 tokens), through
    ``_headline_path``."""
    data = torch.Generator("cuda").manual_seed(4)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x = torch.randn(RESNET_B, RESNET_SIDE, RESNET_SIDE, 3, device="cuda",
                        generator=data)
        y = torch.randint(0, 1000, (RESNET_B,), device="cuda", generator=data)
        out = {"resnet": _headline_path(
            "resnet", lambda: _vision_build("resnet"), (x, y), {}, RESNET_B,
            "images", falling=False)[:2]}
        del x, y
        gc.collect()
        torch.cuda.empty_cache()
        x = torch.randn(VIT_B, 3, 224, 224, device="cuda", generator=data)
        y = torch.randint(0, 1000, (VIT_B,), device="cuda", generator=data)
        out["vit"] = _headline_path(
            "vit", lambda: _vision_build("vit"), (x, y),
            {"ln_fwd": 25, "ln_bwd": 25, "flash_fwd": 12, "flash_bwd_dq": 12,
             "flash_bwd_dkv": 12}, VIT_B, "images", falling=False)[:2]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


# ------------------------------------------------------ sequence models
TB_VOCAB = 37000                     # WMT14 en-de shared BPE (Vaswani §5.1)
TB_B, TB_S = 16, 256                 # 4,096 target tokens a step
TB_DECODE = 32                       # greedy tokens of the decode reading
TB_SMOOTHING = 0.1                   # label smoothing (Vaswani §5.4)
TB_WARMUP = 4000                     # NoamDecay's warmup steps (§5.3)
TB_SEED = 18                         # the global key of the dropout drives
# PTB "large" (Zaremba et al. 2014, §4): 2 x 1500 LSTM, dropout 0.65,
# 35 unrolled steps, batch 20, SGD at 1.0, gradients clipped at norm 10
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS = 10000, 1500, 2
PTB_B, PTB_T, PTB_DROPOUT, PTB_CLIP = 20, 35, 0.65, 10.0


def sinusoid_table(n, d):
    """Vaswani et al.'s constant position table ``[n, d]`` (f32):
    ``sin(p / 10000^(2i/d))`` in the even columns, ``cos`` in the odd
    ones."""
    pos = np.arange(n)[:, None]
    col = np.arange(d)[None, :]
    angle = pos / np.power(10000.0, (2 * (col // 2)) / d)
    return np.where(col % 2 == 0, np.sin(angle), np.cos(angle)).astype(
        np.float32)


class TransformerLM(torch.nn.Module):
    """Transformer-base (Vaswani et al. 2017, Table 3, "base") from the
    port's public layers: one token embedding shared by source and target
    and tied to the output projection, scaled by sqrt(d_model), plus the
    constant sinusoid table, dropout on the sums; ``nn.Transformer`` at
    ``widths`` (none: its defaults, 512 / 8 / 6 + 6 / 2048, dropout 0.1,
    ReLU, post-LN), or with ``fused_ln`` an encoder and a decoder of
    ``fused_ln=True`` layers at the same widths. The logits are f32 or
    bf16 ``[b, s, vocab]`` (``F.matmul(h, embedding, transpose_y=True)``,
    under autocast a bf16 product)."""

    def __init__(self, vocab=TB_VOCAB, fused_ln=False, max_len=TB_S,
                 device="cuda", generator=None, **widths):
        super().__init__()
        from paddle_tpu_torch import nn
        factory = dict(device=device, generator=generator)
        full = dict(d_model=512, nhead=8, num_encoder_layers=6,
                    num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
        full.update(widths)
        d = full["d_model"]
        self.embed = nn.Embedding(vocab, d, std=d ** -0.5, **factory)
        if fused_ln:
            layer = dict(d_model=d, nhead=full["nhead"],
                         dim_feedforward=full["dim_feedforward"],
                         dropout=full["dropout"], fused_ln=True, **factory)
            widths = dict(widths, custom_encoder=nn.TransformerEncoder(
                nn.TransformerEncoderLayer(**layer),
                full["num_encoder_layers"]),
                custom_decoder=nn.TransformerDecoder(
                    nn.TransformerDecoderLayer(**layer),
                    full["num_decoder_layers"]))
        self.transformer = nn.Transformer(**widths, **factory)
        self.drop = nn.Dropout(full["dropout"])
        self.register_buffer("pos", torch.from_numpy(
            sinusoid_table(max_len, d)).to(device), persistent=False)
        self.scale = math.sqrt(d)

    def embed_tokens(self, ids, start=0):
        return self.drop(self.embed(ids) * self.scale
                         + self.pos[start:start + ids.shape[1]])

    def logits(self, h):
        from paddle_tpu_torch.nn import functional as F
        return F.matmul(h, self.embed.weight, transpose_y=True)

    def forward(self, src, tgt, tgt_mask):
        return self.logits(self.transformer(
            self.embed_tokens(src), self.embed_tokens(tgt),
            tgt_mask=tgt_mask))


def transformer_build(fused_ln, device="cuda", vocab=TB_VOCAB, max_len=TB_S,
                      **widths):
    """Transformer-base's train step: ``Adam(NoamDecay(d_model, 4000),
    beta1 0.9, beta2 0.98, epsilon 1e-9)`` (Vaswani §5.3; unfused, the
    reference's default), cross entropy with label smoothing 0.1 over
    the vocabulary, under ``to_static`` and ``auto_cast(level="O1",
    dtype="bfloat16")``; weights from seed 0, the global key at
    ``TB_SEED``. Returns (model, step, optimizer, the scheduler's step:
    called after each train step)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device).manual_seed(0)
    model = TransformerLM(vocab, fused_ln, max_len, device, gen, **widths)
    sched = pt.optimizer.lr.NoamDecay(model.transformer.d_model, TB_WARMUP)
    opt = pt.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                            epsilon=1e-9, parameters=model.parameters())

    @pt.jit.to_static
    def train_step(src, tgt_in, tgt_out, tgt_mask):
        opt.clear_grad()
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(src, tgt_in, tgt_mask)
            loss = F.cross_entropy(logits.reshape([-1, vocab]),
                                   tgt_out.reshape([-1]),
                                   label_smoothing=TB_SMOOTHING)
        loss.backward()
        opt.step()
        return loss

    pt.seed(TB_SEED)
    return model, train_step, opt, sched.step


def transformer_batch(gen, device="cuda", b=TB_B, s=TB_S, vocab=TB_VOCAB):
    """A seeded batch with no padding: source ``[b, s]``, the target's
    input and its next tokens ``[b, s]``, and the causal mask."""
    from paddle_tpu_torch import nn
    src = torch.randint(1, vocab, (b, s), device=device, generator=gen)
    tgt = torch.randint(1, vocab, (b, s + 1), device=device, generator=gen)
    return (src, tgt[:, :-1].contiguous(), tgt[:, 1:].contiguous(),
            nn.Transformer.generate_square_subsequent_mask(s, device))


def phase_transformer():
    """Transformer-base (``TransformerLM``) on 16 x 256 source and target
    tokens, two readings through ``_headline_path``:

    ``transformer``: encoder and decoder of ``fused_ln=True`` layers at
    dropout 0. A step runs the post-LN join 30 times (2 an encoder layer,
    3 a decoder layer): ``ln_res_fwd`` 30 and ``ln_bwd`` (no gh) 30, the
    (bf16 x, f32 residual, f32 weights) mix; flash (forward, dq, dk/dv)
    12 each, the encoder's 6 self-attentions and the decoder's 6
    cross-attentions at [16, 256, 8, 64] bf16; the decoder's masked
    self-attentions go to the composition (a mask), as in the reference;
    ``ln_fwd`` 0, ``keep_mask`` 0.

    ``transformer_defaults``: ``nn.Transformer()`` at its own defaults,
    dropout 0.1 and ``fused_ln`` off: ``ln_fwd`` and ``ln_bwd`` 30 a step
    (``norm(residual + delta)`` on the LayerNorm layer), flash 0 (dropout
    sends every attention to the composition); ``keep_mask`` 62 a step:
    the source's and the target's embedding dropout, 4 an encoder layer
    (attention probabilities, the two residual dropouts, the FFN's) and 6
    a decoder layer (two attentions, three residual dropouts, the FFN's).

    Returns ({path: (launches, numbers)}, the ``transformer`` model, the
    batch)."""
    data = torch.Generator("cuda").manual_seed(5)
    batch = transformer_batch(data)
    items = TB_B * TB_S
    flash = {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
    out = {}
    launches, numbers, model = _headline_path(
        "transformer", lambda: transformer_build(True, dropout=0.0), batch,
        {"ln_res_fwd": 30, "ln_bwd": 30, **flash}, items, "tokens")
    out["transformer"] = (launches, numbers)
    launches, numbers, defaults = _headline_path(
        "transformer_defaults", lambda: transformer_build(False), batch,
        {"ln_fwd": 30, "ln_bwd": 30, "keep_mask": 62}, items, "tokens",
        falling=False)
    out["transformer_defaults"] = (launches, numbers)
    del defaults
    return out, model, batch


def _greedy(model, memory, start, cached, steps=TB_DECODE):
    """``steps`` greedy tokens after ``start`` ``[b, 1]``: through
    ``TransformerDecoder.gen_cache`` (a ``Cache`` of the self-attention's
    keys and values and a ``StaticCache`` of the memory's, one query row
    a step), or by running the whole decoder on the prefix under the
    causal mask at every step. Returns (tokens ``[b, steps]``, the
    last position's logits at each step, seconds)."""
    from paddle_tpu_torch import nn
    dec = model.transformer.decoder
    seq, logits = start, []
    caches = dec.gen_cache(memory) if cached else None
    sync = torch.cuda.synchronize if memory.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for t in range(steps):
        if cached:
            h, caches = dec(model.embed_tokens(seq[:, -1:], t), memory,
                            None, None, caches)
        else:
            mask = nn.Transformer.generate_square_subsequent_mask(
                seq.shape[1], memory.device)
            h = dec(model.embed_tokens(seq), memory, mask)
        logits.append(model.logits(h[:, -1]))
        seq = torch.cat([seq, logits[-1].argmax(-1, keepdim=True)], dim=1)
    sync()
    return seq[:, 1:], torch.stack(logits, 1), time.perf_counter() - t0


def phase_transformer_decode(model, src):
    """The ``transformer`` reading's model after its steps, in eval, f32,
    no autocast: the encoder's memory of the 16 x 256 source (6 flash
    forwards, 12 joins), then ``TB_DECODE`` greedy tokens twice from the
    source's first tokens, cached (``_greedy``: a token runs flash 12
    times at one query row, the 6 self-attentions against 1-32 keys and
    the 6 cross-attentions against 256, and 18 joins) and uncached (a
    token runs flash 6 times, its cross-attentions, and 18 joins; the
    masked self-attentions go to the composition). The tokens are equal
    and each step's last-position logits agree within 1e-4 of their
    largest magnitude; nothing routed. Prints ms per token each way.
    Returns (launches, numbers)."""
    model.eval()
    reset_launches()
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed_tokens(src))
        enc = read_launches("transformer_decode, encoder")
        start = src[:, :1]
        cached = _greedy(model, memory, start, True)
        got = read_launches("transformer_decode, cached")
        uncached = _greedy(model, memory, start, False)
        total = read_launches("transformer_decode")
    steps = TB_DECODE
    want_enc = {"flash_fwd": 6, "ln_res_fwd": 12}
    want_cached = {"flash_fwd": 6 + 12 * steps, "ln_res_fwd": 12 + 18 * steps}
    want_total = {"flash_fwd": 6 + 18 * steps,
                  "ln_res_fwd": 12 + 36 * steps}
    for name, counts, want in (("encoder", enc, want_enc),
                               ("cached", got, want_cached),
                               ("both", total, want_total)):
        if counts != {**dict.fromkeys(counts, 0), **want}:
            raise AssertionError(f"transformer_decode {name} launches "
                                 f"{counts}, want {want}")
    if not torch.equal(cached[0], uncached[0]):
        rows = (cached[0] != uncached[0]).any(1).nonzero().flatten().tolist()
        raise AssertionError(f"cached and uncached greedy tokens differ in "
                             f"rows {rows}")
    err = (cached[1] - uncached[1]).abs().max().item()
    scale = uncached[1].abs().max().item()
    if not err <= 1e-4 * scale:
        raise AssertionError(f"decode logits differ by {err} (limit "
                             f"{1e-4 * scale})")
    numbers = {"cached_ms_per_token": cached[2] * 1e3 / steps,
               "uncached_ms_per_token": uncached[2] * 1e3 / steps}
    print(f"[transformer_decode] {TB_B} rows x {steps} greedy tokens: the "
          f"cached and uncached decodes agree token for token, logits "
          f"within {err:.3g} (limit {1e-4 * scale:.3g}); launches {total}")
    print(f"[transformer_decode] {card_line()}: cached "
          f"{numbers['cached_ms_per_token']:.2f} ms a token, uncached "
          f"{numbers['uncached_ms_per_token']:.2f} (host clock, {TB_B} "
          f"rows, f32)")
    model.train()
    return total, numbers


class PTBLarge(torch.nn.Module):
    """Zaremba et al. 2014's large PTB language model from the port's
    public layers: an embedding of 1500, dropout 0.65, ``nn.LSTM(1500,
    1500, num_layers=2, dropout=0.65)``, dropout 0.65, a Linear to the
    10,000-word vocabulary."""

    def __init__(self, vocab=PTB_VOCAB, hidden=PTB_HIDDEN,
                 layers=PTB_LAYERS, dropout=PTB_DROPOUT, device="cuda",
                 generator=None):
        super().__init__()
        from paddle_tpu_torch import nn
        factory = dict(device=device, generator=generator)
        self.embed = nn.Embedding(vocab, hidden, std=0.04, **factory)
        self.drop = nn.Dropout(dropout)
        self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                            dropout=dropout, **factory)
        self.head = nn.Linear(hidden, vocab, std=0.04, **factory)

    def forward(self, ids):
        out, _ = self.lstm(self.drop(self.embed(ids)))
        return self.head(self.drop(out))


def lstm_build(device="cuda", vocab=PTB_VOCAB, **widths):
    """The PTB step: ``SGD(1.0, grad_clip=ClipGradByGlobalNorm(10))``,
    mean cross entropy, f32, under ``to_static``; weights from seed 0,
    the global key at ``TB_SEED``. Returns (model, step, optimizer, a
    no-op after each step)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device).manual_seed(0)
    model = PTBLarge(vocab, device=device, generator=gen, **widths)
    opt = pt.optimizer.SGD(learning_rate=1.0, parameters=model.parameters(),
                           grad_clip=pt.nn.ClipGradByGlobalNorm(PTB_CLIP))

    @pt.jit.to_static
    def train_step(ids, labels):
        opt.clear_grad()
        loss = F.cross_entropy(model(ids).reshape([-1, vocab]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    pt.seed(TB_SEED)
    return model, train_step, opt, lambda: None


def phase_lstm():
    """The PTB large LSTM on 20 x 35 tokens (``_headline_path``, f32). No
    kernel of the port lies on this path but the keep mask: a step draws
    3 masks (the embedding's dropout, the one between the two LSTM
    layers, the output's); the LSTM's time loop is torch's GEMMs and
    elementwise kernels, the clip and SGD torch's. Returns {path:
    (launches, numbers)}."""
    data = torch.Generator("cuda").manual_seed(6)
    ids = torch.randint(0, PTB_VOCAB, (PTB_B, PTB_T + 1), device="cuda",
                        generator=data)
    batch = (ids[:, :-1].contiguous(), ids[:, 1:].contiguous())
    launches, numbers, model = _headline_path(
        "lstm", lstm_build, batch, {"keep_mask": 3}, PTB_B * PTB_T,
        "tokens")
    del model
    return {"lstm": (launches, numbers)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile 10 decode steps by kernel")
    args = ap.parse_args(argv)
    # fails, and so does the run, outside a checkout of the repository
    from paddle_tpu_torch.core.device import device_name
    seconds = {}

    def phase(name, fn, *a):
        """Run one phase, freeing the card after it, and note its time."""
        t0 = time.perf_counter()
        out = fn(*a)
        gc.collect()
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 1)
        print(f"[phase] {name}: {seconds[name]} s")
        return out

    phase("device", phase_device)
    phase("build", phase_build)
    max_err, timings = phase("kernels", phase_kernels)
    train_err, train_timings = phase("train kernels", phase_train_kernels)
    adam_err, adam_timings, adam_per_step = phase("adam kernels",
                                                  phase_adam_kernels)
    sparse_err, sparse_timings = phase("sparse kernels",
                                       phase_sparse_kernels)
    keep_err, keep_timings = phase("keep mask", phase_keep_mask)
    phase("tiny", phase_tiny)
    phase("sampler", phase_sampler)
    serving, bf16_serving = phase("serving", phase_serving, args.profile)
    quant_serving = phase("quantized serving", phase_quant_serving,
                          bf16_serving, args.profile)
    train, unfused_losses = phase("train", phase_train)
    paths = {"serving": serving, "quant_serving": quant_serving,
             "train": train,
             "guarded_train": phase("guarded train", phase_train_guarded,
                                    unfused_losses)}
    paths["fused_train"] = phase("fused train", phase_fused_unguarded)
    paths["dropout_train"] = phase("dropout train", phase_train_dropout)
    phase("head and scaler", phase_head_and_scaler)
    paths["lr_schedule"] = phase("lr schedule", phase_lr_schedule)
    paths["rollback"] = phase("rollback", phase_rollback)
    paths["sparse_block"] = phase("sparse block", phase_sparse_block)
    paths["optimizers"] = phase("optimizers", phase_optimizers)
    paths["observability"] = phase("observability", phase_observability)
    paths["router"] = phase("router and traffic", phase_router_traffic,
                            bf16_serving)
    paths["fleet"] = phase("fleet", phase_fleet, bf16_serving)
    paths["moe"] = phase("moe", phase_moe)
    phase("collectives", phase_collectives)
    flash64_err, flash64_timings = phase("flash64", phase_flash64)
    headline = phase("encoders", phase_encoders)
    headline.update(phase("vision", phase_vision))
    sequence, tb_model, tb_batch = phase("transformer", phase_transformer)
    headline.update(sequence)
    headline["transformer_decode"] = phase(
        "transformer decode", phase_transformer_decode, tb_model,
        tb_batch[0])
    del tb_model, tb_batch
    headline.update(phase("lstm", phase_lstm))
    print("[headline] " + "; ".join(
        f"{tag}: " + ", ".join(f"{k} {v:.1f}" for k, v in numbers.items())
        for tag, (_, numbers) in headline.items()))
    print(f"[phase] seconds: {seconds}, {sum(seconds.values()):.1f} in all")
    max_err.update(train_err)
    max_err.update(adam_err)
    max_err.update(sparse_err)
    max_err.update(keep_err)
    embedding = (50304, 2048)
    timed = {"ln_fwd": timings[("ln_fwd", TIMED_ROWS)],
             "ln_res_fwd": timings[("ln_res_fwd", TIMED_ROWS)],
             "flash_fwd": train_timings["flash_fwd"],
             "flash_bwd_dq": train_timings["flash_bwd_dq"],
             "flash_bwd_dkv": train_timings["flash_bwd_dkv"],
             "ln_bwd": train_timings[("ln_bwd", B * S)],
             "ln_bwd_res": train_timings[("ln_bwd_res", B * S)],
             **{name: {**adam_timings[(name, embedding)],
                       "per_step_ms": adam_per_step[name]}
                for name in ("adam_update", "adam_update_guard",
                             "adam_guard_sumsq")},
             "rms_fwd": sparse_timings[("rms_fwd", 8192)],
             "bsa_fwd": sparse_timings[("bsa_fwd", "a")],
             "keep_mask": keep_timings["keep_mask"]}
    kernels = []
    for name, t in timed.items():
        shape = {k: v for k, v in t.items() if k not in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "per_step")}
        if name in ("ln_fwd", "ln_res_fwd"):
            wide = timings[(name, TRAIN_LN_ROWS)]
            shape = {"rows": TIMED_ROWS, "hidden": HIDDEN, "dtype": "bfloat16",
                     "launch_floor_ms": t["launch_floor_ms"],
                     f"ms_{TRAIN_LN_ROWS}": wide["ms"],
                     f"bound_ms_{TRAIN_LN_ROWS}": wide["bound_ms"],
                     f"library_ms_{TRAIN_LN_ROWS}": wide["library_ms"]}
        if name == "bsa_fwd":           # (a) above; (b) and (c) beside it
            for case in "bc":
                c = sparse_timings[("bsa_fwd", case)]
                shape.update({f"{k}_{case}": c[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "shape", "block")})
        # the headline paths run the LayerNorm kernels as the others do,
        # and the flash kernels at head_dim 64: those are the rows below
        drives = paths if name.startswith("flash") else {
            **paths, **{tag: counts for tag, (counts, _) in headline.items()}}
        by_path = {path: counts[name] for path, counts in drives.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_err[name],
            "err_share": shares(name)[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **shape})
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        t = flash64_timings["bert"][name]
        by_path = {tag: counts[name] for tag, (counts, _) in headline.items()}
        row = {
            "name": f"{name}_d64", "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": flash64_err[name],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "causal", "dtype")}}
        if "pair_ms" in t:
            row.update(pair_ms=t["pair_ms"],
                       pair_library_ms=t["pair_library_ms"])
        # the other head_dim-64 shapes: ViT-B/16's and Transformer-base's
        for tag in ("vit", "transformer"):
            o = flash64_timings[tag][name]
            row.update({f"{k}_{tag}": o[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "shape", "pair_ms", "pair_library_ms") if k in o})
        kernels.append(row)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name("cuda:0"),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
