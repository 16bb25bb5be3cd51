#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases, exit 0 only if all pass
    python3 chip_smoke.py --profile    # also profile a few decode steps

Phases, in order (any failure raises and exits non-zero):

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for matmuls and convolutions;
2. build: compile the port's CUDA kernels from ``paddle_tpu_torch/ops/
   cuda/csrc`` with nvcc for sm_90a;
3. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes (hidden 2048; rows 8, 16, 512, 1000; f32 and bf16;
   ``act="gelu"`` too for ln_res_fwd), then its time (CUDA events) beside
   its bound, the plain version's time and the library call's;
4. serving: GPT-1.3B (``gpt3_1p3b(fused_ln=True)``, random bf16 weights
   from a seeded generator) serves 8 requests through ``LLMEngine``;
   every request finishes with 64 tokens, every logit is finite, the
   kernels' launch counts match the forward passes exactly, and serving
   the same requests one at a time on a fresh engine gives the same
   tokens;
5. train kernels: the flash attention kernels (forward, dq, dk/dv) at the
   training path's shape (``[4, 1024, 16, 128]``, causal, q/k/v strided
   views of a fused projection) plus a ragged non-causal one, and the
   LayerNorm backward kernel (rows 4096 and 8, plain and residual,
   ``act`` None and gelu), f32 and bf16, each against its plain version;
   then the autograd Functions (kernel path) against autograd through
   the plain versions, and each kernel's time beside its bound, its plain
   version's and the library call's;
6. training: GPT-1.3B (``gpt3_1p3b(fused_ln=True)``, dropout 0, f32
   master weights from a seeded generator) takes 10 steps of
   ``to_static(amp_policy="bf16")`` + ``AdamW(fused=False)`` on one
   seeded batch of 4 x 1024 tokens; every loss is finite, the last is
   below the first by more than ``LOSS_DROP``, every parameter ends
   with a finite gradient, and each step launches each kernel exactly as
   often as the model has call sites; then one step under
   ``torch.profiler`` says where a step's time goes.

Each main path (serving, training) runs with every launch count set to 0
just before it and read just after. The last line is ``{"ok": true,
"device": {...}}``; the line before it holds the kernels' numbers as
JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HIDDEN = 2048
ROWS = (8, 16, 512, 1000)            # decode width, and prefill-sized rows
EPS = 1e-5
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12                # non-tensor-core f32, data sheet
LN_OPS_PER_ELEM = 8                  # sum, sub, square, sum, scale, w, b
TIMED_ROWS = 8                       # the decode shape: most launches
NORM_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/norm.cu"
FLASH_SOURCE = "paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu"
REPLACES = {"ln_fwd": "paddle_tpu/ops/pallas/norm.py:55",
            "ln_res_fwd": "paddle_tpu/ops/pallas/norm.py:190",
            "flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:94",
            "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:144",
            "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:181",
            "ln_bwd": "paddle_tpu/ops/pallas/norm.py:225",
            "ln_bwd_res": "paddle_tpu/ops/pallas/norm.py:233"}
SOURCES = {name: FLASH_SOURCE if name.startswith("flash") else NORM_SOURCE
           for name in REPLACES}
BF16_OPS_PER_S = 989e12              # H100 SXM dense bf16 tensor cores
# the training path: batch, sequence, heads, head_dim (GPT-1.3B)
B, S, H, D = 4, 1024, 16, 128
TRAIN_STEPS = 10
LOSS_DROP = 0.1                      # last loss <= first - LOSS_DROP
LN_BWD_OPS_PER_ELEM = 20             # stats, xhat, two row sums, dx, dw, db


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


def _inputs(rows, dtype, gen, copies=1):
    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(HIDDEN, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(HIDDEN, device="cuda", generator=gen)).to(dtype)
    return [(rnd(rows, HIDDEN), rnd(rows, HIDDEN), w, b)
            for _ in range(copies)]


def phase_kernels():
    from paddle_tpu_torch.ops.cuda import norm
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {"ln_fwd": 0.0, "ln_res_fwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for rows in ROWS:
            (x, r, w, b), = _inputs(rows, dtype, gen)
            tag = f"rows={rows} {str(dtype).split('.')[1]}"
            got = norm.ln_fwd(x, w, b, EPS)
            torch.cuda.synchronize()
            max_err["ln_fwd"] = max(max_err["ln_fwd"], check_close(
                f"ln_fwd {tag}", got, norm._ln_fwd_ref(x, w, b, EPS)))
            for act in (None, "gelu"):
                h, y = norm.ln_res_fwd(x, r, w, b, EPS, act)
                torch.cuda.synchronize()
                h_ref, y_ref = norm._ln_res_fwd_ref(x, r, w, b, EPS, act)
                max_err["ln_res_fwd"] = max(
                    max_err["ln_res_fwd"],
                    check_close(f"ln_res_fwd h act={act} {tag}", h, h_ref),
                    check_close(f"ln_res_fwd y act={act} {tag}", y, y_ref))
    print(f"[kernels] agree with their plain versions on all "
          f"{2 * len(ROWS)} shapes; max abs err {max_err}")
    print(f"[kernels] largest error as a share of its limit: "
          f"{shares('ln_fwd', 'ln_res_fwd')}")

    timings = {}
    for rows in ROWS:
        e = 2                                               # bf16 bytes
        copies = max(1, min(64, math.ceil(150e6 / (4 * rows * HIDDEN * e))))
        sets = _inputs(rows, torch.bfloat16, gen, copies)
        ln_args = [(x, w, b, EPS) for x, _r, w, b in sets]
        res_args = [(x, r, w, b, EPS) for x, r, w, b in sets]
        lib_args = [(x, (HIDDEN,), w, b, EPS) for x, _r, w, b in sets]
        vec_bytes = 2 * HIDDEN * e
        for name, fn, ref, args, io_rows, ops, lib in (
                ("ln_fwd", norm.ln_fwd, norm._ln_fwd_ref, ln_args, 2,
                 LN_OPS_PER_ELEM, torch.nn.functional.layer_norm),
                ("ln_res_fwd", norm.ln_res_fwd, norm._ln_res_fwd_ref,
                 res_args, 4, LN_OPS_PER_ELEM + 1, None)):
            bytes_ms = (io_rows * rows * HIDDEN * e + vec_bytes) \
                / HBM_BYTES_PER_S * 1e3
            ops_ms = ops * rows * HIDDEN / F32_OPS_PER_S * 1e3
            t = {
                "ms": device_ms(fn, args),
                "plain_ms": device_ms(ref, args),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": device_ms(lib, lib_args) if lib else None,
            }
            timings[(name, rows)] = t
            lib_txt = (f"{t['library_ms']:.5f}" if t["library_ms"]
                       is not None else "null")
            print(f"[kernels] {name} rows={rows} hidden={HIDDEN} bf16: "
                  f"kernel_ms {t['ms']:.5f} bound_ms {t['bound_ms']:.5f} "
                  f"({t['bound_by']}) plain_ms {t['plain_ms']:.5f} "
                  f"library_ms {lib_txt}")
    return max_err, timings


def _prompts(seed, vocab, n=8):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 901, n)
    return [rng.integers(1, vocab, int(L)).tolist() for L in lens]


def reset_launches():
    from paddle_tpu_torch.ops.cuda import flash_attention, norm
    for counts in (norm.LAUNCHES, flash_attention.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches():
    from paddle_tpu_torch.ops.cuda import flash_attention, norm
    return {**norm.LAUNCHES, **flash_attention.LAUNCHES}


def phase_serving(profile):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)
    cfg = gpt3_1p3b(fused_ln=True)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serving] gpt3_1p3b(fused_ln=True): {n_params / 1e9:.3f} B "
          f"params in bf16, built in {time.perf_counter() - t0:.1f} s")

    def engine():
        return LLMEngine(model, EngineConfig(
            max_num_seqs=8, page_size=16, max_model_len=1024,
            dtype=torch.bfloat16))

    prompts = _prompts(0, cfg.vocab_size)
    sps = [SamplingParams(max_new_tokens=64,
                          temperature=0.0 if i % 2 == 0 else 0.8,
                          top_k=0 if i % 2 == 0 else 50, seed=100 + i)
           for i in range(len(prompts))]

    warm = engine()                    # cuBLAS and allocator warm-up
    warm.generate([prompts[0][:16]], [SamplingParams(max_new_tokens=2)])
    warm.shutdown()

    finite = []
    hook = model.register_forward_hook(
        lambda _m, _inp, out: finite.append(torch.isfinite(out).all()))
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    results = eng.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics
    forwards = m.prefill_steps + m.decode_steps
    expect = {k: 0 for k in launches}
    expect.update(ln_fwd=forwards * (cfg.num_layers + 1),
                  ln_res_fwd=forwards * cfg.num_layers)
    print(f"[serving] {len(results)} requests, prompts "
          f"{[len(p) for p in prompts]}, {m.prefill_steps} prefills + "
          f"{m.decode_steps} decode steps; launches {launches}")
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect}")
    if len(finite) != forwards or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits (or a forward not seen)")
    for r in results:
        if len(r.output_token_ids) != 64:
            raise AssertionError(f"{r.request_id}: "
                                 f"{len(r.output_token_ids)} tokens")
    eng.shutdown()

    seq = engine()
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        (one,) = seq.generate([p], [sp])
        if one.output_token_ids != results[i].output_token_ids:
            raise AssertionError(f"request {i}: continuous serving "
                                 f"differs from sequential")
    seq.shutdown()
    print("[serving] continuous == sequential for all 8 requests")

    snap = m.snapshot()
    card = card_line()
    print(f"[serving] {card}: {m.generated_tokens / wall:.1f} tokens/s "
          f"({m.generated_tokens} tokens in {wall:.2f} s), mean decode "
          f"step {snap['decode_step_ms']['mean']:.2f} ms, mean prefill "
          f"{snap['prefill_step_ms']['mean']:.2f} ms, TTFT p50 "
          f"{snap['ttft_ms']['p50']:.1f} ms p99 {snap['ttft_ms']['p99']:.1f}"
          f" ms, peak memory {peak / 2**30:.2f} GiB")
    if profile:
        profile_decode(engine(), prompts, sps)
    return launches


def profile_decode(eng, prompts, sps):
    """Device time by kernel over 10 decode steps at full width."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for p, sp in zip(prompts, sps):
        eng.add_request(p, sp)
    eng.step()                         # admits and prefills all 8
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            eng.step()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    eng.shutdown()


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


def check_flash(gen):
    """Each flash kernel against its plain version on the same inputs,
    then the autograd Function against the plain versions and against
    autograd through the plain forward. Returns {kernel: max abs err}."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    err = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(True, dict()),
             (False, dict(b=1, sq=200, sk=328, h=4, d=D))]    # ragged
    for dtype in (torch.float32, torch.bfloat16):
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
            err["flash_bwd_dq"] = max(err["flash_bwd_dq"], check_terms(
                f"flash_bwd_dq {tag}", dq, fa._flash_bwd_dq_ref(*args), t_dq))
            dk_ref, dv_ref = fa._flash_bwd_dkv_ref(*args)
            err["flash_bwd_dkv"] = max(
                err["flash_bwd_dkv"],
                check_terms(f"flash_bwd_dkv dk {tag}", dk, dk_ref, t_dk),
                check_terms(f"flash_bwd_dkv dv {tag}", dv, dv_ref, t_dv))
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
    """ln_bwd against its plain version (rows 4096 and 8, plain and
    residual, act None and gelu, f32 and bf16 rows with f32 weights, as
    on the training path), then the LayerNorm autograd Functions (kernel
    path) against autograd through the plain forwards."""
    from paddle_tpu_torch.ops.cuda import norm
    err = {"ln_bwd": 0.0, "ln_bwd_res": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (B * S, 8):
            (h, gy, _w, _b), = _inputs(rows, dtype, gen)
            (gh, _x, w, b), = _inputs(rows, torch.float32, gen)
            gh = gh.to(dtype)
            for act, res in ((None, False), (None, True), ("gelu", True)):
                name = "ln_bwd_res" if res else "ln_bwd"
                tag = f"{name} rows={rows} act={act}"
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


def _bound(bytes_, ops, ops_per_s):
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def time_train_kernels(gen):
    """Each training kernel at the path's shapes (bf16), by CUDA events:
    kernel, plain version, bound and the library call where there is
    one."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import norm
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {}
    scale = 1.0 / math.sqrt(D)
    sets = [_attention_inputs(torch.bfloat16, gen) for _ in range(2)]
    stats = []
    for q, k, v, do in sets:
        o, lse = fa.flash_fwd(q, k, v, True, scale)
        stats.append((lse, _delta(do, o)))
    pairs = S * (S + 1) // 2 * B * H          # causal (q, k) pairs to do
    elems = B * S * H * D                     # one [b, s, h, d] tensor
    row_stats = B * H * S * 4                 # one f32 [b*h, s] tensor
    fwd_args = [(q, k, v, True, scale) for q, k, v, _ in sets]
    bwd_args = [(q, k, v, do, lse, dl, True, scale)
                for (q, k, v, do), (lse, dl) in zip(sets, stats)]
    lib_sets = [tuple(x.transpose(1, 2).contiguous() for x in (q, k, v, do))
                for q, k, v, do in sets]

    def lib_fwd_bwd(q, k, v, do):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = sdpa(*leaves, is_causal=True)
        return torch.autograd.grad(out, leaves, do)

    def kernel_fwd_bwd(q, k, v, do):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention_bshd(*leaves, causal=True, scale=scale)
        return torch.autograd.grad(out, leaves, do)

    few = dict(reps=10, per_rep=5)
    rows = [
        ("flash_fwd", fa.flash_fwd, fa._flash_fwd_ref, fwd_args,
         4 * elems * 2 + row_stats, 4 * pairs * D,
         (lambda q, k, v, do: sdpa(q, k, v, is_causal=True), lib_sets)),
        ("flash_bwd_dq", fa.flash_bwd_dq, fa._flash_bwd_dq_ref, bwd_args,
         5 * elems * 2 + 2 * row_stats, 6 * pairs * D, None),
        ("flash_bwd_dkv", fa.flash_bwd_dkv, fa._flash_bwd_dkv_ref, bwd_args,
         6 * elems * 2 + 2 * row_stats, 8 * pairs * D, None),
    ]
    for name, fn, ref, args, bytes_, ops, lib in rows:
        bound, by = _bound(bytes_, ops, BF16_OPS_PER_S)
        t[name] = {"ms": device_ms(fn, args, **few),
                   "plain_ms": device_ms(ref, args, **few),
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": device_ms(lib[0], lib[1], **few)
                   if lib else None,
                   "shape": [B, S, H, D], "causal": True, "dtype": "bfloat16"}
    t["flash_fwd_bwd"] = {
        "ms": device_ms(kernel_fwd_bwd, [x for x in sets], **few),
        "library_ms": device_ms(lib_fwd_bwd, lib_sets, **few)}

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
        for name, io in (("ln_bwd", 3), ("ln_bwd_res", 4)):
            res = name == "ln_bwd_res"
            args = [(h_, gy, w, b, EPS, None, gh if res else None)
                    for h_, gy, gh, w, b in ins]
            bound, by = _bound(io * rows_ * HIDDEN * 2 + 4 * HIDDEN * 4,
                               LN_BWD_OPS_PER_ELEM * rows_ * HIDDEN,
                               F32_OPS_PER_S)
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


# -------------------------------------------------------------- training
def phase_train():
    """GPT-1.3B, 10 train steps through the port's entry points."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn import functional as F
    cfg = gpt3_1p3b(fused_ln=True, dropout=0.0, attention_dropout=0.0)
    vocab = cfg.vocab_size
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    model.train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters(), fused=False)

    @pt.jit.to_static(amp_policy="bf16")
    def train_step(ids, labels):
        opt.clear_grad()
        logits = model(ids)
        loss = F.cross_entropy(logits.reshape([-1, vocab]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    data = torch.Generator("cuda").manual_seed(1)
    ids = torch.randint(0, vocab, (B, S), device="cuda", generator=data)
    labels = torch.randint(0, vocab, (B, S), device="cuda", generator=data)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] gpt3_1p3b(fused_ln=True, dropout=0): {n_params / 1e9:.3f}"
          f" B f32 params, built in {time.perf_counter() - t0:.1f} s; "
          f"batch {B} x {S} tokens, AdamW(1e-4, fused=False), "
          f"to_static(amp_policy='bf16')")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = train_step(ids, labels).item()         # synchronises
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = {"flash_fwd": cfg.num_layers, "flash_bwd_dq": cfg.num_layers,
                "flash_bwd_dkv": cfg.num_layers,
                "ln_fwd": cfg.num_layers + 1, "ln_res_fwd": cfg.num_layers,
                "ln_bwd": cfg.num_layers + 1, "ln_bwd_res": cfg.num_layers}
    expect = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    print(f"[train] losses {losses}")
    print(f"[train] launches {launches}")
    if launches != expect:
        raise AssertionError(f"train launches {launches} != {expect}")
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
    steady = statistics.median(step_s[1:])
    card = card_line()
    print(f"[train] every one of {len(list(model.parameters()))} parameters "
          f"has a finite gradient (LayerNorm weights included)")
    print(f"[train] {card}: step {steady * 1e3:.1f} ms (median of steps "
          f"2-{TRAIN_STEPS}; first {step_s[0] * 1e3:.1f} ms), "
          f"{B * S / steady:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    breakdown(model, opt, ids, labels, vocab, steady)
    profile_train_step(train_step, ids, labels, steady)
    return launches


def breakdown(model, opt, ids, labels, vocab, step_s):
    """Device time of the step's two halves, by CUDA events (median of
    3): forward + loss + backward under the bf16 policy, then the
    optimizer update."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    halves = {"forward+backward": [], "optimizer": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        opt.clear_grad()
        ev[0].record()
        with pt.amp.activation_residency("bf16"):
            loss = F.cross_entropy(model(ids).reshape([-1, vocab]),
                                   labels.reshape([-1]))
            loss.backward()
        ev[1].record()
        opt.step()
        ev[2].record()
        ev[2].synchronize()
        halves["forward+backward"].append(ev[0].elapsed_time(ev[1]))
        halves["optimizer"].append(ev[1].elapsed_time(ev[2]))
    print("[train breakdown] " + ", ".join(
        f"{k} {statistics.median(v):.1f} ms" for k, v in halves.items())
        + f" of a {step_s * 1e3:.1f} ms step (CUDA events, median of 3)")


def profile_train_step(train_step, ids, labels, step_s):
    """Device time by kernel over one train step under torch.profiler,
    and its share of the step's unprofiled wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        train_step(ids, labels)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[train profile] one step: {busy_ms:.1f} ms of kernel time, "
          f"{100 * busy_ms / (step_s * 1e3):.1f} % of the {step_s * 1e3:.1f}"
          f" ms step; by kernel:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"[train profile] {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile 10 decode steps by kernel")
    args = ap.parse_args(argv)
    # fails, and so does the run, outside a checkout of the repository
    from paddle_tpu_torch.core.device import device_name
    phase_device()
    phase_build()
    max_err, timings = phase_kernels()
    train_err, train_timings = phase_train_kernels()
    serving = phase_serving(args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train()
    max_err.update(train_err)
    timed = {"ln_fwd": timings[("ln_fwd", TIMED_ROWS)],
             "ln_res_fwd": timings[("ln_res_fwd", TIMED_ROWS)],
             "flash_fwd": train_timings["flash_fwd"],
             "flash_bwd_dq": train_timings["flash_bwd_dq"],
             "flash_bwd_dkv": train_timings["flash_bwd_dkv"],
             "ln_bwd": train_timings[("ln_bwd", B * S)],
             "ln_bwd_res": train_timings[("ln_bwd_res", B * S)]}
    kernels = []
    for name, t in timed.items():
        shape = {k: v for k, v in t.items() if k not in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name in ("ln_fwd", "ln_res_fwd"):
            shape = {"rows": TIMED_ROWS, "hidden": HIDDEN, "dtype": "bfloat16"}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": serving[name] + train[name],
            "launches_by_path": {"serving": serving[name],
                                 "train": train[name]},
            "max_abs_err": max_err[name],
            "err_share": shares(name)[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **shape})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name("cuda:0"),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
