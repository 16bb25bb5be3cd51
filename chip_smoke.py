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
   tokens.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' numbers as JSON.
"""
from __future__ import annotations

import argparse
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
SOURCE = "paddle_tpu_torch/ops/cuda/csrc/norm.cu"
REPLACES = {"ln_fwd": "paddle_tpu/ops/pallas/norm.py:55",
            "ln_res_fwd": "paddle_tpu/ops/pallas/norm.py:190"}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bf16_ulp(t):
    """One bf16 ulp at each element's magnitude."""
    mag = t.abs().float().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


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
    bad = int((err > tol).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements beyond tolerance, "
                             f"max abs err {err.max().item()}")
    return err.max().item()


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


def phase_serving(profile):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.ops.cuda import norm
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
    for k in norm.LAUNCHES:
        norm.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    results = eng.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(norm.LAUNCHES)
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    m = eng.metrics
    forwards = m.prefill_steps + m.decode_steps
    expect = {"ln_fwd": forwards * (cfg.num_layers + 1),
              "ln_res_fwd": forwards * cfg.num_layers}
    print(f"[serving] {len(results)} requests, prompts "
          f"{[len(p) for p in prompts]}, {m.prefill_steps} prefills + "
          f"{m.decode_steps} decode steps; launches {launches}, expected "
          f"{expect}")
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
    launches = phase_serving(args.profile)
    kernels = []
    for name in ("ln_fwd", "ln_res_fwd"):
        t = timings[(name, TIMED_ROWS)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "rows": TIMED_ROWS, "hidden": HIDDEN, "dtype": "bfloat16"})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name("cuda:0"),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
