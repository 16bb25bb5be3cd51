#!/usr/bin/env python3
"""Measure the port's GPT-1.3B serving in two checkouts on one GPU.

    python3 scripts/ab_serving.py OTHER_CHECKOUT [--out FILE]

Runs the setup of ``chip_smoke.py``'s serving phase
(``gpt3_1p3b(fused_ln=True)``, random bf16 weights from a seeded
generator, ``EngineConfig(max_num_seqs=8, page_size=16,
max_model_len=1024)``, the same 8 requests of 64 new tokens, half of them
sampled) on the ``paddle_tpu_torch`` of OTHER_CHECKOUT and on this
checkout's, in the order other, this, this, other, each in a fresh
process, with the same measuring code. A run serves the batch twice, each
time on a fresh engine: booted by ``warmup()`` where the engine has one
(its ``boot_ms``), else after one short request on a throwaway engine, as
``chip_smoke.py`` warmed an eager engine. Each round gives generated
tokens/s (host clock to the last token), the mean decode and prefill step
and TTFT p50/p99 from the engine's metrics, the peak memory allocated and
reserved, and a digest of every output token. Then 10 decode steps at
full width under ``torch.profiler``: their host time and their kernel
time. Prints one JSON line a run, then a summary line.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
ROUNDS = 2
PROFILED_STEPS = 10


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def requests(vocab, serving):
    """chip_smoke.py's 8 prompts and their sampling parameters."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 901, 8)
    prompts = [rng.integers(1, vocab, int(n)).tolist() for n in lens]
    sps = [serving.SamplingParams(max_new_tokens=64,
                                  temperature=0.0 if i % 2 == 0 else 0.8,
                                  top_k=0 if i % 2 == 0 else 50,
                                  seed=100 + i)
           for i in range(len(prompts))]
    return prompts, sps


def child(root):
    """One run against the package under ``root``; prints its JSON."""
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_serving: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.ops.cuda import build
    if not Path(pt.__file__).resolve().is_relative_to(root):
        sys.exit(f"ab_serving: imported {pt.__file__}, not from {root}")
    build.load_library()
    cfg = gpt3_1p3b(fused_ln=True)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator("cuda").manual_seed(0))
    prompts, sps = requests(cfg.vocab_size, serving)

    def engine():
        return serving.LLMEngine(model, serving.EngineConfig(
            max_num_seqs=8, page_size=16, max_model_len=1024,
            dtype=torch.bfloat16))

    if not hasattr(serving.LLMEngine, "warmup"):
        warm = engine()
        warm.generate([prompts[0][:16]],
                      [serving.SamplingParams(max_new_tokens=2)])
        warm.shutdown()
    rounds = []
    for _ in range(ROUNDS):
        gc.collect()
        torch.cuda.empty_cache()
        eng = engine()
        boot = eng.warmup()["boot_ms"] if hasattr(eng, "warmup") else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = eng.generate(prompts, sps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        tokens = [r.output_token_ids for r in results]
        rounds.append({
            "tokens_per_s": snap["tokens"]["generated"] / wall,
            "decode_step_ms": snap["decode_step_ms"]["mean"],
            "prefill_step_ms": snap["prefill_step_ms"]["mean"],
            "ttft_p50_ms": snap["ttft_ms"]["p50"],
            "ttft_p99_ms": snap["ttft_ms"]["p99"],
            "boot_ms": boot,
            "compiles": snap.get("compiles"),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            "tokens_digest": hashlib.sha256(
                json.dumps(tokens).encode()).hexdigest()[:16]})
        eng.shutdown()

    from torch.profiler import ProfilerActivity, profile
    eng = engine()
    if hasattr(eng, "warmup"):
        eng.warmup()
    for p, sp in zip(prompts, sps):
        eng.add_request(p, sp)
    for _ in range(4):                 # admits all 8, then 3 decode steps
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            eng.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    eng.shutdown()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in kernels)
    print(json.dumps({
        "root": str(root), "rounds": rounds,
        "profiled": {"steps": PROFILED_STEPS,
                     "host_ms_per_step": host_ms / PROFILED_STEPS,
                     "kernel_ms_per_step": device_ms / PROFILED_STEPS,
                     "busy_share": device_ms / host_ms,
                     "top_kernels_ms": [[k[:80], ms] for k, ms in
                                        kernels[:10]]}}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="the checkout to compare with")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the runs' JSON here")
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.child).resolve())
        return
    if not args.other:
        ap.error("give the checkout to compare with")
    other = Path(args.other).resolve()
    print(f"[ab_serving] {card_line()}", flush=True)
    runs = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(root)], capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"ab_serving: the run on {root} failed:\n{out.stderr}")
        run = {"checkout": label, **json.loads(out.stdout.splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    keys = ("tokens_per_s", "decode_step_ms", "prefill_step_ms",
            "ttft_p50_ms", "ttft_p99_ms", "boot_ms", "peak_allocated_gib",
            "peak_reserved_gib")
    summary = {label: {
        **{k: [rd[k] for r in runs if r["checkout"] == label
               for rd in r["rounds"]] for k in keys},
        **{k: [r["profiled"][k] for r in runs if r["checkout"] == label]
           for k in ("host_ms_per_step", "kernel_ms_per_step",
                     "busy_share")}}
        for label in ("other", "this")}
    digests = {rd["tokens_digest"] for r in runs for rd in r["rounds"]}
    summary["same_tokens_everywhere"] = len(digests) == 1
    print(json.dumps({"card": card_line(), "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
