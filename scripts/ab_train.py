#!/usr/bin/env python3
"""Time the port's GPT-1.3B train step in two checkouts on one GPU.

    python3 scripts/ab_train.py OTHER_CHECKOUT [--path unfused|guarded|fused]
                                [--out FILE]

Runs the setup of ``chip_smoke.py``'s train phases
(``gpt3_1p3b(fused_ln=True)``, dropout 0, f32 weights from a seeded
generator, one seeded batch of 4 x 1024 tokens,
``to_static(amp_policy="bf16")``) with the path's optimizer:
``unfused`` (the default) ``AdamW(1e-4, fused=False)``; ``guarded``
``AdamW(1e-4, fused=True, guard=True)`` under ``to_static(guard=True)``,
each step ending with the guard summary's read; ``fused``
``AdamW(1e-4, fused=True)``. It runs on the ``paddle_tpu_torch`` of
OTHER_CHECKOUT and on this checkout's, in the order other, this, this,
other, each in a fresh process, with the same measuring code: the
step's wall time (median of steps 2-10) and tokens/s, the first call's
time, the peak memory (allocated and reserved) of the first call and of
the steps after it, the device time of forward + loss + backward and of
the optimizer by CUDA events and the host time of the ``opt.step()``
call (medians of 3, run eagerly), and the kernel time and count of one
step under ``torch.profiler``. On the guarded path also the rank-1
guarded loop (every parameter the fused kernel does not take, through
``Optimizer._guarded_update``): its kernels in one eager run under the
profiler, and its device time as one CUDA graph replay (CUDA events,
median of 5). Prints one JSON line a run, then a summary line; exits
non-zero if a run fails or the runs' losses differ (both checkouts must
do the same device work).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
B, S, STEPS = 4, 1024, 10


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def child(root, path):
    """One run of ``path`` against the package under ``root``; prints its
    JSON."""
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import build
    if not Path(pt.__file__).resolve().is_relative_to(root):
        sys.exit(f"ab_train: imported {pt.__file__}, not from {root}")
    build.load_library()
    cfg = gpt3_1p3b(fused_ln=True, dropout=0.0, attention_dropout=0.0)
    vocab = cfg.vocab_size
    model = GPTForCausalLM(cfg, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))
    model.train()
    guard = path == "guarded"
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters(),
                             fused=path != "unfused", guard=guard)

    @pt.jit.to_static(amp_policy="bf16", guard=guard)
    def train_step(ids, labels):
        opt.clear_grad()
        logits = model(ids)
        loss = F.cross_entropy(logits.reshape([-1, vocab]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    def step():
        loss = train_step(ids, labels).item()             # synchronises
        if guard:
            opt.guard_summary()
        return loss

    data = torch.Generator("cuda").manual_seed(1)
    ids = torch.randint(0, vocab, (B, S), device="cuda", generator=data)
    labels = torch.randint(0, vocab, (B, S), device="cuda", generator=data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            first_peak = (torch.cuda.max_memory_allocated() / 2**30,
                          torch.cuda.max_memory_reserved() / 2**30)
            torch.cuda.reset_peak_memory_stats()
    steady_peak = (torch.cuda.max_memory_allocated() / 2**30,
                   torch.cuda.max_memory_reserved() / 2**30)

    from torch.profiler import ProfilerActivity, profile

    def kernels(fn):
        """(kernel ms, kernel count) of ``fn()`` under the profiler."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in events) / 1e3,
                sum(e.count for e in events))

    busy_ms, n_kernels = kernels(step)
    step_ms = statistics.median(step_s[1:]) * 1e3
    run = {"root": str(root), "path": path, "step_ms": step_ms,
           "tokens_per_s": B * S / step_ms * 1e3,
           "first_ms": step_s[0] * 1e3,
           "first_peak_gib": first_peak, "steady_peak_gib": steady_peak,
           "profiled_kernel_ms": busy_ms, "profiled_kernels": n_kernels,
           "busy_share": busy_ms / step_ms}
    if guard:
        run.update(rank1_loop(torch, opt, kernels))

    halves = {"fwd_bwd_ms": [], "opt_ms": [], "opt_host_ms": []}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        opt.clear_grad()
        ev[0].record()
        with pt.amp.activation_residency("bf16"):
            F.cross_entropy(model(ids).reshape([-1, vocab]),
                            labels.reshape([-1])).backward()
        ev[1].record()
        t0 = time.perf_counter()
        opt.step()
        halves["opt_host_ms"].append((time.perf_counter() - t0) * 1e3)
        ev[2].record()
        ev[2].synchronize()
        halves["fwd_bwd_ms"].append(ev[0].elapsed_time(ev[1]))
        halves["opt_ms"].append(ev[1].elapsed_time(ev[2]))
    run.update({k: statistics.median(v) for k, v in halves.items()})
    print(json.dumps({**run, "losses": losses}))


def rank1_loop(torch, opt, kernels):
    """The guarded loop over the parameters the fused kernel does not
    take (the rank-1 ones), on their last gradients: its kernels in one
    eager run, and its device time replayed as one CUDA graph. It
    updates those parameters: run it after the timed steps."""
    params = [p for p in opt._params()
              if p.grad is not None and not opt._will_fuse(p)]

    def loop():
        opt._guard_parts, opt._guard_bad, opt._guard_regions = [], [], 0
        if hasattr(opt, "_begin_step"):
            opt._begin_step()
        with torch.no_grad():
            for p in params:
                opt._guarded_update(p, p.grad)

    eager_ms, n = kernels(loop)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        loop()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    times = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        graph.replay()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    graph.reset()
    return {"rank1_params": len(params), "rank1_kernels": n,
            "rank1_eager_kernel_ms": eager_ms,
            "rank1_replay_ms": statistics.median(times)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="the checkout to compare with")
    ap.add_argument("--path", choices=("unfused", "guarded", "fused"),
                    default="unfused", help="the train path to time")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="also write the runs' JSON here")
    args = ap.parse_args(argv)
    if args.child:
        child(Path(args.child).resolve(), args.path)
        return
    if not args.other:
        ap.error("give the checkout to compare with")
    other = Path(args.other).resolve()
    print(f"[ab_train] {card_line()}; path {args.path}", flush=True)
    runs = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(root), "--path", args.path], capture_output=True,
            text=True)
        if out.returncode:
            sys.exit(f"ab_train: the run on {root} failed:\n{out.stderr}")
        run = {"checkout": label, **json.loads(out.stdout.splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    if len({tuple(r["losses"]) for r in runs}) != 1:
        sys.exit("ab_train: the runs' losses differ")
    keys = ("step_ms", "tokens_per_s", "first_ms", "first_peak_gib",
            "steady_peak_gib", "profiled_kernel_ms", "profiled_kernels",
            "busy_share", "fwd_bwd_ms", "opt_ms", "opt_host_ms",
            "rank1_kernels", "rank1_eager_kernel_ms", "rank1_replay_ms")
    summary = {label: {k: [r[k] for r in runs if r["checkout"] == label]
                       for k in keys if k in runs[0]}
               for label in ("other", "this")}
    print(json.dumps({"card": card_line(), "path": args.path,
                      "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
