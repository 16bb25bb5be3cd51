#!/usr/bin/env python3
"""Time the port's unfused GPT-1.3B train step in two checkouts on one GPU.

    python3 scripts/ab_train.py OTHER_CHECKOUT [--out FILE]

Runs the setup of ``chip_smoke.py``'s train phase
(``gpt3_1p3b(fused_ln=True)``, dropout 0, f32 weights from a seeded
generator, one seeded batch of 4 x 1024 tokens,
``to_static(amp_policy="bf16")`` + ``AdamW(1e-4, fused=False)``) on the
``paddle_tpu_torch`` of OTHER_CHECKOUT and on this checkout's, in the
order other, this, this, other, each in a fresh process, with the same
measuring code: the step's wall time (median of steps 2-10), the device
time of forward + loss + backward and of the optimizer by CUDA events,
the host time of the ``opt.step()`` call (medians of 3), and the kernel
time of one step under ``torch.profiler``. Prints one JSON line a run,
then a summary line; exits non-zero if a run fails or the runs' losses
differ (both checkouts must do the same device work).
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


def child(root):
    """One run against the package under ``root``; prints its JSON."""
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
    losses, step_s = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(train_step(ids, labels).item())     # synchronises
        step_s.append(time.perf_counter() - t0)

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

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_step(ids, labels)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    step_ms = statistics.median(step_s[1:]) * 1e3
    print(json.dumps({"root": str(root), "step_ms": step_ms,
                      **{k: statistics.median(v) for k, v in halves.items()},
                      "profiled_kernel_ms": busy_ms,
                      "busy_share": busy_ms / step_ms, "losses": losses}))


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
    print(f"[ab_train] {card_line()}", flush=True)
    runs = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             str(root)], capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"ab_train: the run on {root} failed:\n{out.stderr}")
        run = {"checkout": label, **json.loads(out.stdout.splitlines()[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    if len({tuple(r["losses"]) for r in runs}) != 1:
        sys.exit("ab_train: the runs' losses differ")
    summary = {label: {k: [r[k] for r in runs if r["checkout"] == label]
                       for k in ("step_ms", "fwd_bwd_ms", "opt_ms",
                                 "opt_host_ms", "busy_share")}
               for label in ("other", "this")}
    print(json.dumps({"card": card_line(), "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
