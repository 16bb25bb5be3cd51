#!/usr/bin/env python3
"""Time the LayerNorm forwards (``ln_fwd``, ``ln_res_fwd``) of the port
under several row splits on one GPU.

    python3 scripts/ln_fwd_sweep.py [--out FILE]

For each row count of the main path (8, 16, 512, 1000, 4096 at hidden
2048, bf16; and 4096 rows of bf16 x with f32 weights, the train path's
mix) and each split the kernels take (``(threads, slots, blocks)``,
as ``paddle_tpu_torch.ops.cuda.norm.ln_fwd_split`` returns it), the
kernel's output is checked against its plain version (``chip_smoke``'s
``check_close``) and its time taken by ``chip_smoke.device_ms`` (CUDA
events, inputs cycled through copies larger than L2), beside the byte
bound, ``F.layer_norm``'s time (weights in bf16) and an empty kernel's.
The split that ``ln_fwd_split`` picks is marked. Prints the registers
ptxas gave each instance of the forward kernel, one line a measurement,
and the card's name and power limit; ``--out`` also writes the rows as
JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROWS = (8, 16, 512, 1000, 4096)


def candidates(rows, hidden, sms, picker):
    """The splits tried: ``picker``'s (one wave of resident blocks
    walking the rows), one row a block, and half and twice that wave."""
    picked = picker(rows, hidden, sms)
    threads, slots, wave = picker(1 << 30, hidden, sms)
    out = [picked]
    for blocks in (-(-rows // slots), wave // 2, 2 * wave):
        split = (threads, slots, max(1, min(-(-rows // slots), blocks)))
        if split not in out:
            out.append(split)
    return out, picked


def registers():
    """{kernel instance: registers} for the forward kernel, from ptxas."""
    from paddle_tpu_torch.ops.cuda import build
    regs, name = {}, None
    for line in build.last_build["ptxas"].splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used " in line and name and "ln_fwd_kernel" in name:
            regs[name] = int(line.split("Used ")[1].split()[0])
    return regs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the measurements here as JSON")
    args = ap.parse_args(argv)
    cs.phase_device()
    from paddle_tpu_torch.ops.cuda import build, norm
    build.load_library()
    for name, n in sorted(registers().items()):
        print(f"[sweep] registers {n:3d}  {name}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    floor = cs.device_ms(torch.cuda._sleep, [(0,)])
    print(f"[sweep] launch floor {floor:.5f} ms; {sms} SMs")
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(rows, bf16) for rows in ROWS] + [(4096, f32)]
    hidden, eps = cs.HIDDEN, cs.EPS
    picker = norm.ln_fwd_split
    results = []
    try:
        for rows, wd in cases:
            copies = max(1, min(64, math.ceil(150e6 / (8 * rows * hidden))))
            sets = cs._inputs(rows, bf16, gen, copies, w_dtype=wd)
            lib = cs.device_ms(torch.nn.functional.layer_norm,
                               [(x, (hidden,), w.to(bf16), b.to(bf16), eps)
                                for x, _r, w, b in sets])
            splits, picked = candidates(rows, hidden, sms, picker)
            for split in splits:
                norm.ln_fwd_split = lambda *_a, s=split: s
                x, r, w, b = sets[0]
                cs.check_close(f"ln_fwd sweep {split}", norm.ln_fwd(x, w, b, eps),
                               norm._ln_fwd_ref(x, w, b, eps))
                h, y = norm.ln_res_fwd(x, r, w, b, eps, "gelu")
                h_ref, y_ref = norm._ln_res_fwd_ref(x, r, w, b, eps, "gelu")
                cs.check_close(f"ln_res_fwd sweep {split}", h, h_ref)
                cs.check_close(f"ln_res_fwd sweep {split}", y, y_ref)
                for kernel, fn, inputs, io in (
                        ("ln_fwd", norm.ln_fwd,
                         [(x, w, b, eps) for x, _r, w, b in sets], 4),
                        ("ln_res_fwd", norm.ln_res_fwd,
                         [(x, r, w, b, eps) for x, r, w, b in sets], 8)):
                    ms = cs.device_ms(fn, inputs)
                    bound = (io * rows * hidden + 2 * hidden * wd.itemsize) \
                        / cs.HBM_BYTES_PER_S * 1e3
                    row = {"kernel": kernel, "rows": rows,
                           "weights": str(wd).split(".")[1],
                           "split": list(split), "picked": split == picked,
                           "ms": ms, "bound_ms": bound,
                           "library_ms": lib if kernel == "ln_fwd" else None,
                           "launch_floor_ms": floor}
                    results.append(row)
                    print(f"[sweep] {kernel:10s} rows {rows:5d} w "
                          f"{row['weights']:8s} split {split}"
                          f"{' (picked)' if row['picked'] else ''}: "
                          f"{ms:.5f} ms, {100 * bound / ms:.0f} % of the "
                          f"bound {bound:.5f}"
                          + (f"; F.layer_norm {lib:.5f}" if kernel == "ln_fwd"
                             else ""), flush=True)
    finally:
        norm.ln_fwd_split = picker
    card = cs.card_line()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": results},
                                             indent=1))


if __name__ == "__main__":
    main()
