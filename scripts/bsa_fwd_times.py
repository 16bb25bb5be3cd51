#!/usr/bin/env python3
"""Time the block-sparse attention forward (``bsa_fwd``) of a checkout of
the port on one GPU, beside its bound, its plain version and SDPA with
the block mask expanded.

    python3 scripts/bsa_fwd_times.py [CHECKOUT] [--cases abc] [--out FILE]

CHECKOUT (default: this repository) is a directory holding a
``paddle_tpu_torch`` package, for instance a ``git archive`` of another
commit unpacked into the git-ignored ``_parent/``: its kernels are built
from its own sources, so two commits compare on one card in one chip
call, one process each, in turns. The shapes are this repository's
``chip_smoke`` check cases ((a) the sparse block path's, (b) long
context, (c) BigBird-base's head, made from seed 3), each launch is
checked once against the plain version (``chip_smoke.check_terms``, lse
within 1e-5), and each time is ``chip_smoke.time_bsa_case``'s (CUDA
events, median of batches, two input sets). Prints the card's name and
power limit, one line a case and, last, the cases as JSON.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkout", nargs="?", default=str(ROOT))
    ap.add_argument("--cases", default="abc")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    checkout = Path(args.checkout).resolve()
    sys.path.insert(0, str(checkout))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    if checkout not in Path(bsa.__file__).resolve().parents:
        raise SystemExit(f"paddle_tpu_torch came from {bsa.__file__}, "
                         f"not from {checkout}")
    cs.phase_device()
    cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for name in args.cases:
        q, k, v, bm, bq, bk = cs._bsa_case(name, gen)
        tables = bsa.prepare_block_mask(bm, bq, bk)
        t = tables.on(q.device)
        scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = bsa.bsa_fwd(q, k, v, tables)
        o_ref, lse_ref = bsa._bsa_fwd_ref(q, k, v, t["kt"], t["cnt"], scale,
                                          bq, bk)
        cs.check_terms(f"bsa_fwd o ({name})", o, o_ref,
                       cs._bsa_terms(q, k, v, lse_ref, tables, scale))
        cs.check_sum(f"bsa_fwd lse ({name})", lse, lse_ref)
        del q, k, v, o, lse, o_ref, lse_ref
        rows[name] = cs.time_bsa_case(name, gen)
        print(f"[bsa_fwd] ({name}) " + ", ".join(
            f"{key} {x:.5f}" if isinstance(x, float) else f"{key} {x}"
            for key, x in rows[name].items()), flush=True)
    result = {"checkout": str(checkout), "card": cs.card_line(),
              "cases": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(cs.card_line())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
