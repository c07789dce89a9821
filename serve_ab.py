#!/usr/bin/env python3
"""Serve-time A/B of the PyTorch/CUDA port between two source trees on one card.

    python3 serve_ab.py --a OLD/src --b src [--rounds 4] [--serves 2]

Each of ``--a`` and ``--b`` is a ``src`` directory that holds ``repro_torch``
(for example an older commit unpacked with ``git archive``).  The script runs
one worker process per tree in the order a, b, b, a, a, b, ... (``--rounds``
pairs), and each worker serves yi-9b at full width and depth ``--serves``
times: fp32, 8 requests in 4 slots, prompt 512, 16 new tokens, as
``chip_smoke.py`` phase 3 does, with TF32 off.  Every serve prints one JSON
line; the end gives, per tree, the median and range of decode and prefill
seconds, then the card's name and power limit.  Alternating the trees within
one call spreads the shared host's drift over both.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ARCH, N_REQ, SLOTS, PROMPT, GEN = "yi-9b", 8, 4, 512, 16


def worker(src: str, label: str, serves: int) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    for i in range(serves):
        res = serve(ARCH, reduced=False, n_requests=N_REQ, batch_slots=SLOTS,
                    prompt_len=PROMPT, gen_len=GEN, device="cuda", verbose=False)
        if not res.logits_finite:
            raise SystemExit(f"{label}: non-finite logits")
        print(json.dumps({"tree": label, "serve": i, "wall_s": res.wall_s,
                          "prefill_s": res.prefill_s,
                          "decode_s": res.wall_s - res.prefill_s,
                          "tokens_per_s": res.tokens_per_s}), flush=True)
        del res
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="src directory of tree a")
    ap.add_argument("--b", required=True, help="src directory of tree b")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--serves", type=int, default=2)
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.serves)
        return 0
    trees = {"a": args.a, "b": args.b}
    for path in trees.values():
        if not os.path.isdir(os.path.join(path, "repro_torch")):
            raise SystemExit(f"no repro_torch under {path}")
    runs = []
    for r in range(args.rounds):
        for label in ("ab" if r % 2 == 0 else "ba"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--a", args.a, "--b", args.b,
                 "--serves", str(args.serves), "--worker", trees[label], label],
                capture_output=True, text=True)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode != 0:
                raise SystemExit(f"worker {label} failed with {out.returncode}")
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    runs.append(json.loads(line))
    for label, path in trees.items():
        mine = [r for r in runs if r["tree"] == label]
        summary = {"tree": label, "src": path, "serves": len(mine)}
        for key in ("decode_s", "prefill_s"):
            vals = [r[key] for r in mine]
            summary[key] = {"median": statistics.median(vals), "min": min(vals),
                            "max": max(vals)}
        print(json.dumps(summary))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
