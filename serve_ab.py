#!/usr/bin/env python3
"""Same-card A/B of the PyTorch/CUDA port between two source trees.

    python3 serve_ab.py --a OLD/src --b src [--workload lm|runner] [--rounds 4]
                        [--serves 2] [--reps 5]

Each of ``--a`` and ``--b`` is a ``src`` directory that holds ``repro_torch``
(for example an older commit unpacked with ``git archive``).  The script runs
one worker process per tree in the order a, b, b, a, a, b, ... (``--rounds``
pairs); alternating the trees within one call spreads the shared host's drift
over both.  TF32 is off in every worker.  ``--workload`` picks what a worker
times:

* ``lm`` (default): serves yi-9b at full width and depth ``--serves`` times:
  fp32, 8 requests in 4 slots, prompt 512, 16 new tokens, as
  ``chip_smoke.py`` phase 3 does; decode and prefill seconds per serve.
* ``runner``: ``StreamedRunner.run`` (H2D, kernels, D2H of every slice; the
  min of ``--reps``) on the cells below, at each program's largest dataset,
  with ``host-sync`` and ``host-pipelined``; milliseconds per cell.

Every measurement prints one JSON line; the end gives, per cell, metric and
tree, the median and range, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ARCH, N_REQ, SLOTS, PROMPT, GEN = "yi-9b", 8, 4, 512, 16
# (program, partitions, tasks): the fewest and the most slices of vecadd,
# binomial's launch train, and two mid-grid splits
CELLS = (("vecadd", 1, 1), ("vecadd", 32, 64), ("binomial", 1, 1),
         ("mvmult", 4, 8), ("jacobi-1d", 1, 1), ("jacobi-1d", 2, 16))
BACKENDS = ("host-sync", "host-pipelined")
METRICS = {"lm": ("decode_s", "prefill_s"), "runner": ("ms",)}


def lm_worker(label: str, args) -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve

    _build.build_all()
    for i in range(args.serves):
        res = serve(ARCH, reduced=False, n_requests=N_REQ, batch_slots=SLOTS,
                    prompt_len=PROMPT, gen_len=GEN, device="cuda", verbose=False)
        if not res.logits_finite:
            raise SystemExit(f"{label}: non-finite logits")
        print(json.dumps({"tree": label, "cell": f"{ARCH} serve", "serve": i,
                          "wall_s": res.wall_s, "prefill_s": res.prefill_s,
                          "decode_s": res.wall_s - res.prefill_s,
                          "tokens_per_s": res.tokens_per_s}), flush=True)
        del res
        torch.cuda.empty_cache()


def runner_worker(label: str, args) -> None:
    import numpy as np

    from repro_torch.core.stream_config import StreamConfig
    from repro_torch.core.streams import StreamedRunner
    from repro_torch.core.workloads import get_workload

    for name, p, t in CELLS:
        wl = get_workload(name)
        chunked, shared = wl.make_data(wl.datasets[-1], np.random.default_rng(0))
        for backend in BACKENDS:
            runner = StreamedRunner(wl, chunked, shared, device="cuda", backend=backend)
            ms = runner.run(StreamConfig(p, t), reps=args.reps) * 1e3
            print(json.dumps({"tree": label, "cell": f"{name}@{wl.datasets[-1]} ({p}, {t}) "
                              f"{backend}", "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="src directory of tree a")
    ap.add_argument("--b", help="src directory of tree b")
    ap.add_argument("--workload", choices=sorted(METRICS), default="lm")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--serves", type=int, default=2, help="lm: serves per worker")
    ap.add_argument("--reps", type=int, default=5, help="runner: runs per cell, min taken")
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        src, label = args.worker
        sys.path.insert(0, os.path.abspath(src))
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        (lm_worker if args.workload == "lm" else runner_worker)(label, args)
        return 0
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    trees = {"a": args.a, "b": args.b}
    for path in trees.values():
        if not os.path.isdir(os.path.join(path, "repro_torch")):
            raise SystemExit(f"no repro_torch under {path}")
    rows = []
    for r in range(args.rounds):
        for label in ("ab" if r % 2 == 0 else "ba"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
                 "--serves", str(args.serves), "--reps", str(args.reps),
                 "--worker", trees[label], label],
                capture_output=True, text=True)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode != 0:
                raise SystemExit(f"worker {label} failed with {out.returncode}")
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    rows.append(json.loads(line))
    for cell in dict.fromkeys(r["cell"] for r in rows):
        for metric in METRICS[args.workload]:
            parts = []
            for label in trees:
                vals = [r[metric] for r in rows if r["tree"] == label and r["cell"] == cell]
                parts.append(f"{label} median {statistics.median(vals):.4f} "
                             f"({min(vals):.4f}-{max(vals):.4f}, n={len(vals)})")
            print(f"{cell:40s} {metric:9s} " + ", ".join(parts))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
