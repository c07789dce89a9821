"""Readings that set a cell's limits: the program's numbers on many seeds,
and the control's (the reference in TF32 in the program's place) and, for
training, the planted faults', each against the fp32 reference, all in one
process on the card.

    python3 portbench/calibrate.py --workload yi-9b.decode --seeds 11,12,13 \\
        --seconds 30 --controls 2

prints one JSON line a seed: the numbers, the readings (on the first
``--controls`` seeds), the window's end-to-end numbers and the seconds of
set-up.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="read the control (and faults) on the first N seeds")
    args = ap.parse_args(argv)
    run._caches()
    import torch

    from portbench.lib import cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cell.load_benchmark()
    entry = cell.cell_entry(bench, args.workload)
    wl, cfg = cell.workload(args.workload), cell.config(bench, entry["config"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, out = run.execute(args.workload, wl, cfg, seed=seed, seconds=args.seconds,
                               trace=False, device=torch.device("cuda", 0),
                               e2e=[], per_layer=[], controls=i < args.controls)
        print(json.dumps({"seed": seed, "correct": res["correct"], "numbers": out["numbers"],
                          "readings": out["readings"], "e2e": out["e2e"],
                          "setup_s": out["window_start"] - t0,
                          "seconds": time.perf_counter() - t0,
                          "memory_peak_bytes": out["memory_peak_bytes"]}), flush=True)
        del res, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
