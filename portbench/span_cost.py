"""What the port's spans cost a decode step.

    python3 portbench/span_cost.py [--stretches 4] [--steps 16] [--tiny]

runs the yi-9b.decode cell's set-up, then stretches of decode steps in
turns under no profiler, a profiler of device activity only and one of host
ops too, and prints one JSON object: each mode's host ms a ``decode_step``
call (the median of each stretch) and wall ms a step, and, in each mode,
the host cost of one empty span (``repro_torch.spans.span``; left out where
the tree has none).  Run it from a checkout without the program's spans,
with this file copied in, for the same numbers without them.  ``--tiny``
runs it on the CPU at the tests' size.  The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

from portbench import run  # noqa: E402
from portbench.lib import cell  # noqa: E402

MODES = ("none", "device", "host")


def _span_us(span, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with span("x"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def cost(tiny: bool, stretches: int, steps: int) -> dict:
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers import port
    from portbench.drivers.serve import Server
    from portbench.lib import family, weights

    try:
        from repro_torch.spans import span
    except ImportError:  # a tree without the program's spans
        span = None
    if tiny:
        from portbench.tests import tiny as small

        wl, cfg, dev = small.workload("yi-9b.decode"), small.config(), torch.device("cpu")
    else:
        wl = cell.workload("yi-9b.decode")
        cfg, dev = cell.config(cell.load_benchmark(), "yi-9b"), torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = {"device": [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU],
            "host": [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])}
    seed = 2**33 + 977
    fam = family.of(cfg)
    dm = fam.dims(cfg)
    srv = Server(port.model(fam, dm, cfg, dev), weights.make(fam, dm, seed, dev), fam, dm, wl,
                 seed, dev)
    res = {m: {"host_ms": [], "wall_ms": [], "span_us": []} for m in MODES}
    n = 2000 if tiny else 20000
    with torch.inference_mode():
        srv.boundaries(wl["setup_boundaries"])
        for rep in range(stretches):
            for mode in MODES[::-1] if rep % 2 else MODES:
                ctx = (profile(activities=acts[mode]) if mode in acts
                       else contextlib.nullcontext())
                with ctx:
                    sync()
                    t0 = time.perf_counter()
                    units = srv.boundaries(steps)
                    sync()
                    wall = time.perf_counter() - t0
                    if span is not None:
                        res[mode]["span_us"].append(_span_us(span, n))
                host = [u["host_s"] for u in units if u["kind"] == "decode"]
                res[mode]["host_ms"].append(statistics.median(host) * 1e3)
                res[mode]["wall_ms"].append(wall / len(units) * 1e3)
    return {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "spans": span is not None, "steps_a_stretch": steps,
            "modes": {m: dict(v, host_ms_median=statistics.median(v["host_ms"]),
                              wall_ms_median=statistics.median(v["wall_ms"]))
                      for m, v in res.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stretches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    run._caches()
    import torch

    if not args.tiny and not torch.cuda.is_available():
        print("span_cost: needs a CUDA card (or --tiny)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(cost(args.tiny, args.stretches, args.steps), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
