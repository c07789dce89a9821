"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload yi-9b.decode --seed 7 --seconds 30 --trace 0

From the root of a checkout: the port is ``src/repro_torch``; its kernels
build at first use into ``build/kernels/`` there.  The cell's traffic is
``portbench/workloads/<cell>.json``, its driver ``portbench/drivers/<kind>.py``,
its configuration the file its entry in ``BENCHMARK.json`` names, and each
per-layer metric ``portbench/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit,
which also end standard error.  Without enough CUDA cards, or if JAX or the
JAX package is loaded once the window has closed, it prints no result and
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _age_at_t0() -> float:
    """Seconds from this process's start to ``_T0`` (the interpreter's own
    start-up included), from ``/proc``; 0 where that cannot be read."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start - (time.perf_counter() - _T0))
    except (OSError, ValueError, IndexError):
        return 0.0


_START = _T0 - _age_at_t0()


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / "out" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "portbench" / "out" / "torch_extensions")


def execute(name: str, wl: dict, cfg: dict, *, seed: int, seconds: float, trace: bool,
            device, e2e: list, per_layer: list, chips: int = 1, controls: bool = False):
    """Run the cell and return ``(result, driver output)``: the result's
    ``metrics`` are ``e2e``'s (``per_layer``'s with ``trace``)."""
    import torch

    from portbench.drivers import Run
    from portbench.lib import cell, judge
    from portbench.lib.trace import breakdown

    r = Run(name=name, workload=wl, config=cfg, seed=seed, seconds=seconds, trace=trace,
            device=device, out_dir=ROOT / "portbench" / "out", controls=controls)
    r.mark("imports")
    out = cell.driver(wl["driver"]).run(r)
    r.marks["window"] = out["window_start"]
    print("portbench: set-up phases end at " + ", ".join(
        f"{k} {v - _START:.3f} s" for k, v in r.marks.items()), file=sys.stderr, flush=True)
    metrics = {}
    if trace:
        for m in per_layer:
            v = cell.reader(m["name"])(out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["window_start"] - _START)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    ok, checks = judge.verdict(out["numbers"], wl["check"]["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": ok, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        t = out["trace"]
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = breakdown(t)
    result["checks"] = checks
    return result, out


def loaded_forbidden(modules=None) -> list[str]:
    """Top-level names of loaded modules (``sys.modules`` by default) that
    are JAX or the JAX package (whole names: ``repro_torch`` is not
    ``repro``)."""
    return sorted({k.split(".")[0] for k in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from portbench.lib import cell, judge

    bench = cell.load_benchmark()
    entry = cell.cell_entry(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations are fp32
    torch.backends.cudnn.allow_tf32 = False
    result, _ = execute(args.workload, cell.workload(args.workload),
                        cell.config(bench, entry["config"]), seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace),
                        device=torch.device("cuda", 0), e2e=cell.end_to_end(bench, args.workload),
                        per_layer=cell.per_layer(bench, args.workload), chips=entry["chips"])
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad} in the process that prints the result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    judge.print_checks(result["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
