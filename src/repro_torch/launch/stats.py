"""Serving stats CLI: render telemetry JSONL + metrics snapshots as a
terminal summary.

    python -m repro_torch.launch.stats --telemetry telemetry.jsonl
    python -m repro_torch.launch.stats --metrics metrics.json
    python -m repro_torch.launch.stats --telemetry t.jsonl --follow

``--telemetry`` reads the per-request JSONL stream the schedulers append
(:class:`repro_torch.serving.TelemetryLog`) and prints the aggregate view:
request/hit/refinement counts, the latency tail, SLO violations, mean
prediction error per workload, and the per-tenant breakdown.
``--metrics`` reads a :meth:`MetricsRegistry.save` snapshot and prints
every family (counters/gauges inline, histograms as count/mean/max).
``--follow`` re-reads and re-renders every ``--interval`` seconds —
`watch(1)` for a live serving process, surviving partial trailing lines
(the line-buffered log may be mid-write).

The pure :func:`render` function is the testable core: samples + an
optional metrics snapshot in, the formatted report string out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from repro_torch.serving.telemetry import TelemetryLog, TelemetrySample


def read_telemetry(path: str) -> list[TelemetrySample]:
    """Tolerant JSONL read: a truncated trailing line (the serving
    process is mid-append) is skipped, not fatal."""
    out: list[TelemetrySample] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(TelemetrySample.from_json(json.loads(line)))
            except (json.JSONDecodeError, TypeError):
                continue
    return out


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.3f}s"


_BREAKER_STATES = {0: "closed", 1: "half-open", 2: "open"}


def _render_resilience(metrics: dict) -> list[str]:
    """The fault-tolerance dashboard block: injected / recovered /
    degraded totals and the per-(tenant, stage) circuit-breaker states
    (``serving.breaker.state`` gauges encode 0=closed, 1=half-open,
    2=open)."""
    lines: list[str] = []

    def total(name: str) -> int:
        return int(sum(v["value"] for v in
                       metrics.get(name, {}).get("values", [])))

    counts = {short: total(f"serving.faults.{short}")
              for short in ("injected", "recovered", "degraded")}
    counts["watchdog"] = total("serving.watchdog.fired")
    counts["failed"] = total("serving.requests.failed")
    if any(counts.values()):
        lines.append("faults   " + "  ".join(
            f"{k} {v}" for k, v in counts.items()))
    for entry in metrics.get("serving.breaker.state", {}).get("values", []):
        sel = entry["labels"]
        state = _BREAKER_STATES.get(int(entry["value"]),
                                    str(entry["value"]))
        lines.append(f"breaker  {sel.get('tenant', '?'):<12s} "
                     f"{sel.get('stage', '?'):<10s} {state}")
    return lines


def render(samples: list[TelemetrySample],
           metrics: Optional[dict] = None) -> str:
    """The report string for a sample list + optional metrics snapshot
    (the dict shape :meth:`MetricsRegistry.snapshot` returns)."""
    lines: list[str] = []
    log = TelemetryLog()
    log.samples = list(samples)
    s = log.summary()
    lines.append("== serving telemetry ==")
    lines.append(f"requests {s['requests']}  "
                 f"cache_hits {s['cache_hits']} "
                 f"(hit_rate {s['hit_rate']:.2f})  "
                 f"refinements {s['refinements']}")
    lat = s["latency"]
    if lat is not None:
        lines.append(f"latency  p50 {_fmt_s(lat['p50_s'])}  "
                     f"p95 {_fmt_s(lat['p95_s'])}  "
                     f"p99 {_fmt_s(lat['p99_s'])}  "
                     f"max {_fmt_s(lat['max_s'])}")
    else:
        lines.append("latency  (no retired requests)")
    if s["slo_violation_rate"] is not None:
        lines.append(f"slo      violations {s['slo_violations']} "
                     f"(rate {s['slo_violation_rate']:.3f})")
    if s["mean_rel_error"] is not None:
        lines.append(f"rel_err  mean {s['mean_rel_error']:.3f}")
        for w, e in s["mean_rel_error_by_workload"].items():
            lines.append(f"         {w:<20s} {e:.3f}")
    for name, t in s["per_tenant"].items():
        err = (f"{t['mean_rel_error']:.3f}"
               if t["mean_rel_error"] is not None else "-")
        lines.append(f"tenant   {name:<12s} served {t['requests']:<6d} "
                     f"hits {t['cache_hits']:<6d} "
                     f"refines {t['refinements']:<3d} err {err}")
    by_status = s.get("by_status") or {}
    if set(by_status) - {"ok"}:
        lines.append("status   " + "  ".join(
            f"{k} {by_status[k]}"
            for k in ("ok", "degraded", "failed", "timeout")
            if by_status.get(k)))
    if metrics:
        res = _render_resilience(metrics)
        if res:
            lines.append("== resilience ==")
            lines.extend(res)
        lines.append("== metrics ==")
        for name in sorted(metrics):
            fam = metrics[name]
            for entry in fam["values"]:
                sel = ",".join(f"{k}={v}" for k, v in
                               sorted(entry["labels"].items()))
                label = f"{name}{{{sel}}}" if sel else name
                v = entry["value"]
                if fam["type"] == "histogram":
                    mean = v["mean"]
                    lines.append(
                        f"{label:<44s} count {v['count']:<8d} "
                        f"mean {_fmt_s(mean)} max {_fmt_s(v['max'])}")
                else:
                    val = (f"{v:g}" if isinstance(v, float) else str(v))
                    lines.append(f"{label:<44s} {val}")
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="render serving telemetry/metrics artifacts")
    ap.add_argument("--telemetry", default=None,
                    help="per-request telemetry JSONL path")
    ap.add_argument("--metrics", default=None,
                    help="MetricsRegistry snapshot JSON path")
    ap.add_argument("--follow", action="store_true",
                    help="re-render every --interval seconds")
    ap.add_argument("--interval", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not args.telemetry and not args.metrics:
        ap.error("give --telemetry and/or --metrics")

    def once() -> str:
        samples = (read_telemetry(args.telemetry)
                   if args.telemetry and os.path.exists(args.telemetry)
                   else [])
        metrics = None
        if args.metrics and os.path.exists(args.metrics):
            with open(args.metrics) as f:
                metrics = json.load(f)
        return render(samples, metrics)

    try:
        if not args.follow:
            print(once())
            return
        while True:
            print("\x1b[2J\x1b[H" + once(), flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print("", file=sys.stderr)
    except BrokenPipeError:
        # reader (head, less) closed the pipe — normal CLI exit, but
        # devnull-dup stdout so the interpreter's flush-at-exit is quiet
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


if __name__ == "__main__":
    main()
