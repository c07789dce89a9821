"""The profiler's trace of a stretch of the run, reduced to what the
per-layer readers and the result's ``breakdown`` need.

A traced run profiles two stretches of its traffic after the window.  The
first records device activity only, so the host runs at nearly its
untraced speed: its wall time (host clock, a synchronize at each end) is
the traced window, and the union of its kernel, copy and memset intervals
on every stream is the device's busy time.  The second records host ops
too, inside one ``record_function`` range (``TRACE_RANGE``), and names
each of its device-idle gaps by what the host was doing then; recording
every host op slows a host-bound step by a third, so it gives only these
names.  Each chrome trace goes to a fixed file under ``portbench/out/``
(overwritten by the next traced run) and is read back.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import re
import time
from pathlib import Path

TRACE_RANGE = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profiled(torch, device, path: Path, holder: dict, *, host: bool):
    """Profile the body; afterwards ``holder["trace"]`` is ``reduce``'s
    result for it.  ``host`` also records host ops (the second stretch).
    On the CPU, where tests run it, the trace has no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(TRACE_RANGE):
            yield
            sync()
        wall = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        holder["trace"] = reduce(json.load(f)["traceEvents"], wall)


def traced(r, stretch) -> tuple[dict, object]:
    """Run ``stretch()`` twice, first under device-only profiling, then
    with host ops recorded.  Returns the first stretch's reduction with the
    second one's named gaps, and what the first stretch returned."""
    import torch

    dev, host = {}, {}
    with profiled(torch, r.device, r.out_dir / f"{r.name}.device.json", dev, host=False):
        ran = stretch()
    with profiled(torch, r.device, r.out_dir / f"{r.name}.host.json", host, host=True):
        stretch()
    return dict(dev["trace"], gaps=host["trace"]["gaps"]), ran


def kernel_name(name: str) -> str:
    """A device op's name without ``void``, anonymous namespaces, its
    arguments and its template arguments: ``flash_fwd_kernel``,
    ``at::native::elementwise_kernel``, ``Memcpy DtoD``."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    m = re.match(r"[\w:]+", name)
    return m.group(0) if m else name


def _union(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def reduce(events: list, wall_s: float) -> dict:
    """``{"window_s", "busy_s", "ops": [(name, start_s, dur_s)],
    "gaps": [(label, dur_s)]}`` of a chrome trace's events (times in
    seconds from the window's start).  The window is the ``TRACE_RANGE``
    host range where the trace has it, else ``wall_s`` from the first
    device op; gaps are named only where host ops were recorded."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e["name"] == TRACE_RANGE and e.get("cat") == "user_annotation"]
    if win:
        t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        starts = [e["ts"] for e in xs if e.get("cat") in DEVICE_CATS]
        t0 = min(starts) if starts else 0.0
        t1 = t0 + wall_s * 1e6
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                 if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] < t1)
    spans = [(a, min(b, t1)) for a, b, _ in dev]
    busy = _union(spans)
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                 if e.get("cat") == "cpu_op" and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
              if e.get("cat") == "user_annotation" and e["name"] != TRACE_RANGE]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "ops": [(n, (a - t0) / 1e6, (b - a) / 1e6) for a, b, n in dev],
            "gaps": _gaps(spans, ops, ranges, t0, t1) if win else []}


def _gaps(spans, ops, ranges, t0, t1) -> list:
    """Every idle interval of the window, named by the harness's range the
    host was in at its midpoint and the innermost host op running then
    (``<range>/<op>``; ``harness`` outside every range, ``host`` where no op
    ran)."""
    idle, end = [], t0
    for a, b in spans:
        if a > end:
            idle.append((end, a))
        end = max(end, b)
    if end < t1:
        idle.append((end, t1))
    starts = [o[0] for o in ops]
    out = []
    for a, b in idle:
        mid = (a + b) / 2
        outer = next((n for s, e, n in ranges if s <= mid <= e), "harness")
        inner = "host"
        # the innermost op is the latest-starting one still running
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 2000, -1), -1):
            if ops[j][1] >= mid:
                inner = ops[j][2]
                break
        out.append((f"{outer}/{inner}", (b - a) / 1e6))
    return out


def top(pairs, n: int = 10) -> list:
    """The ``n`` names with the largest summed seconds, largest first."""
    sums: dict = {}
    for name, s in pairs:
        sums[name] = sums.get(name, 0.0) + s
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: dict) -> dict:
    return {"device_ops": top((kernel_name(n), d) for n, _, d in trace["ops"]),
            "idle_gaps": top(trace["gaps"])}
