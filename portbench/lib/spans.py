"""Device time by the program's own spans, read from the host-ops chrome
trace that ``lib/trace.traced`` writes for the second traced stretch.

The port opens profiler ranges at its layer boundaries while a profiler
runs (``repro_torch.spans``): ``PROGRAM_SPANS``.  They land in the trace
as ``cpu_op`` events, on the clock of the kernels.  Each kernel, copy and
memset inside the ``TRACE_RANGE`` range leads by its ``args.correlation``
to the ``cuda_runtime`` or ``cuda_driver`` event that launched it, and
goes to the innermost program span that holds that launch on the
launching thread; a device op with no such span is unattributed.  Nothing
here imports the port.
"""
from __future__ import annotations

import json
from collections import defaultdict

from portbench.lib import cell
from portbench.lib.trace import DEVICE_CATS, TRACE_RANGE

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PROGRAM_SPANS = ("model.prefill", "model.decode_step", "attn.decode", "optim.apply_updates")


def _innermost(spans: list, points: list) -> dict:
    """{point: name} of the innermost of ``spans`` ((start, end, name),
    properly nested, one thread) that holds each point; points outside
    every span are left out."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for p in sorted(set(points)):
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        if stack:
            out[p] = stack[-1][2]
    return out


def attribute(events: list):
    """``{"device_s": {span: seconds}, "count": {span: n},
    "unattributed_s": seconds}`` of a chrome trace's events inside the
    ``TRACE_RANGE`` range: each device op's duration under the innermost
    program span holding its launch, and the number of each program span
    that starts in the range.  None where the trace has no such range or
    no device op in it (a trace of the CPU)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e["name"] == TRACE_RANGE and e.get("cat") == "user_annotation"]
    if not win:
        return None
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans, count = defaultdict(list), defaultdict(int)
    for e in xs:
        if (e["name"] in PROGRAM_SPANS and e.get("cat") == "cpu_op"
                and t0 <= e["ts"] <= t1):
            spans[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"], e["name"]))
            count[e["name"]] += 1
    launch = {e["args"]["correlation"]: ((e["pid"], e["tid"]), e["ts"]) for e in xs
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = [(launch.get(e.get("args", {}).get("correlation")), e) for e in xs
           if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] < t1]
    if not ops:
        return None
    points = defaultdict(list)
    for at, _ in ops:
        if at is not None:
            points[at[0]].append(at[1])
    owner = {thread: _innermost(spans[thread], ps) for thread, ps in points.items()}
    device_s, unattributed = defaultdict(float), 0.0
    for at, e in ops:
        name = owner[at[0]].get(at[1]) if at is not None else None
        if name is None:
            unattributed += e["dur"] / 1e6
        else:
            device_s[name] += e["dur"] / 1e6
    return {"device_s": dict(device_s), "count": dict(count), "unattributed_s": unattributed}


def of_record(rec: dict):
    """``attribute`` of the host-ops trace of the run ``rec`` records; None
    where the run was not traced or its trace file is missing."""
    if not rec.get("trace"):
        return None
    path = cell.BENCH / "out" / f"{rec['workload']['name']}.host.json"
    if not path.exists():
        return None
    with open(path) as f:
        return attribute(json.load(f)["traceEvents"])


def per_step_ms(rec: dict, names: tuple, step: str):
    """Milliseconds of device time under the spans ``names`` for each
    ``step`` span of the traced stretch; None where there is no trace or no
    ``step`` span."""
    a = of_record(rec)
    if a is None or not a["count"].get(step):
        return None
    return 1e3 * sum(a["device_s"].get(n, 0.0) for n in names) / a["count"][step]
