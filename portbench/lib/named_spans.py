"""Device time by program spans named by the caller, read from the
host-ops chrome trace that ``lib/trace.traced`` writes for the second
traced stretch: ``lib/spans.py``'s attribution (each device op through
its ``correlation`` id to its launch, and to the innermost of the spans
that holds the launch on the launching thread), over any set of span
names, and optionally only for the ops launched inside a ``within`` span.
Nothing here imports the port.
"""
from __future__ import annotations

import json
from collections import defaultdict

from portbench.lib import cell
from portbench.lib.spans import LAUNCH_CATS, _innermost
from portbench.lib.trace import DEVICE_CATS, TRACE_RANGE

# the spans a decode step opens in the port (``repro_torch.spans``)
DECODE_SPANS = ("model.decode_step", "attn.decode", "moe.ffn", "mamba.mixer")


def attribute(events: list, names: tuple, within: str | None = None):
    """``{"device_s": {span: seconds}, "count": {span: n}}`` of a chrome
    trace's events inside the ``TRACE_RANGE`` range: each device op's
    duration under the innermost of the spans ``names`` that holds its
    launch (ops launched outside every ``within`` span left out, where
    ``within`` is given), and how many of each span start in the range.
    None where the trace has no such range or no device op in it."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e["name"] == TRACE_RANGE and e.get("cat") == "user_annotation"]
    if not win:
        return None
    t0, t1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    wanted = set(names) | ({within} if within else set())
    spans, outer, count = defaultdict(list), defaultdict(list), defaultdict(int)
    for e in xs:
        if e["name"] in wanted and e.get("cat") == "cpu_op" and t0 <= e["ts"] <= t1:
            s = (e["ts"], e["ts"] + e["dur"], e["name"])
            if e["name"] in names:
                spans[(e["pid"], e["tid"])].append(s)
            if e["name"] == within:
                outer[(e["pid"], e["tid"])].append(s)
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
    owner = {th: _innermost(spans[th], ps) for th, ps in points.items()}
    inside = {th: _innermost(outer[th], ps) for th, ps in points.items()} if within else None
    device_s = defaultdict(float)
    for at, e in ops:
        if at is None or (inside is not None and at[1] not in inside[at[0]]):
            continue
        name = owner[at[0]].get(at[1])
        if name is not None:
            device_s[name] += e["dur"] / 1e6
    return {"device_s": dict(device_s), "count": dict(count)}


def of_record(rec: dict, names: tuple, within: str | None = None):
    """``attribute`` of the host-ops trace of the run ``rec`` records; None
    where the run was not traced or its trace file is missing."""
    if not rec.get("trace"):
        return None
    path = cell.BENCH / "out" / f"{rec['workload']['name']}.host.json"
    if not path.exists():
        return None
    with open(path) as f:
        return attribute(json.load(f)["traceEvents"], names, within)


def decode_span_s(rec: dict, name: str):
    """(device seconds under the span ``name`` (innermost among
    ``DECODE_SPANS``) in the traced decode steps, the number of those
    steps); None where there is no trace, no decode step or no device time
    under ``name``."""
    a = of_record(rec, DECODE_SPANS, within="model.decode_step")
    if a is None or not a["count"].get("model.decode_step") or not a["device_s"].get(name):
        return None
    return a["device_s"][name], a["count"]["model.decode_step"]


def per_step_ms(rec: dict, name: str):
    """Milliseconds of device time under ``name`` a traced decode step."""
    got = decode_span_s(rec, name)
    return None if got is None else 1e3 * got[0] / got[1]
