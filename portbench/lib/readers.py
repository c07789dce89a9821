"""What the per-layer readers (``metrics/<name>.py``) share.  A reader
gets the traffic driver's record of its run and returns the metric, or
None where the record holds nothing to read (an untraced run for a trace
metric)."""
from __future__ import annotations

import statistics

from portbench.lib import cost
from portbench.lib.trace import kernel_name


def idle_share(rec: dict):
    """Percent of the traced window in which no device operation ran."""
    t = rec.get("trace")
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def window_flops(rec: dict) -> float:
    """The model FLOPs of the window's units (serving) or steps (training)."""
    dm = rec["dims"]
    if "steps" in rec:
        wl = rec["workload"]
        return rec["steps"] * cost.train_flops(dm, wl["batch"], wl["seq_len"])
    return sum(cost.prefill_flops(dm, u["rows"], u["length"]) if u["kind"] == "prefill"
               else cost.decode_flops(dm, u["rows"], u["position"]) for u in rec["units"])


def mfu(rec: dict) -> float:
    """Percent of the TF32 peak the window's model FLOPs took."""
    return 100.0 * window_flops(rec) / (rec["window_s"] * cost.PEAK_TF32)


def decode_units(rec: dict) -> list:
    return [u for u in rec["units"] if u["kind"] == "decode"]


def host_ms_median(rec: dict):
    us = decode_units(rec)
    return statistics.median(u["host_s"] for u in us) * 1e3 if us else None


def p95_tpot_ms(rec: dict):
    """The 95th percentile of every request's gaps between consecutive
    tokens in the window (each decode step's gap once for each of its
    rows), linear between the two nearest ranks."""
    gaps = sorted(g for u in decode_units(rec) if "gap_s" in u
                  for g in [u["gap_s"] * 1e3] * u["rows"])
    if not gaps:
        return None
    k = 0.95 * (len(gaps) - 1)
    lo = int(k)
    hi = min(lo + 1, len(gaps) - 1)
    return gaps[lo] + (gaps[hi] - gaps[lo]) * (k - lo)


def decode_bandwidth(rec: dict):
    """Percent of HBM's rate that the window's decode steps' least bytes
    took over their measured times (each from the mark before it to its
    own)."""
    us = [u for u in decode_units(rec) if "gap_s" in u]
    if not us:
        return None
    dm = rec["dims"]
    nbytes = sum(cost.decode_bytes(dm, u["rows"], u["position"]) for u in us)
    return 100.0 * nbytes / cost.HBM_BW / sum(u["gap_s"] for u in us)


def kernel_roofline(rec: dict, names: tuple, counted: str, calls: list, per_call):
    """Percent of the roofline that the traced launches of a kernel took.

    ``names``: the device ops that make up one call (by ``kernel_name``);
    ``counted``: the op launched exactly once a call; ``calls``: the calls
    the traced stretch made, each a tuple of ``per_call``'s arguments, which
    gives a call's (FLOPs, bytes).  None where the trace holds no call or
    its count of ``counted`` differs from ``calls``'s (the FLOPs would then
    not be those of the traced launches)."""
    t = rec.get("trace")
    if not t or not calls:
        return None
    ops = [(kernel_name(n), d) for n, _, d in t["ops"]]
    if sum(1 for n, _ in ops if n == counted) != len(calls):
        return None
    device_s = sum(d for n, d in ops if n in names)
    least = sum(cost.roofline_s(*per_call(*c)) for c in calls)
    return 100.0 * least / device_s
