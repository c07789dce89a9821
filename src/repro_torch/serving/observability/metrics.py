"""Process-wide named counters, gauges, and histograms for serving.

The telemetry JSONL is per-request and unbounded; these are the cheap
aggregates a dashboard or a Prometheus scrape wants: cache hits/misses
per tenant namespace, cold-search batch sizes, drift fires vs cooldown
suppressions, queue depth, shed count, in-flight occupancy, refinement
latency, and per-stage time histograms.

Design constraints, in order:

  * **hot-path cheap** — instruments are resolved once (the scheduler
    pre-binds them in ``__init__``) so a hot-path update is one method
    call on a pre-fetched object; each instrument carries its own lock
    and the critical section is a couple of arithmetic ops (the GIL
    makes most of them atomic anyway — the lock is for the few that are
    read-modify-write across fields, and for snapshot consistency);
  * **deterministic snapshots** — ``snapshot()`` returns plain sorted
    dicts of ints/floats, so two replays of the same seeded trace
    produce byte-identical snapshots (asserted in the tests);
  * **zero cost when off** — :data:`NULL_METRICS` hands back one shared
    no-op instrument for every request, mirroring the null tracer.

``to_prometheus()`` renders the text exposition format (``# TYPE``
headers, ``{label="..."}`` selectors, ``_bucket``/``_sum``/``_count``
histogram series) so a scrape target needs nothing beyond an HTTP
wrapper around one string.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional, Sequence

#: default histogram bucket upper bounds (seconds-flavored: the serving
#: stages span ~10us decisions to ~1s refinements)
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class Counter:
    """Monotone named count."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value (queue depth, in-flight occupancy)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max.

    Buckets are cumulative upper bounds (Prometheus ``le`` semantics);
    everything above the last bound lands in the implicit ``+Inf``
    bucket.  ``observe`` is one bisect + a few adds under the lock."""

    __slots__ = ("_lock", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +Inf last
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):     # len(bounds) is ~7
            if v <= b:
                idx = i
                break
        with self._lock:
            self.bucket_counts[idx] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self):
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max, "mean": self.mean,
            "buckets": {_le_label(b): c for b, c in
                        zip((*self.bounds, float("inf")),
                            self.bucket_counts)},
        }


def _le_label(bound: float) -> str:
    return "+Inf" if bound == float("inf") else repr(bound)


class MetricsRegistry:
    """Named instrument registry.

    ``counter/gauge/histogram(name, **labels)`` get-or-create the
    instrument for that (name, labels) pair — same pair, same object, so
    increments from the scheduler and reads from an exporter meet on one
    value.  A name must keep one instrument kind for the registry's
    lifetime (kind confusion raises).
    """

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {sorted-label-items-tuple: instrument})
        self._families: dict[str, tuple[str, dict]] = {}

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise TypeError(
                    f"metric {name!r} is a {fam[0]}, requested {kind}")
            inst = fam[1].get(key)
            if inst is None:
                inst = fam[1][key] = factory()
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(buckets))

    # -- export -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict view, deterministically ordered: metric name ->
        {"type": kind, "values": [{"labels": {...}, ...payload}]}
        (single unlabeled instruments inline their payload as
        ``"value"``)."""
        out: dict = {}
        with self._lock:
            families = {n: (k, dict(insts))
                        for n, (k, insts) in self._families.items()}
        for name in sorted(families):
            kind, insts = families[name]
            values = [{"labels": dict(key), "value": inst.snapshot()}
                      for key, inst in sorted(insts.items())]
            out[name] = {"type": kind, "values": values}
        return out

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format."""
        lines: list[str] = []
        snap = self.snapshot()
        for name, fam in snap.items():
            pname = _prom_name(name)
            lines.append(f"# TYPE {pname} {fam['type']}")
            for entry in fam["values"]:
                sel = _prom_labels(entry["labels"])
                v = entry["value"]
                if fam["type"] == "histogram":
                    cum = 0
                    for le, c in v["buckets"].items():
                        cum += c
                        bsel = _prom_labels(
                            {**entry["labels"], "le": le})
                        lines.append(f"{pname}_bucket{bsel} {cum}")
                    lines.append(f"{pname}_sum{sel} {v['sum']}")
                    lines.append(f"{pname}_count{sel} {v['count']}")
                else:
                    lines.append(f"{pname}{sel} {v}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(k)}="{v}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _NullInstrument:
    """One object, every no-op instrument method."""

    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def dec(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def snapshot(self):
        return None


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    """Disabled registry: every request resolves to the one shared no-op
    instrument; snapshot is empty.  The schedulers' default."""

    enabled = False

    def counter(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS,
                  **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {}

    def save(self, path: str) -> None:
        pass

    def to_prometheus(self) -> str:
        return ""


NULL_METRICS = NullMetrics()
