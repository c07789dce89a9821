"""End-to-end runtime autotuner (paper Fig. 4): features -> model ->
ranked configs -> StreamConfig, in milliseconds, per program x dataset.

New in the backend refactor: a **persistent tuning cache**.  Feature
extraction profiles the workload for a few iterations, which is fine at
tuning time but not at serving time; the cache memoizes ``TuneResult``s
keyed by (workload name, shape-bucketed data signature, backend) and
round-trips through JSON, so a serving process warm-starts a previously
seen (program, dataset-bucket) in microseconds instead of re-profiling —
the runtime-deployment story of paper Fig. 4 at production request rates.

Cache keys and the JSON file format are the JAX package's, so a cache
written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import features as feat_lib
from repro_torch.core.modeling.perf_model import PerformanceModel
from repro_torch.core.modeling.search import search_best
from repro_torch.core.stream_config import StreamConfig, default_space
from repro_torch.core.streams import StreamedRunner
from repro_torch.core.workloads import Workload
from repro_torch.device import resolve_device


@dataclasses.dataclass
class TuneResult:
    config: StreamConfig
    predicted_speedup: float
    feature_seconds: float
    search_seconds: float
    backend: str = "host-sync"
    cached: bool = False
    #: provenance: "model" = ranked by the performance model;
    #: "refined" = re-profiled by the serving drift-refinement loop, so
    #: predicted_speedup is a *measured* speedup, not a model output
    source: str = "model"

    def to_json(self) -> dict:
        return {
            "config": self.config.to_json(),
            "predicted_speedup": self.predicted_speedup,
            "feature_seconds": self.feature_seconds,
            "search_seconds": self.search_seconds,
            "backend": self.backend,
            "source": self.source,
        }

    @staticmethod
    def from_json(d: dict) -> "TuneResult":
        return TuneResult(
            config=StreamConfig.from_json(d["config"]),
            predicted_speedup=float(d["predicted_speedup"]),
            feature_seconds=float(d["feature_seconds"]),
            search_seconds=float(d["search_seconds"]),
            backend=d.get("backend", "host-sync"),
            source=d.get("source", "model"),
        )


# ---------------------------------------------------------------------------
# Persistent tuning cache
# ---------------------------------------------------------------------------


def quarantine_file(path) -> Optional[str]:
    """Move a corrupt persisted file aside (``<path>.corrupt``,
    ``.corrupt-1``, ...) so the caller can rebuild from empty while the
    evidence survives for inspection.  Returns the quarantine path, or
    None if the file vanished underneath us."""
    path = str(path)
    if not os.path.exists(path):
        return None
    n = 0
    while True:
        dest = f"{path}.corrupt" + (f"-{n}" if n else "")
        if not os.path.exists(dest):
            break
        n += 1
    os.replace(path, dest)
    return dest


def shape_bucket(n: int) -> int:
    """Round the leading (iteration-space) dim up to a power of two.

    Serving traffic rarely repeats exact batch sizes; bucketed keys make
    every request in (2^k, 2^(k+1)] share one tuning entry, trading at
    most one octave of shape mismatch for a 100%-hit steady state."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def data_signature(chunked: dict, shared: dict) -> str:
    """Canonical shape/dtype signature with the chunked leading dim
    bucketed (inner dims and shared buffers are part of the program, so
    they stay exact)."""
    def one(d: dict, bucket_rows: bool) -> list:
        items = []
        for k in sorted(d):
            a = d[k]
            shape = list(a.shape)
            if bucket_rows and shape:
                shape[0] = shape_bucket(shape[0])
            items.append([k, shape, str(a.dtype)])
        return items

    return json.dumps({"chunked": one(chunked, True),
                       "shared": one(shared, False)},
                      separators=(",", ":"))


class TuningCache:
    """(workload, signature, backend) -> TuneResult, with JSON persistence.

    Typical deployment flow::

        cache = TuningCache("tuning_cache.json")   # warm-start if present
        tuner = AutoTuner(model, cache=cache)
        ...serve...
        cache.save()                               # persist new entries
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._entries: dict[str, TuneResult] = {}
        self.hits = 0
        self.misses = 0
        #: path the corrupt file was moved to, if a load quarantined one
        self.quarantined: Optional[str] = None
        if path and os.path.exists(path):
            try:
                self.load(path)
            except (OSError, ValueError, KeyError, TypeError) as e:
                # corrupt/unreadable cache ==> quarantine-and-rebuild,
                # not a crash: the damaged file moves aside (evidence
                # survives; the next save() atomically writes a fresh
                # one) and serving cold-starts
                self._entries.clear()
                self.quarantined = quarantine_file(path)
                warnings.warn(
                    f"unreadable tuning cache {path} ({e}); quarantined "
                    f"to {self.quarantined} and rebuilding empty")

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def key(workload: str, chunked: dict, shared: dict, backend: str,
            model_tag: str = "", namespace: str = "") -> str:
        """Cache key, optionally prefixed with a tenant ``namespace``.

        An empty namespace yields the exact pre-tenancy key format, so
        persisted caches written before isolation existed keep hitting.
        Namespaced entries share the file but never collide across
        tenants — the serving scheduler's per-tenant cache isolation."""
        base = (f"{workload}|{backend}|{model_tag}|"
                f"{data_signature(chunked, shared)}")
        return f"tenant:{namespace}|{base}" if namespace else base

    def keys(self) -> list[str]:
        return list(self._entries)

    def peek(self, key: str) -> Optional[TuneResult]:
        """Raw lookup WITHOUT hit/miss accounting — for introspection
        (the resilience layer's nearest-bucket scan), not serving."""
        return self._entries.get(key)

    def get(self, key: str, *, valid=None) -> Optional[TuneResult]:
        """Stats-counted lookup; an entry failing the ``valid`` predicate
        counts as a miss (the caller will re-tune)."""
        hit = self._entries.get(key)
        if hit is not None and (valid is None or valid(hit)):
            self.hits += 1
            return hit
        self.misses += 1
        return None

    def put(self, key: str, result: TuneResult) -> None:
        self._entries[key] = result

    def invalidate(self, key: str) -> Optional[TuneResult]:
        """Drop an entry (drift refinement evicts before re-profiling so a
        concurrent reader re-tunes rather than serving the stale config)."""
        return self._entries.pop(key, None)

    # -- persistence ---------------------------------------------------------

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        assert path, "no cache path given"
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({k: r.to_json() for k, r in self._entries.items()},
                      f, indent=0)
            f.flush()
            os.fsync(f.fileno())   # crash-safe: rename lands AFTER the data
        os.replace(tmp, path)
        return path

    def load(self, path: Optional[str] = None) -> "TuningCache":
        path = path or self.path
        with open(path) as f:
            raw = json.load(f)
        self._entries.update(
            {k: TuneResult.from_json(v) for k, v in raw.items()})
        return self


class AutoTuner:
    def __init__(self, model: PerformanceModel,
                 candidates: Optional[Sequence[StreamConfig]] = None,
                 *, cache: Optional[TuningCache] = None,
                 backend: str = "host-sync", model_tag: str = "",
                 device="cuda"):
        # ``model_tag`` should name the model version when the cache is
        # persistent — entries are keyed by it, so retraining the model
        # under a new tag invalidates old configs instead of serving them.
        # ``device`` is where a tune profiles (the card unless "cpu").
        self.device = resolve_device(device)
        self.model = model
        self.candidates = list(candidates or default_space())
        self.cache = cache
        self.backend = backend
        self.model_tag = model_tag

    def tune(self, wl: Workload, chunked: dict, shared: dict,
             *, runner: Optional[StreamedRunner] = None) -> TuneResult:
        n_rows = next(iter(chunked.values())).shape[0]
        backend = runner.backend.name if runner is not None else self.backend
        if self.cache is not None:
            key = self.cache.key(wl.name, chunked, shared, backend,
                                 self.model_tag)
            # shape bucketing can hand back a config tuned on a larger
            # batch in the same bucket; only honor it if it is still
            # splittable for THIS batch, else re-tune (and overwrite the
            # entry with the more conservative config).
            hit = self.cache.get(key, valid=lambda r: (
                r.config.partitions * r.config.tasks <= n_rows))
            if hit is not None:
                return dataclasses.replace(hit, cached=True)
        t0 = time.perf_counter()
        runner = runner or StreamedRunner(wl, chunked, shared,
                                          device=self.device,
                                          backend=backend)
        feats = feat_lib.extract_features(runner, profile_reps=1)
        t_feat = time.perf_counter() - t0
        # guard: an empty filtered list would make search_best fall back
        # to the FULL default grid and return an unsplittable config
        cands = [c for c in self.candidates
                 if c.partitions * c.tasks <= n_rows] or [StreamConfig(1, 1)]
        best, preds, t_search = search_best(self.model, feats.values, cands)
        result = TuneResult(best, float(np.max(preds)), t_feat, t_search,
                            backend=backend)
        if self.cache is not None:
            self.cache.put(key, result)
        return result


# ---------------------------------------------------------------------------
# Pod-scale candidate ranking (mesh backend)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshCandidate:
    """A pod-scale 'stream configuration': how the fixed chip grid is
    factorized (spatial) and how many microbatches per step (temporal)."""

    data: int
    model: int
    microbatches: int

    @property
    def stream_config(self) -> StreamConfig:
        return StreamConfig(self.data, self.microbatches)


def rank_by_roofline(candidates, terms: dict) -> list:
    """Rank MeshCandidates by their roofline makespan estimate.

    ``terms`` maps candidate -> dict(compute=, memory=, collective=) in
    seconds.  The makespan model assumes the collective term overlaps
    compute up to the dominant-term bound: the same overlap objective the
    paper's model learns.
    """
    def makespan(c):
        t = terms[c]
        return max(t["compute"], t["memory"]) + max(
            0.0, t["collective"] - 0.5 * max(t["compute"], t["memory"]))

    return sorted(candidates, key=makespan)
