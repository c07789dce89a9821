"""Training-data generation + cross-validation (paper §3.1.1, §5.3.1).

Exhaustively profiles every (program, dataset, stream-config) cell, caches
the results as JSON (profiling is the expensive one-off "at the factory"
step), and assembles (features ++ config) -> speedup training matrices with
leave-one-out splits over *programs*.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import REPO_ROOT
from repro_torch.core import features as feat_lib
from repro_torch.core.stream_config import StreamConfig, default_space
from repro_torch.core.streams import StreamedRunner, profile_config_grid
from repro_torch.core.workloads import get_workload, list_workloads


def default_cache_path(device="cuda") -> Path:
    """The profile cache location: ``REPRO_TORCH_PROFILE_CACHE`` when set
    (resolved per call, so tests can redirect it), else
    ``<repo>/build/profile_cache_<device type>.json``: timings of one
    device type never mix with another's, and the JAX package's CPU corpus
    (``benchmarks/data/profile_cache.json``) is never written."""
    env = os.environ.get("REPRO_TORCH_PROFILE_CACHE")
    name = f"profile_cache_{torch.device(device).type}.json"
    return Path(env) if env else REPO_ROOT / "build" / name


#: the card's cache path as resolved at import (the JAX package's name)
DEFAULT_CACHE = default_cache_path()


@dataclasses.dataclass
class Sample:
    """One (program, dataset) cell with its full profiled config grid."""

    program: str
    scale: int
    features: np.ndarray                 # (22,) raw features
    t_single: float                      # single-stream seconds
    times: dict                          # {(p, t): seconds}

    def speedup(self, cfg: StreamConfig) -> float:
        return self.t_single / self.times[cfg.as_tuple()]

    @property
    def best_config(self) -> StreamConfig:
        p, t = min(self.times, key=self.times.get)
        return StreamConfig(p, t)

    @property
    def oracle_speedup(self) -> float:
        return self.t_single / min(self.times.values())

    def to_json(self) -> dict:
        return {
            "program": self.program,
            "scale": self.scale,
            "features": self.features.tolist(),
            "t_single": self.t_single,
            "times": [[p, t, v] for (p, t), v in self.times.items()],
        }

    @staticmethod
    def from_json(d: dict) -> "Sample":
        return Sample(
            d["program"], d["scale"], np.asarray(d["features"], np.float64),
            d["t_single"],
            {(p, t): v for p, t, v in d["times"]},
        )


def grid_for(n_rows: int, max_partitions: int = 32,
             max_tasks: int = 64) -> list[StreamConfig]:
    return [c for c in default_space(max_partitions, max_tasks)
            if c.partitions * c.tasks <= n_rows]


def profile_sample(program: str, scale: int, *, reps: int = 2,
                   seed: int = 0, device="cuda") -> Sample:
    wl = get_workload(program)
    rng = np.random.default_rng(seed + scale)
    chunked, shared = wl.make_data(scale, rng)
    runner = StreamedRunner(wl, chunked, shared, device=device)
    feats = feat_lib.extract_features(runner, profile_reps=reps)
    grid = grid_for(scale)
    times = profile_config_grid(runner, grid, reps=reps)
    t_single = times[StreamConfig(1, 1)]
    return Sample(program, scale, feats.values, t_single,
                  {c.as_tuple(): v for c, v in times.items()})


def generate(
    programs: Optional[Sequence[str]] = None,
    *,
    datasets_per_program: int = 4,
    reps: int = 2,
    cache_path: "str | Path | None" = None,
    verbose: bool = True,
    device="cuda",
) -> list[Sample]:
    """Profile (or load cached) samples for the suite on ``device``."""
    programs = list(programs or list_workloads())
    cache_path = (Path(cache_path) if cache_path
                  else default_cache_path(device))
    cache = _load_cache(cache_path)
    samples: list[Sample] = []
    dirty = False
    for prog in programs:
        wl = get_workload(prog)
        scales = _pick_scales(wl.datasets, datasets_per_program)
        for scale in scales:
            key = f"{prog}@{scale}"
            if key in cache:
                samples.append(Sample.from_json(cache[key]))
                continue
            t0 = time.perf_counter()
            s = profile_sample(prog, scale, reps=reps, device=device)
            cache[key] = s.to_json()
            dirty = True
            samples.append(s)
            if verbose:
                # progress goes to stderr: callers reserve stdout for
                # JSON payloads
                print(f"profiled {key:28s} oracle={s.oracle_speedup:5.2f}x "
                      f"({time.perf_counter()-t0:5.1f}s)",
                      file=sys.stderr, flush=True)
        if dirty:
            _save_cache(cache_path, cache)  # checkpoint per program
            dirty = False
    return samples


def _pick_scales(scales: tuple, k: int) -> list[int]:
    if k >= len(scales):
        return list(scales)
    idx = np.linspace(0, len(scales) - 1, k).round().astype(int)
    return [scales[i] for i in np.unique(idx)]


def _load_cache(path: "str | Path") -> dict:
    path = Path(path)
    if path.exists():
        with open(path) as f:
            return json.load(f)
    return {}


def _save_cache(path: "str | Path", cache: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(cache, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Matrices + cross-validation
# ---------------------------------------------------------------------------


def training_matrix(samples: Sequence[Sample]):
    """Rows = (program features ++ config encoding); target = speedup."""
    X, y = [], []
    for s in samples:
        for (p, t), sec in s.times.items():
            X.append(np.concatenate(
                [s.features, feat_lib.config_features(p, t)]))
            y.append(s.t_single / sec)
    return np.stack(X), np.asarray(y)


def loo_split(samples: Sequence[Sample], test_program: str):
    """Leave-one-out over programs (§5.3.1).  convsepr*/fftx* siblings are
    excluded together, as the paper does for convolutionFFT2d/Separable."""
    fam = _family(test_program)
    train = [s for s in samples if _family(s.program) != fam]
    test = [s for s in samples if s.program == test_program]
    return train, test


def _family(name: str) -> str:
    for prefix in ("convsepr", "fftx"):
        if name.startswith(prefix):
            return prefix
    return name
