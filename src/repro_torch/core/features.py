"""Feature extraction (paper §3.2, Tables 1-2) — PyTorch adaptation.

The paper uses static code features + hardware performance counters.  Here
static features come from one torch trace of the kernel
(:mod:`repro_torch.core.trace_cost`: op mix, FLOPs, memory traffic) and
dynamic features from profiling the single-stream version on the runner's
device (paper §3.3: "profiling the program without partitioning for a few
loop iterations").

22 raw features are defined, with the JAX package's names and order (the
artifact schema hash depends on both); the model pipeline
(perf_model.FeaturePipeline) applies Z-score standardization, |rho|>0.7
correlation pruning and PCA — exactly the paper's §3.2.1-§3.2.2 recipe.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.streams import StreamedRunner
from repro_torch.core.trace_cost import trace_cost

RAW_FEATURE_NAMES = [
    # --- static: iteration space / transfer structure (paper Table 1) ---
    "loop_nest",            # rank of the widest chunked array
    "loop_count",           # outer iteration count (rows)
    "n_xfer_mem",           # # of host-device transferred buffers
    "dts",                  # total host-device transfer size (bytes)
    "redundant_transfer",   # shared-buffer bytes (re-usable across tasks)
    "max_blocks",           # max #tasks (= loop_count)
    "min_task_unit",        # bytes per iteration row
    "out_bytes",            # device->host result size
    # --- static: traced-kernel op mix (counter analogues) ---
    "hlo_ops",              # # aten ops (paper: # instructions)
    "flops",                # FLOPs of one full pass
    "bytes_accessed",       # memory traffic estimate
    "arith_intensity",      # flops / bytes
    "frac_dot",             # fraction of dot/conv ops
    "frac_elementwise",
    "frac_reduce",
    "n_transcendental",     # exp/log/erf/sin/cos ops (paper: ALU mix)
    "n_gather_scatter",     # irregular access (paper: cache-miss proxy)
    "sequential_inner",     # has inner sequential scan (paper: loop nest)
    # --- dynamic: first-iterations profile ---
    "t_single_us",          # single-stream time (few iterations)
    "t_transfer_us",        # H2D time
    "t_compute_us",         # kernel time
    "comp_comm_ratio",      # log(t_compute / t_transfer) (paper Fig 17)
]


def _tree_bytes(d: dict) -> int:
    return int(sum(a.nbytes for a in d.values()))


def _tree_count(d: dict) -> int:
    return len(d)


@dataclasses.dataclass
class RawFeatures:
    values: np.ndarray  # (22,)

    def as_dict(self) -> dict:
        return dict(zip(RAW_FEATURE_NAMES, self.values))


def extract_features(runner: StreamedRunner, *, profile: bool = True,
                     profile_reps: int = 2) -> RawFeatures:
    wl, chunked, shared = runner.wl, runner.chunked, runner.shared
    rows = next(iter(chunked.values())).shape[0]
    loop_nest = max(a.ndim for a in chunked.values())
    dts = _tree_bytes(chunked) + _tree_bytes(shared)
    red = _tree_bytes(shared)

    cost = trace_cost(wl.kernel, chunked, shared)
    n_ops = max(cost.n_ops, 1)
    bytes_acc = cost.bytes_accessed or float(dts)

    if profile:
        t_xfer = runner.measure_transfer(reps=profile_reps)
        t_comp = runner.measure_compute(reps=profile_reps)
        t_single = runner.run_single_stream(reps=profile_reps)
    else:
        t_xfer = t_comp = t_single = 0.0
    ratio = math.log(max(t_comp, 1e-9) / max(t_xfer, 1e-9))

    vals = np.array([
        loop_nest,
        rows,
        _tree_count(chunked) + _tree_count(shared),
        dts,
        red,
        rows,
        dts / max(rows, 1),
        cost.out_bytes,
        n_ops,
        cost.flops,
        bytes_acc,
        cost.flops / max(bytes_acc, 1.0),
        cost.n_dot / n_ops,
        cost.n_elementwise / n_ops,
        cost.n_reduce / n_ops,
        cost.n_transcendental,
        cost.n_gather_scatter,
        1.0 if wl.sequential_inner else 0.0,
        t_single * 1e6,
        t_xfer * 1e6,
        t_comp * 1e6,
        ratio,
    ], dtype=np.float64)
    return RawFeatures(vals)


def config_features(partitions: int, tasks: int) -> np.ndarray:
    """Configuration encoding appended to the program features (§3.1.3)."""
    return np.array([
        math.log2(partitions),
        math.log2(tasks),
        math.log2(tasks / partitions) if tasks >= partitions else -1.0,
    ], dtype=np.float64)


# Candidate grids are immutable per scheduler/tuner, so their encodings —
# and the raw (partitions, tasks) columns the vectorized heuristic model
# scores — are memoized by the grid's value.  Coordinator-thread only:
# decide/tune never runs on pool workers.
_CONFIG_MATRIX_CACHE: dict = {}
_CONFIG_MATRIX_CACHE_MAX = 64


def _config_memo(kind: str, configs, build):
    key = (kind, tuple((c.partitions, c.tasks) for c in configs))
    hit = _CONFIG_MATRIX_CACHE.get(key)
    if hit is None:
        while len(_CONFIG_MATRIX_CACHE) >= _CONFIG_MATRIX_CACHE_MAX:
            _CONFIG_MATRIX_CACHE.pop(next(iter(_CONFIG_MATRIX_CACHE)))
        hit = _CONFIG_MATRIX_CACHE[key] = build()
    return hit


def config_feature_matrix(configs) -> np.ndarray:
    """(C, N_CONFIG_FEATURES) encoding of a candidate grid, memoized."""
    return _config_memo("enc", configs, lambda: np.stack(
        [config_features(c.partitions, c.tasks) for c in configs]))


def config_pt_arrays(configs) -> tuple[np.ndarray, np.ndarray]:
    """The (partitions, tasks) columns of a candidate grid as float
    arrays, memoized — the vectorized overlap heuristic scores the whole
    grid with these instead of a Python loop."""
    return _config_memo("pt", configs, lambda: (
        np.array([c.partitions for c in configs], dtype=np.float64),
        np.array([c.tasks for c in configs], dtype=np.float64)))


N_CONFIG_FEATURES = 3
