"""The port's runner and backends against the JAX package's.

Every port backend, under every config of the JAX package's equivalence
grid, must reproduce the JAX ``host-sync`` single-stream output on the
same inputs (the port runs on the CPU here; ``chip_smoke.py`` holds the
same contract on the card).
"""
import itertools

import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.core.backends import base as jbase
from repro.core.backends import list_backends as jax_list_backends
from repro.core.streams import StreamedRunner as JaxRunner
from repro.core.workloads import get_workload as jax_workload
from repro_torch.core.backends import (REFERENCE_BACKEND, ExecutionContext,
                                       StreamBackend, dispatch_plan,
                                       get_backend, list_backends,
                                       register_backend, split_arrays)
from repro_torch.core.stream_config import (SINGLE_STREAM, StreamConfig,
                                            default_space)
from repro_torch.core.streams import (StreamedRunner, parallel_capacity,
                                      probe_host_capacity,
                                      profile_config_grid,
                                      profile_grid_interleaved)
from repro_torch.core.workloads import get_workload

EQUIV_WORKLOADS = ["vecadd", "sgemm", "mvmult"]
EQUIV_CONFIGS = [SINGLE_STREAM, StreamConfig(1, 4), StreamConfig(2, 2),
                 StreamConfig(4, 8)]


def _data(name, seed=0):
    wl = get_workload(name)
    return wl.make_data(wl.datasets[0], np.random.default_rng(seed))


def _concat(outs):
    return np.concatenate([np.asarray(o) for o in outs], axis=0)


@pytest.fixture(scope="module")
def jax_references():
    """The JAX package's single-stream outputs on its reference backend."""
    refs = {}
    for name in EQUIV_WORKLOADS:
        chunked, shared = _data(name)
        runner = JaxRunner(jax_workload(name), chunked, shared,
                           backend=REFERENCE_BACKEND)
        refs[name] = _concat(runner.dispatch(SINGLE_STREAM))
    return refs


@pytest.mark.parametrize("backend",
                         ["host-sync", "host-pipelined", "host-threads"])
@pytest.mark.parametrize("name", EQUIV_WORKLOADS)
def test_backend_matches_jax_single_stream(backend, name, jax_references):
    chunked, shared = _data(name)
    runner = StreamedRunner(get_workload(name), chunked, shared,
                            device="cpu", backend=backend)
    for cfg in EQUIV_CONFIGS:
        outs = runner.dispatch(cfg)
        assert len(outs) == cfg.partitions * cfg.tasks
        np.testing.assert_allclose(_concat(outs), jax_references[name],
                                   rtol=2e-4, atol=1e-3,
                                   err_msg=f"{backend} {name} {cfg}")


@pytest.mark.parametrize("backend",
                         ["host-sync", "host-pipelined", "host-threads"])
def test_backend_output_count_and_timing(backend):
    wl = get_workload("vecadd")
    chunked, shared = wl.make_data(256, np.random.default_rng(1))
    runner = StreamedRunner(wl, chunked, shared, device="cpu",
                            backend=backend)
    cfg = StreamConfig(2, 4)
    assert len(runner.dispatch(cfg)) == cfg.partitions * cfg.tasks
    assert 0 < runner.run(cfg, reps=1) < 10.0


def test_dispatch_plan_matches_jax():
    configs = default_space() + [StreamConfig(3, 5), StreamConfig(7, 1)]
    for n_rows, cfg in itertools.product(
            [1, 2, 7, 64, 100, 256, 1000, 4096], configs):
        assert dispatch_plan(n_rows, cfg) == jbase.dispatch_plan(n_rows, cfg)


def test_split_arrays_matches_jax():
    arrs = {"a": np.arange(26).reshape(13, 2)}
    for n in (1, 3, 4):
        for g, w in zip(split_arrays(arrs, n), jbase.split_arrays(arrs, n)):
            np.testing.assert_array_equal(g["a"], w["a"])


def test_registry_contents():
    # the JAX package's runner backends, exactly (its ``mesh`` train-step
    # backend is not ported yet)
    assert list_backends() == ["host-pipelined", "host-sync", "host-threads"]
    assert list_backends() == jax_list_backends(kind="runner")
    assert list_backends(kind="runner") == list_backends()
    assert REFERENCE_BACKEND == "host-sync"
    assert get_backend("host-pipelined").depth == 2
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend("no-such-backend")

    class Dup(StreamBackend):
        name = "host-sync"

    with pytest.raises(ValueError, match="already registered"):
        register_backend(Dup())


def test_runner_defaults_to_the_card(monkeypatch):
    chunked, shared = _data("vecadd")
    wl = get_workload("vecadd")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamedRunner(wl, chunked, shared)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_host_capacity(2)
    runner = StreamedRunner(wl, chunked, shared, device="cpu")
    assert runner.device == torch.device("cpu")
    assert runner.ctx.stream is None and runner.ctx.copy_stream is None


def test_context_keeps_shared_resident_and_swaps():
    wl = get_workload("mvmult")
    chunked, shared = _data("mvmult")
    ctx = ExecutionContext.create(wl.kernel, chunked, shared, "cpu")
    np.testing.assert_array_equal(ctx.shared_dev["v"].numpy(), shared["v"])
    c2, s2 = _data("mvmult", seed=5)
    runner = StreamedRunner(wl, c2, s2, device="cpu",
                            ctx=ctx.swap_buffers(c2, s2))
    np.testing.assert_allclose(_concat(runner.dispatch(SINGLE_STREAM)),
                               c2["A"] @ s2["v"], rtol=1e-5, atol=1e-4)


def test_profiling_hooks_positive():
    chunked, shared = _data("sgemm")
    runner = StreamedRunner(get_workload("sgemm"), chunked, shared,
                            device="cpu")
    grid = [SINGLE_STREAM, StreamConfig(2, 2)]
    times = profile_config_grid(runner, grid, reps=1)
    assert set(times) == set(grid) and all(t > 0 for t in times.values())
    inter = profile_grid_interleaved(runner, grid, sweeps=2, prior=times)
    assert all(inter[c] <= times[c] for c in grid)
    assert runner.measure_transfer(reps=1) >= 0
    assert runner.measure_compute(reps=1) > 0
    assert parallel_capacity([lambda: None], 2, reps=2, trials=1) > 0
    assert probe_host_capacity(2, size=32, reps=2, device="cpu") > 0
