"""The port's workload suite against the JAX package's.

The same numpy inputs (``make_data`` from one seed) go through each JAX
kernel and its port; the port runs on the CPU.  Chunk invariance and sum
partials are held on the port alone, as ``tests/test_workloads.py`` holds
them on the JAX package.
"""
import jax
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.core import workloads as jwl
from repro_torch.core.workloads import _REGISTRY, get_workload, list_workloads

# backend-equivalence tolerance (tests/test_backends.py)
RTOL, ATOL = 2e-4, 1e-3


def _tensors(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _port(wl, chunked, shared):
    return wl.kernel(_tensors(chunked), _tensors(shared)).numpy()


def test_suite_has_39_programs():
    assert len(list_workloads()) == 39
    assert list_workloads() == jwl.list_workloads()
    assert {w.suite for w in _REGISTRY.values()} == {
        "nvidia", "amd", "parboil", "polybench"}


@pytest.mark.parametrize("name", list_workloads())
def test_make_data_and_metadata_match_jax(name):
    wl, ref = get_workload(name), jwl.get_workload(name)
    assert (wl.suite, wl.datasets, wl.sequential_inner, wl.combine) == (
        ref.suite, ref.datasets, ref.sequential_inner, ref.combine)
    for scale in (wl.datasets[0], wl.datasets[-1]):
        got = wl.make_data(scale, np.random.default_rng(3))
        want = ref.make_data(scale, np.random.default_rng(3))
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in g:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                assert g[k].tobytes() == w[k].tobytes(), (name, scale, k)


@pytest.mark.parametrize("name", list_workloads())
def test_kernel_matches_jax(name):
    # every kernel holds the backend tolerance; none needs the looser
    # chunk-invariance one (rtol 1e-3, atol 0.1)
    wl = get_workload(name)
    chunked, shared = wl.make_data(wl.datasets[0], np.random.default_rng(0))
    want = np.asarray(jax.jit(jwl.get_workload(name).kernel)(chunked, shared))
    got = _port(wl, chunked, shared)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", [n for n in list_workloads()
                                  if get_workload(n).combine == "concat"])
def test_chunk_invariance(name):
    """kernel(rows) == concat(kernel(row chunks)) for row-independent
    programs — the correctness contract of the streamed executor."""
    wl = get_workload(name)
    chunked, shared = wl.make_data(wl.datasets[0], np.random.default_rng(1))
    full = _port(wl, chunked, shared)
    half = next(iter(chunked.values())).shape[0] // 2
    a = {k: v[:half] for k, v in chunked.items()}
    b = {k: v[half:] for k, v in chunked.items()}
    parts = np.concatenate([_port(wl, a, shared), _port(wl, b, shared)])
    # the tolerance of tests/test_workloads.py: products change their
    # reduction order with the chunk shape
    np.testing.assert_allclose(parts, full, rtol=1e-3, atol=0.1)


@pytest.mark.parametrize("name", [n for n in list_workloads()
                                  if get_workload(n).combine == "sum"])
def test_sum_partials(name):
    wl = get_workload(name)
    chunked, shared = wl.make_data(wl.datasets[0], np.random.default_rng(2))
    full = _port(wl, chunked, shared)
    half = next(iter(chunked.values())).shape[0] // 2
    a = {k: v[:half] for k, v in chunked.items()}
    b = {k: v[half:] for k, v in chunked.items()}
    parts = _port(wl, a, shared) + _port(wl, b, shared)
    np.testing.assert_allclose(parts, full, rtol=1e-3)


def test_histo_counts_are_exact():
    wl = get_workload("histo")
    chunked, shared = wl.make_data(64, np.random.default_rng(4))
    got = _port(wl, chunked, shared)
    want = np.stack([np.bincount(r, minlength=256) for r in chunked["x"]])
    np.testing.assert_array_equal(got, want.astype(np.float32))
