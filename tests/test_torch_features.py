"""The port's features against the JAX package's.

The nine features that come from shapes alone must equal the JAX
package's on the same inputs; the ones read off a compiled graph
(XLA's HLO there, a torch trace here) are held to a documented agreement:
FLOPs of the matmul family within 5%.
"""
import numpy as np
import pytest

from repro.core import features as jfeat
from repro.core.modeling import artifacts as jart
from repro.core.streams import StreamedRunner as JaxRunner
from repro.core.workloads import get_workload as jax_workload
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
from repro_torch.core import features as feat
from repro_torch.core.modeling import artifacts
from repro_torch.core.streams import StreamedRunner
from repro_torch.core.trace_cost import trace_cost
from repro_torch.core.workloads import get_workload, list_workloads

SHAPE_FEATURES = ["loop_nest", "loop_count", "n_xfer_mem", "dts",
                  "redundant_transfer", "max_blocks", "min_task_unit",
                  "out_bytes", "sequential_inner"]
MATMUL_FAMILY = ["sgemm", "gemm", "2mm", "3mm", "syrk", "syr2k", "dct"]


def _both(name):
    wl = get_workload(name)
    chunked, shared = wl.make_data(wl.datasets[0], np.random.default_rng(0))
    port = feat.extract_features(
        StreamedRunner(wl, chunked, shared, device="cpu"),
        profile=False).as_dict()
    ref = jfeat.extract_features(
        JaxRunner(jax_workload(name), chunked, shared),
        profile=False).as_dict()
    return port, ref


def test_schema_matches_jax():
    assert feat.RAW_FEATURE_NAMES == jfeat.RAW_FEATURE_NAMES
    assert feat.N_CONFIG_FEATURES == jfeat.N_CONFIG_FEATURES
    assert artifacts.feature_schema_hash() == jart.feature_schema_hash()
    for p, t in [(1, 1), (2, 8), (8, 2), (32, 64)]:
        np.testing.assert_array_equal(feat.config_features(p, t),
                                      jfeat.config_features(p, t))


@pytest.mark.parametrize("name", list_workloads())
def test_shape_features_equal_jax(name):
    port, ref = _both(name)
    assert list(port) == list(ref)
    for k in SHAPE_FEATURES:
        assert port[k] == ref[k], (name, k, port[k], ref[k])
    assert all(np.isfinite(v) for v in port.values())
    for k in ("t_single_us", "t_transfer_us", "t_compute_us"):
        assert port[k] == 0.0


@pytest.mark.parametrize("name", MATMUL_FAMILY)
def test_matmul_flops_within_5_percent_of_xla(name):
    port, ref = _both(name)
    assert ref["flops"] > 0
    assert abs(port["flops"] - ref["flops"]) <= 0.05 * ref["flops"], (
        port["flops"], ref["flops"])
    assert port["frac_dot"] > 0


def test_trace_op_mix():
    def cost(name):
        wl = get_workload(name)
        return trace_cost(wl.kernel, *wl.make_data(
            wl.datasets[0], np.random.default_rng(0)))

    assert cost("sgemm").n_dot == 1 and cost("sgemm").n_ops == 1
    bs = cost("blackscholes")
    assert bs.n_transcendental >= 4 and bs.flops == 0
    assert cost("spmv").n_gather_scatter == 1
    assert cost("histo").n_gather_scatter == 1
    assert cost("prefix").n_reduce == 1
    vec = cost("vecadd")
    assert vec.n_elementwise == 1
    # one add: two inputs read, one output written
    assert vec.bytes_accessed == 3 * vec.out_bytes


def test_profiled_features_positive():
    wl = get_workload("mvmult")
    chunked, shared = wl.make_data(wl.datasets[0], np.random.default_rng(0))
    f = feat.extract_features(StreamedRunner(wl, chunked, shared,
                                             device="cpu"),
                              profile_reps=1).as_dict()
    assert f["t_single_us"] > 0 and f["t_compute_us"] > 0
    assert f["flops"] == 2 * chunked["A"].size
