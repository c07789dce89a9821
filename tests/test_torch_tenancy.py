"""Per-tenant isolation in the port's serving stack, against the JAX
package's.

Tenant namespaces give the JAX package's cache keys; the registry shares
one context until isolation is asked for; ``fork_model`` copies the
port's torch ``PerformanceModel`` onto the device it lives on, and a
refit of the fork leaves the base exactly as it was; isolated tenants
make the JAX package's cold/warm decisions.  The port runs on the CPU
here.
"""
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.core.autotuner import TuningCache as JaxCache
from repro.serving import AdaptiveScheduler as JaxScheduler
from repro.serving import WorkloadRequest as JaxRequest
from repro_torch.core.autotuner import TuningCache
from repro_torch.core.modeling.heuristic import OverlapHeuristicModel
from repro_torch.core.modeling.perf_model import PerformanceModel
from repro_torch.core.workloads import get_workload
from repro_torch.serving import (AdaptiveScheduler, DriftDetector,
                                 TenantRegistry, WorkloadRequest)
from repro_torch.serving.tenancy import fork_model


class _CalibratedStub:
    def predict_configs(self, feats, candidates):
        F = np.asarray(feats)
        preds = np.ones((np.atleast_2d(F).shape[0], len(candidates)))
        return preds[0] if F.ndim == 1 else preds


def _req(cls, seed=0, tenant="default", workload="vecadd", rows=64):
    wl = get_workload(workload)
    chunked, shared = wl.make_data(rows, np.random.default_rng(seed))
    return cls(workload=workload, chunked=chunked, shared=shared,
               tenant=tenant)


def test_namespaced_keys_match_jax():
    wl = get_workload("mvmult")
    chunked, shared = wl.make_data(128, np.random.default_rng(0))
    plain = TuningCache.key("mvmult", chunked, shared, "host-sync")
    spaced = TuningCache.key("mvmult", chunked, shared, "host-sync",
                             namespace="tenant-a")
    assert not plain.startswith("tenant:")
    assert spaced == f"tenant:tenant-a|{plain}"
    for ns in ("", "tenant-a", "tenant-b"):
        assert TuningCache.key("mvmult", chunked, shared, "host-sync",
                               "mlp-v002", namespace=ns) == JaxCache.key(
            "mvmult", chunked, shared, "host-sync", "mlp-v002", namespace=ns)


def test_registry_shared_until_isolation_requested():
    drift = DriftDetector(threshold=2.0)
    shared = TenantRegistry(object(), drift, isolate=False)
    assert shared.get("a") is shared.get("b")
    assert shared.get("a").drift is drift and shared.namespace("a") == ""
    iso = TenantRegistry(object(), drift, isolate=True)
    a, b = iso.get("a"), iso.get("b")
    assert a is not b and iso.get("a") is a
    assert a.drift is not drift and a.drift is not b.drift
    assert a.drift.threshold == drift.threshold
    assert (iso.namespace("a"), len(iso)) == ("a", 2)


def test_fork_model_deep_copies_on_the_models_device():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, 25))
    y = X[:, 0] * 2.0 + 1.0
    base = PerformanceModel.train(X, y, epochs=60, seed=0, device="cpu")
    before = base.predict(X[:8]).copy()
    weights = [{k: t.clone() for k, t in layer.items()}
               for layer in base.mlp_params]

    fork = fork_model(base)
    assert fork is not base and fork.device == base.device
    for mine, theirs in zip(fork.mlp_params, base.mlp_params):
        for k in mine:
            assert mine[k].device == theirs[k].device
            assert mine[k].data_ptr() != theirs[k].data_ptr()
    np.testing.assert_allclose(fork.predict(X[:8]), before)

    # an in-place write to the fork's weights cannot reach the base ...
    with torch.no_grad():
        fork.mlp_params[0]["w"].add_(1.0)
    np.testing.assert_allclose(base.predict(X[:8]), before)
    # ... and neither can a refit
    fork.refit(X[:16], y[:16] + 3.0, epochs=80, lr=3e-3)
    assert not np.allclose(fork.predict(X[:8]), before)
    for mine, want in zip(base.mlp_params, weights):
        for k in mine:
            torch.testing.assert_close(mine[k], want[k], rtol=0, atol=0)
    # a model with no refit hook is shared, never copied
    heur = OverlapHeuristicModel()
    assert fork_model(heur) is heur


def test_isolated_tenants_make_the_jax_decisions():
    """Four requests over two isolated tenants: each tenant's first
    sight of the bucket is its own cold miss, in both packages."""
    port = AdaptiveScheduler(_CalibratedStub(), device="cpu",
                             isolate_tenants=True)
    ref = JaxScheduler(_CalibratedStub(), isolate_tenants=True)
    for sched, cls in ((port, WorkloadRequest), (ref, JaxRequest)):
        sched.submit_all([_req(cls, 0, "a"), _req(cls, 1, "b"),
                          _req(cls, 2, "a"), _req(cls, 3, "b")])
    rp, rr = port.run(), ref.run()
    assert [r.cache_hit for r in rp] == [r.cache_hit for r in rr] == \
        [False, False, True, True]
    assert [r.sample.key for r in rp] == [r.sample.key for r in rr]
    assert port.stats["model_searches"] == ref.stats["model_searches"] == 2
    assert sorted(port.cache.keys()) == sorted(ref.cache.keys())
    assert all(k.startswith("tenant:") for k in port.cache.keys())
