"""The port's end-to-end systems (``launch.train.train_loop``,
``launch.serve.serve`` and the paper's pipeline: profile, features, model,
search, config) against the JAX package's, on the CPU.

Every case of ``tests/test_system.py`` runs here under its own name on
both packages, the port with ``device="cpu"``: the JAX case's assertions
hold for each, and the outcomes are compared.

- Training: the port's ``train_loop`` starts from the JAX package's
  initial parameters (``weights.params_from_jax``) on the same synthetic
  batches, so its losses match JAX's step for step (within ``LOSS_TOL``).
- Serving: the port's ``serve`` is fed the JAX weights and must generate
  JAX's greedy tokens exactly.
- The pipeline: the JAX package profiles the eight cells into a profile
  cache, and the port profiles them into its own (both on a 4x8 config
  grid, as ``conftest.py`` gives the JAX package); measured times differ
  between any two runs, so the port's own profiles are held to the case's
  invariants, and both packages then read the JAX cache, which gives them
  the same samples: equal matrices, equal leave-one-out splits, and from
  MLPs trained on them from the same initial weights, equal picks.  What
  a tuner measures on its own (the unseen program's features, the
  annealing's objective) is held to the case's invariants, and the
  annealing's search, run on a deterministic objective, makes the same
  calls on both packages.
"""
import types

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

import repro.core.autotuner as jautotuner
import repro.core.dataset as jdataset
import repro.core.modeling.perf_model as jmlp
import repro.core.perf_model as jperf_model
import repro.core.search as jsearch
import repro.core.stream_config as jstream_config
import repro.core.streams as jstreams
import repro.core.workloads as jworkloads
import repro.launch.serve as jserve
import repro.launch.train as jtrain
import repro_torch.core.autotuner as tautotuner
import repro_torch.core.dataset as tdataset
import repro_torch.core.modeling.dataset as tmodeling_dataset
import repro_torch.core.modeling.perf_model as tmlp
import repro_torch.core.perf_model as tperf_model
import repro_torch.core.search as tsearch
import repro_torch.core.stream_config as tstream_config
import repro_torch.core.streams as tstreams
import repro_torch.core.workloads as tworkloads
import repro_torch.launch.serve as tserve
import repro_torch.launch.train as ttrain
from repro.configs.base import get_arch as jax_get_arch
from repro.models.model_zoo import Model as JaxModel
from repro_torch.models.model_zoo import Model as PortModel
from repro_torch.weights import params_from_jax

LOSS_TOL = dict(rtol=1e-4)
PRED_TOL = dict(rtol=1e-5, atol=1e-5)
PROGRAMS = ["vecadd", "binomial", "jacobi-1d", "sgemm"]


def _pkg(name, ds, perf_model, search, stream_config, streams, workloads, autotuner,
         serve, train, kw):
    return types.SimpleNamespace(
        name=name, ds=ds, pm=perf_model, search=search, Config=stream_config.StreamConfig,
        Runner=streams.StreamedRunner, get_workload=workloads.get_workload,
        AutoTuner=autotuner.AutoTuner, serve=serve.serve, train_loop=train.train_loop,
        kw=kw)


JAX = _pkg("jax", jdataset, jperf_model, jsearch, jstream_config, jstreams, jworkloads,
           jautotuner, jserve, jtrain, {})
PORT = _pkg("port", tdataset, tperf_model, tsearch, tstream_config, tstreams, tworkloads,
            tautotuner, tserve, ttrain, {"device": "cpu"})


def _jax_params(arch, seed=0):
    params, _ = JaxModel(jax_get_arch(arch).reduced()).init(jax.random.key(seed))
    return jax.tree.map(np.asarray, jax.device_get(params))


def _jax_init(seed, in_dim, hidden=(9, 9, 9), *, device="cpu"):
    """The JAX package's initial MLP weights for ``seed``, as tensors."""
    params = jmlp._init_mlp(jax.random.key(seed), in_dim, hidden)
    return [{k: torch.from_numpy(np.array(layer[k])).to(device) for k in ("w", "b")}
            for layer in params]


def _train_both(monkeypatch, arch, **kw):
    """``train_loop`` on both packages, the port from JAX's initial
    parameters (``train_loop``'s seed 0)."""
    jres = jtrain.train_loop(arch, verbose=False, **kw)
    carried = params_from_jax(_jax_params(arch))
    monkeypatch.setattr(PortModel, "init", lambda self, gen: carried)
    tres = ttrain.train_loop(arch, verbose=False, device="cpu", **kw)
    return jres, tres


def test_training_loss_goes_down(monkeypatch):
    jres, tres = _train_both(monkeypatch, "stablelm-3b", steps=25, batch=4, seq=16, lr=3e-3)
    for res in (jres, tres):
        assert res.steps_run == 25
        first, last = float(np.mean(res.losses[:5])), float(np.mean(res.losses[-5:]))
        assert last < first, (first, last)
    np.testing.assert_allclose(tres.losses, jres.losses, **LOSS_TOL)


def test_training_with_microbatches_matches_shapes(monkeypatch):
    jres, tres = _train_both(monkeypatch, "yi-9b", steps=6, batch=8, seq=16, microbatches=4)
    for res in (jres, tres):
        assert res.steps_run == 6
        assert np.isfinite(res.losses).all()
    np.testing.assert_allclose(tres.losses, jres.losses, **LOSS_TOL)


def _serve_both(arch, **kw):
    want = jserve.serve(arch, verbose=False, **kw)
    got = tserve.serve(arch, verbose=False, device="cpu",
                       params=params_from_jax(_jax_params(arch)), **kw)
    assert len(got.outputs) == len(want.outputs)
    for g, w in zip(got.outputs, want.outputs):
        np.testing.assert_array_equal(g, np.asarray(w))
    return want, got


def test_serving_generates_tokens():
    for res in _serve_both("stablelm-3b", n_requests=4, batch_slots=2, prompt_len=8,
                           gen_len=6):
        assert res.tokens_generated == 4 * 6
        assert all(o.shape == (6,) for o in res.outputs)
        assert res.tokens_per_s > 0


def test_serving_greedy_deterministic():
    kw = dict(n_requests=2, batch_slots=2, prompt_len=8, gen_len=4)
    first = _serve_both("musicgen-medium", **kw)
    second = _serve_both("musicgen-medium", **kw)
    for r1, r2 in zip(first, second):
        for a, b in zip(r1.outputs, r2.outputs):
            np.testing.assert_array_equal(a, b)


# -- the paper's pipeline ---------------------------------------------------


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """Each package's own profiles of the eight cells (the port's on the
    JAX package's 4x8 test grid), and the port's read of the JAX cache."""
    d = tmp_path_factory.mktemp("profiles")
    jax_cache, port_cache = d / "jax.json", d / "port.json"
    jax_samples = jdataset.generate(PROGRAMS, datasets_per_program=2, reps=1,
                                    cache_path=str(jax_cache), verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        orig = tmodeling_dataset.grid_for
        mp.setattr(tmodeling_dataset, "grid_for",
                   lambda n_rows, max_partitions=4, max_tasks=8:
                   orig(n_rows, max_partitions, max_tasks))
        port_own = tdataset.generate(PROGRAMS, datasets_per_program=2, reps=1,
                                     cache_path=str(port_cache), verbose=False,
                                     device="cpu")
    port_read = tdataset.generate(PROGRAMS, datasets_per_program=2, reps=1,
                                  cache_path=str(jax_cache), verbose=False, device="cpu")
    return {"jax": jax_samples, "port": port_read, "port_own": port_own}


def _trained(p, samples, epochs, monkeypatch):
    X, y = p.ds.training_matrix(samples)
    monkeypatch.setattr(tmlp, "_init_mlp", _jax_init)
    return p.pm.PerformanceModel.train(X, y, epochs=epochs, **p.kw), X, y


def test_pipeline_profiles_and_caches(profiled):
    for samples in profiled.values():
        assert len(samples) == 8
        for s in samples:
            assert np.isfinite(s.features).all()
            assert s.oracle_speedup >= 1.0
            assert s.times[(1, 1)] > 0
    cells = {k: [(s.program, s.scale, sorted(s.times)) for s in v] for k, v in profiled.items()}
    assert cells["port_own"] == cells["port"] == cells["jax"]
    for a, b in zip(profiled["port"], profiled["jax"]):
        np.testing.assert_array_equal(a.features, b.features)
        assert a.times == b.times


def test_model_trained_on_profiles_beats_worst_config(profiled, monkeypatch):
    out = []
    for p in (JAX, PORT):
        samples = profiled[p.name]
        model, X, _ = _trained(p, samples, 300, monkeypatch)
        s = samples[0]
        cfgs = [p.Config(*pt) for pt in s.times]
        best, preds, dt = p.search.search_best(model, s.features, cfgs)
        worst = min(s.t_single / v for v in s.times.values())
        assert s.speedup(best) > worst
        assert dt < 1.0
        out.append((X, best.as_tuple(), preds))
    (jX, jbest, jpreds), (tX, tbest, tpreds) = out
    np.testing.assert_array_equal(tX, jX)
    assert tbest == jbest
    np.testing.assert_allclose(tpreds, jpreds, **PRED_TOL)


def test_autotuner_end_to_end(profiled, monkeypatch):
    for p in (JAX, PORT):
        model, _, _ = _trained(p, profiled[p.name], 200, monkeypatch)
        wl = p.get_workload("dotprod")
        chunked, shared = wl.make_data(wl.datasets[0], np.random.default_rng(0))
        result = p.AutoTuner(model, **p.kw).tune(wl, chunked, shared)
        assert result.config.partitions >= 1
        assert result.search_seconds < 1.0
        assert not result.cached and result.backend == "host-sync"


def test_loo_split_excludes_family(profiled):
    out = []
    for p in (JAX, PORT):
        train, test = p.ds.loo_split(profiled[p.name], "vecadd")
        assert all(s.program != "vecadd" for s in train)
        assert all(s.program == "vecadd" for s in test)
        out.append(([(s.program, s.scale) for s in train], [(s.program, s.scale) for s in test]))
    assert out[1] == out[0]


def test_simulated_annealing_on_measured_objective():
    for p in (JAX, PORT):
        wl = p.get_workload("vecadd")
        chunked, shared = wl.make_data(512, np.random.default_rng(0))
        runner = p.Runner(wl, chunked, shared, **p.kw)
        calls = []

        def obj(cfg):
            calls.append(cfg)
            return runner.run(cfg, reps=1)

        _, cost = p.search.simulated_annealing(obj, iters=8, seed=0)
        assert len(calls) == 9 and cost > 0

    def walk(p):
        calls = []

        def obj(cfg):
            calls.append(cfg.as_tuple())
            return 1.0 + abs(np.log2(cfg.tasks) - 3) + 0.1 * cfg.partitions

        best, cost = p.search.simulated_annealing(obj, iters=8, seed=0)
        return calls, best.as_tuple(), cost
    assert walk(PORT) == walk(JAX)
