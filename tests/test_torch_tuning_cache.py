"""The port's persistent tuning cache (``repro_torch.core.autotuner``:
``TuningCache``, ``AutoTuner``, ``shape_bucket``, ``data_signature``)
against the JAX package's, on the CPU.

Every case of ``tests/test_tuning_cache.py`` runs here under its own name
on both packages (the port's tuner and runners with ``device="cpu"``): the
JAX case's assertions hold for each, and the two outcomes must be equal
(keys, hit and miss counts, picked configs, predicted speedups, backends).
``tests/test_torch_autotuner.py`` holds the cache files' exchange between
the packages.  The warm-hit case holds what the JAX case holds beside its
speed: the same config, counted as a hit, and no profiling on the warm
path (a count of feature extractions, not a wall-time ratio).
"""
import types

import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none

import repro.core.autotuner as jautotuner
import repro.core.stream_config as jstream_config
import repro.core.streams as jstreams
import repro.core.workloads as jworkloads
import repro_torch.core.autotuner as tautotuner
import repro_torch.core.stream_config as tstream_config
import repro_torch.core.streams as tstreams
import repro_torch.core.workloads as tworkloads


def _pkg(name, autotuner, stream_config, streams, workloads, kw):
    return types.SimpleNamespace(
        name=name, a=autotuner, Cache=autotuner.TuningCache, Result=autotuner.TuneResult,
        Config=stream_config.StreamConfig, Runner=streams.StreamedRunner,
        get_workload=workloads.get_workload, kw=kw,
        Tuner=lambda model, p_kw=kw, **k: autotuner.AutoTuner(model, **k, **p_kw))


JAX = _pkg("jax", jautotuner, jstream_config, jstreams, jworkloads, {})
PORT = _pkg("port", tautotuner, tstream_config, tstreams, tworkloads, {"device": "cpu"})


class _StubModel:
    """Deterministic stand-in for the trained MLP: prefers tasks=4."""

    def predict_configs(self, feats, candidates):
        return np.array([1.0 / (1.0 + abs(c.tasks - 4)) - 0.01 * c.partitions
                         for c in candidates])


class _MaxSplitModel:
    """Prefers the largest partitions*tasks product offered."""

    def predict_configs(self, feats, candidates):
        return np.array([float(c.partitions * c.tasks) for c in candidates])


def _data(p, name="vecadd", rows=256, seed=0):
    wl = p.get_workload(name)
    chunked, shared = wl.make_data(rows, np.random.default_rng(seed))
    return wl, chunked, shared


def _r(result):
    """A TuneResult's comparable fields."""
    return (result.config.as_tuple(), result.predicted_speedup, result.backend,
            result.cached)


def _both(scenario):
    jax_out, port_out = scenario(JAX), scenario(PORT)
    assert port_out == jax_out
    return jax_out


def test_shape_bucket():
    def scenario(p):
        got = [p.a.shape_bucket(n) for n in (1, 2, 3, 100, 128, 129)]
        assert got == [1, 2, 4, 128, 128, 256]
        return got
    _both(scenario)


def test_miss_then_hit_same_config():
    def scenario(p):
        wl, chunked, shared = _data(p)
        cache = p.Cache()
        tuner = p.Tuner(_StubModel(), cache=cache)
        cold = tuner.tune(wl, chunked, shared)
        assert not cold.cached and (cache.misses, cache.hits) == (1, 0)
        warm = tuner.tune(wl, chunked, shared)
        assert warm.cached and cache.hits == 1
        assert warm.config == cold.config
        assert warm.predicted_speedup == cold.predicted_speedup
        return _r(cold), _r(warm), cache.misses, cache.hits
    _both(scenario)


def test_same_bucket_shares_entry():
    def scenario(p):
        wl = p.get_workload("vecadd")
        rng = np.random.default_rng(0)
        c100, s100 = wl.make_data(100, rng)
        c120, s120 = wl.make_data(120, rng)
        c300, s300 = wl.make_data(300, rng)
        keys = [p.Cache.key(wl.name, c, s, "host-sync")
                for c, s in ((c100, s100), (c120, s120), (c300, s300))]
        assert keys[0] == keys[1] != keys[2]
        cache = p.Cache()
        tuner = p.Tuner(_StubModel(), cache=cache)
        first = tuner.tune(wl, c100, s100)
        warm = tuner.tune(wl, c120, s120)
        other = tuner.tune(wl, c300, s300)
        assert warm.cached and not other.cached
        return keys, _r(first), _r(warm), _r(other), cache.hits, cache.misses
    _both(scenario)


def test_hit_invalid_for_smaller_batch_retunes():
    def scenario(p):
        wl = p.get_workload("vecadd")
        rng = np.random.default_rng(0)
        c2048, s2048 = wl.make_data(2048, rng)
        c1056, s1056 = wl.make_data(1056, rng)
        assert (p.Cache.key(wl.name, c2048, s2048, "host-sync")
                == p.Cache.key(wl.name, c1056, s1056, "host-sync"))
        cache = p.Cache()
        tuner = p.Tuner(_MaxSplitModel(), cache=cache)
        big = tuner.tune(wl, c2048, s2048)
        assert big.config.partitions * big.config.tasks == 2048
        small = tuner.tune(wl, c1056, s1056)
        assert not small.cached
        assert small.config.partitions * small.config.tasks <= 1056
        again = (tuner.tune(wl, c2048, s2048), tuner.tune(wl, c1056, s1056))
        assert all(r.cached for r in again)
        return _r(big), _r(small), [_r(r) for r in again], cache.hits, cache.misses
    _both(scenario)


def test_key_separates_workload_backend_and_model_tag():
    def scenario(p):
        wl, chunked, shared = _data(p)
        keys = [p.Cache.key(wl.name, chunked, shared, "host-sync"),
                p.Cache.key(wl.name, chunked, shared, "host-pipelined"),
                p.Cache.key("sgemm", chunked, shared, "host-sync"),
                p.Cache.key(wl.name, chunked, shared, "host-sync", model_tag="v2")]
        assert len(set(keys)) == 4
        return keys
    _both(scenario)


def test_explicit_runner_backend_wins():
    def scenario(p):
        wl, chunked, shared = _data(p)
        cache = p.Cache()
        tuner = p.Tuner(_StubModel(), cache=cache)
        runner = p.Runner(wl, chunked, shared, backend="host-pipelined", **p.kw)
        result = tuner.tune(wl, chunked, shared, runner=runner)
        assert result.backend == "host-pipelined"
        plain = tuner.tune(wl, chunked, shared)
        assert not plain.cached
        return _r(result), _r(plain), cache.keys()
    _both(scenario)


def test_rejected_hit_counts_as_miss():
    def scenario(p):
        wl, chunked, shared = _data(p)
        cache = p.Cache()
        p.Tuner(_StubModel(), cache=cache).tune(wl, chunked, shared)
        got = cache.get(cache.key(wl.name, chunked, shared, "host-sync"),
                        valid=lambda r: False)
        assert got is None and cache.hits == 0 and cache.misses == 2
        return cache.hits, cache.misses
    _both(scenario)


def test_signature_covers_shared_and_dtype():
    def scenario(p):
        _, chunked, shared = _data(p, "mvmult", rows=128)
        sig = p.a.data_signature(chunked, shared)
        assert "float32" in sig and "v" in sig and "A" in sig and "768" in sig
        return sig
    _both(scenario)


def test_json_roundtrip_restores_identical_results(tmp_path):
    def scenario(p):
        wl, chunked, shared = _data(p)
        path = str(tmp_path / f"{p.name}.json")
        cache = p.Cache(path)
        cold = p.Tuner(_StubModel(), cache=cache).tune(wl, chunked, shared)
        cache.save()
        restored = p.Cache(path)
        assert len(restored) == len(cache) == 1
        warm = p.Tuner(_StubModel(), cache=restored).tune(wl, chunked, shared)
        assert warm.cached and warm.config == cold.config
        assert warm.predicted_speedup == pytest.approx(cold.predicted_speedup)
        assert warm.backend == cold.backend
        return _r(cold), _r(warm), restored.keys()
    _both(scenario)


def test_corrupt_cache_file_degrades_to_cold_start(tmp_path):
    def scenario(p):
        path = tmp_path / f"{p.name}.json"
        path.write_text("{not json")
        with pytest.warns(UserWarning, match="unreadable tuning cache"):
            cache = p.Cache(str(path))
        assert len(cache) == 0
        with pytest.raises(Exception) as info:
            cache.load(str(path))
        return len(cache), type(info.value).__name__
    _both(scenario)


def test_tuneresult_json_roundtrip():
    def scenario(p):
        r = p.Result(p.Config(3, 24), 1.75, 0.2, 0.001, backend="host-pipelined")
        back = p.Result.from_json(r.to_json())
        assert back == r
        return r.to_json()
    _both(scenario)


def test_warm_hit_is_100x_faster_and_same_config(monkeypatch):
    """The JAX case's invariants beside its speed: the warm tune returns
    the cold tune's config, counted as a hit, with no feature profiling."""
    def scenario(p):
        profiled = []
        extract = p.a.feat_lib.extract_features
        monkeypatch.setattr(p.a.feat_lib, "extract_features",
                            lambda *a, **k: profiled.append(1) or extract(*a, **k))
        wl, chunked, shared = _data(p, "fwt", rows=512, seed=7)
        cache = p.Cache()
        tuner = p.Tuner(_StubModel(), cache=cache)
        cold = tuner.tune(wl, chunked, shared)
        assert len(profiled) == 1
        warm = [tuner.tune(wl, chunked, shared) for _ in range(5)]
        assert len(profiled) == 1
        assert all(w.cached and w.config == cold.config for w in warm)
        return _r(cold), [_r(w) for w in warm], cache.hits, cache.misses
    _both(scenario)


def test_uncached_tuner_unchanged():
    def scenario(p):
        wl, chunked, shared = _data(p)
        tuner = p.Tuner(_StubModel())
        r1 = tuner.tune(wl, chunked, shared)
        r2 = tuner.tune(wl, chunked, shared)
        assert not r1.cached and not r2.cached and r1.config == r2.config
        return _r(r1), _r(r2)
    _both(scenario)
