"""The port's autotuner and tuning cache against the JAX package's.

Shape buckets, data signatures, cache keys and the JSON format must be
identical, so a cache written by either package warm-starts the other;
the tuner's cold and warm paths give the JAX tuner's config for the same
model and data.  The port profiles on the CPU here.
"""
import json

import numpy as np
import pytest

from repro.core.autotuner import AutoTuner as JaxTuner
from repro.core.autotuner import TuneResult as JaxResult
from repro.core.autotuner import TuningCache as JaxCache
from repro.core.autotuner import data_signature as jax_signature
from repro.core.autotuner import shape_bucket as jax_bucket
from repro.core.workloads import get_workload as jax_workload
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
from repro_torch.core.autotuner import (AutoTuner, TuneResult, TuningCache,
                                        data_signature, quarantine_file,
                                        shape_bucket)
from repro_torch.core.stream_config import StreamConfig
from repro_torch.core.workloads import get_workload


class _StubModel:
    """Deterministic stand-in for the trained MLP: prefers tasks=4."""

    def predict_configs(self, feats, candidates):
        return np.array([1.0 / (1.0 + abs(c.tasks - 4)) - 0.01 * c.partitions
                         for c in candidates])


def _data(name="vecadd", rows=256, seed=0):
    wl = get_workload(name)
    chunked, shared = wl.make_data(rows, np.random.default_rng(seed))
    return wl, chunked, shared


def test_shape_bucket_and_signature_match_jax():
    for n in (0, 1, 2, 3, 100, 128, 129, 4097, 16384):
        assert shape_bucket(n) == jax_bucket(n)
    for name in ("vecadd", "mvmult", "histo", "3mm", "binomial"):
        wl = get_workload(name)
        for scale in (wl.datasets[0], wl.datasets[-1]):
            chunked, shared = wl.make_data(scale, np.random.default_rng(0))
            assert data_signature(chunked, shared) == \
                jax_signature(chunked, shared)


@pytest.mark.parametrize("source", ["model", "refined", "fallback"])
def test_tuneresult_json_roundtrip_both_ways(source):
    r = TuneResult(StreamConfig(3, 24), 1.75, 0.2, 0.001,
                   backend="host-pipelined", source=source)
    assert TuneResult.from_json(r.to_json()) == r
    j = JaxResult.from_json(json.loads(json.dumps(r.to_json())))
    assert j.to_json() == r.to_json()
    back = TuneResult.from_json(json.loads(json.dumps(j.to_json())))
    assert back == r


def test_corrupt_cache_is_quarantined_and_rebuilt(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable tuning cache"):
        cache = TuningCache(str(path))
    assert len(cache) == 0
    assert cache.quarantined == str(path) + ".corrupt"
    assert not path.exists()
    assert (tmp_path / "cache.json.corrupt").read_text() == "{not json"
    # the next save writes a fresh file; a second corrupt copy gets the
    # next quarantine name, as the JAX package's does
    wl, chunked, shared = _data()
    cache.put(TuningCache.key(wl.name, chunked, shared, "host-sync"),
              TuneResult(StreamConfig(1, 4), 1.2, 0.0, 0.0))
    cache.save()
    assert len(JaxCache(str(path))) == 1
    path.write_text("[]")
    assert quarantine_file(str(path)) == str(path) + ".corrupt-1"
    assert quarantine_file(str(path)) is None


def test_tuner_miss_then_hit_matches_jax(tmp_path):
    wl, chunked, shared = _data()
    path = str(tmp_path / "port.json")
    cache = TuningCache(path)
    tuner = AutoTuner(_StubModel(), cache=cache, model_tag="stub",
                      device="cpu")
    cold = tuner.tune(wl, chunked, shared)
    warm = tuner.tune(wl, chunked, shared)
    assert not cold.cached and warm.cached
    assert (cache.misses, cache.hits) == (1, 1)
    assert warm.config == cold.config

    jax_cache = JaxCache(str(tmp_path / "jax.json"))
    ref = JaxTuner(_StubModel(), cache=jax_cache, model_tag="stub").tune(
        jax_workload("vecadd"), chunked, shared)
    assert cold.config.as_tuple() == ref.config.as_tuple() == (1, 4)
    assert cold.predicted_speedup == ref.predicted_speedup
    assert cache.keys() == jax_cache.keys()

    # the port's file warm-starts the JAX tuner and the other way round
    cache.save()
    jax_cache.save()
    hit = JaxTuner(_StubModel(), cache=JaxCache(path), model_tag="stub").tune(
        jax_workload("vecadd"), chunked, shared)
    assert hit.cached and hit.config.as_tuple() == (1, 4)
    hit = AutoTuner(_StubModel(), cache=TuningCache(str(tmp_path / "jax.json")),
                    model_tag="stub", device="cpu").tune(wl, chunked, shared)
    assert hit.cached and hit.config.as_tuple() == (1, 4)


def test_hit_unsplittable_for_smaller_batch_retunes():
    wl = get_workload("vecadd")
    c100, s100 = wl.make_data(100, np.random.default_rng(0))
    c65, s65 = wl.make_data(65, np.random.default_rng(1))   # same bucket
    cache = TuningCache()
    key = TuningCache.key(wl.name, c100, s100, "host-sync")
    assert key == TuningCache.key(wl.name, c65, s65, "host-sync")
    cache.put(key, TuneResult(StreamConfig(8, 16), 3.0, 0.0, 0.0))
    got = AutoTuner(_StubModel(), cache=cache, device="cpu").tune(
        wl, c65, s65)
    assert not got.cached and got.config.partitions * got.config.tasks <= 65
    assert cache.misses == 1
