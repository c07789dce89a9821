"""Quickstart: the two faces of the framework, on the card.

1. Train a reduced-config assigned architecture end-to-end (synthetic data,
   AdamW, checkpointing).
2. Autotune the stream configuration of a data-parallel workload with the
   learned performance model (the paper's technique).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The profile and tuning caches go to ``build/examples/`` in the checkout;
a second run warm-starts from them (delete them for a cold run).
"""
import argparse
import os
import time

import numpy as np

from repro_torch.core import dataset as ds
from repro_torch.core.autotuner import AutoTuner, TuningCache
from repro_torch.core.perf_model import PerformanceModel
from repro_torch.core.workloads import get_workload
from repro_torch.launch.train import train_loop

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "examples")


def main(device="cuda", *, programs=("vecadd", "binomial", "sgemm"),
         datasets_per_program=2, epochs=300, cache_dir=CACHE_DIR):
    os.makedirs(cache_dir, exist_ok=True)
    print("=== 1. train a reduced yi-9b for 30 steps ===")
    res = train_loop("yi-9b", steps=30, batch=4, seq=32, verbose=True, device=device)
    print(f"loss {res.losses[0]:.3f} -> {res.final_loss:.3f}\n")

    print(f"=== 2. learn a performance model on {len(programs)} programs, tune a 4th ===")
    samples = ds.generate(list(programs), datasets_per_program=datasets_per_program, reps=1,
                          cache_path=os.path.join(cache_dir, "quickstart_cache.json"),
                          device=device)
    X, y = ds.training_matrix(samples)
    model = PerformanceModel.train(X, y, epochs=epochs, device=device)

    wl = get_workload("dotprod")  # never seen in training
    chunked, shared = wl.make_data(2048, np.random.default_rng(0))
    cache = TuningCache(os.path.join(cache_dir, "quickstart_tuning_cache.json"))
    tuner = AutoTuner(model, cache=cache, device=device)
    t0 = time.perf_counter()
    result = tuner.tune(wl, chunked, shared)
    t_cold = time.perf_counter() - t0
    print(f"chosen stream config for dotprod: "
          f"(partitions={result.config.partitions}, tasks={result.config.tasks})")
    print(f"predicted speedup {result.predicted_speedup:.2f}x; "
          f"search took {result.search_seconds*1e3:.2f} ms "
          f"(feature extraction {result.feature_seconds*1e3:.0f} ms)")

    print("=== 3. warm-start from the persistent tuning cache ===")
    # a second request in the same shape bucket skips profiling entirely:
    # the serving-time deployment flow (save the cache, reload at startup)
    t1 = time.perf_counter()
    warm = tuner.tune(wl, chunked, shared)
    t_warm = time.perf_counter() - t1
    cache.save()
    if result.cached:
        # the whole script warm-started from a previous run's persisted file
        print(f"cache file from a previous run served both tunes in ~"
              f"{t_warm*1e6:.0f} us (delete {cache.path} for a cold demo)")
    else:
        print(f"warm hit: cached={warm.cached}, "
              f"same config={warm.config == result.config}, "
              f"{t_cold*1e3:.0f} ms cold -> {t_warm*1e6:.0f} us warm "
              f"({t_cold/max(t_warm, 1e-9):.0f}x); "
              f"cache persisted to {cache.path}")
    return res, result, warm


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
