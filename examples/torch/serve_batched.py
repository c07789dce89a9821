"""Serving demos, on the card.

Part 1: batched LM serving: prefill + KV-cached greedy decode over
batched request slots, for a dense LM and for the recurrent xLSTM
(O(1) state).

Part 2: the TuningCache warm-start flow (the serving deployment story):
the first tune of a (workload, shape-bucket) profiles and searches; every
later request in the same bucket is a cache hit that skips both.  Prints
cold vs. warm tuning latency side by side.

    PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.autotuner import AutoTuner, TuningCache
from repro_torch.core.workloads import get_workload
from repro_torch.launch.serve import serve
from repro_torch.serving import OverlapHeuristicModel


def main(device="cuda"):
    for arch in ("yi-9b", "xlstm-350m"):
        print(f"=== serving {arch} (reduced config) ===")
        res = serve(arch, n_requests=6, batch_slots=3, prompt_len=12,
                    gen_len=8, verbose=True, device=device)
        print(f"{res.tokens_generated} tokens in {res.wall_s:.2f}s "
              f"({res.tokens_per_s:.0f} tok/s)\n")

    print("=== TuningCache warm-start (cold vs warm tuning latency) ===")
    cache = TuningCache()                 # pass a path to persist across boots
    tuner = AutoTuner(OverlapHeuristicModel(), cache=cache, device=device)
    rng = np.random.default_rng(0)
    for name in ("vecadd", "dotprod", "mvmult"):
        wl = get_workload(name)
        chunked, shared = wl.make_data(wl.datasets[1], rng)
        t0 = time.perf_counter()
        cold = tuner.tune(wl, chunked, shared)
        t_cold = time.perf_counter() - t0
        # same shape bucket, fresh data: the serving steady state
        chunked2, shared2 = wl.make_data(wl.datasets[1], rng)
        t0 = time.perf_counter()
        warm = tuner.tune(wl, chunked2, shared2)
        t_warm = time.perf_counter() - t0
        assert warm.cached and warm.config == cold.config
        print(f"{name:10s} config={cold.config.partitions}x{cold.config.tasks}"
              f"  cold={t_cold*1e3:8.2f}ms  warm={t_warm*1e6:6.1f}us"
              f"  ({t_cold/max(t_warm, 1e-9):7.0f}x faster)")
    print(f"cache: {cache.hits} hits / {cache.misses} misses "
          f"({len(cache)} entries)")
    return cache


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
