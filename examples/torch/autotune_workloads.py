"""The paper's experiment in miniature, on the card: leave-one-out
autotuning across a workload subset, reporting achieved vs oracle speedup
per program (paper Fig. 9).

    PYTHONPATH=src python examples/torch/autotune_workloads.py [--device cpu]

Profiles go to the port's profile cache (``build/profile_cache_<device
type>.json``, or ``REPRO_TORCH_PROFILE_CACHE``); cells already there are
read back, not profiled again.
"""
import argparse

import numpy as np

from repro_torch.core import dataset as ds
from repro_torch.core.features import config_features
from repro_torch.core.perf_model import PerformanceModel
from repro_torch.core.stream_config import StreamConfig

PROGRAMS = ["vecadd", "binomial", "sgemm", "jacobi-1d", "mri-q", "dotprod"]


def main(device="cuda", *, programs=PROGRAMS, datasets_per_program=3, reps=2, epochs=500,
         cache_path=None):
    samples = ds.generate(programs, datasets_per_program=datasets_per_program, reps=reps,
                          cache_path=cache_path, device=device)

    print(f"{'program':12s} {'achieved':>9s} {'oracle':>8s} {'% of oracle':>12s}")
    total_a, total_o = [], []
    for prog in programs:
        train, test = ds.loo_split(samples, prog)
        X, y = ds.training_matrix(train)
        model = PerformanceModel.train(X, y, epochs=epochs, device=device)
        for s in test:
            cfgs = [StreamConfig(p, t) for (p, t) in s.times]
            Xq = np.stack([np.concatenate(
                [s.features, config_features(c.partitions, c.tasks)])
                for c in cfgs])
            pick = cfgs[int(np.argmax(model.predict(Xq)))]
            a, o = s.speedup(pick), s.oracle_speedup
            total_a.append(a)
            total_o.append(o)
            print(f"{prog+'@'+str(s.scale):18s} {a:8.2f}x {o:7.2f}x "
                  f"{100*a/o:11.1f}%")

    gm = lambda v: float(np.exp(np.mean(np.log(np.maximum(v, 1e-9)))))
    print(f"\nGEOMEAN achieved {gm(total_a):.2f}x, oracle {gm(total_o):.2f}x "
          f"-> {100*gm(total_a)/gm(total_o):.1f}% of oracle "
          f"(paper: 93.7% XeonPhi / 97.9% GPU)")
    return total_a, total_o


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
