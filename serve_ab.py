#!/usr/bin/env python3
"""Same-card A/B of the PyTorch/CUDA port between two source trees.

    python3 serve_ab.py --workload runner|train|moe --a OLD/src --b src
                        [--rounds 4] [--reps 5]

Each of ``--a`` and ``--b`` is a ``src`` directory that holds ``repro_torch``
(for example an older commit unpacked with ``git archive``).  The script runs
one worker process per tree in the order a, b, b, a, a, b, ... (``--rounds``
pairs); alternating the trees within one call spreads the shared host's drift
over both.  TF32 is off in every worker.  ``--workload`` picks what a worker
times (the benchmark's ``yi-9b.*`` cells, ``portbench/``, time the language
model's serving):

* ``runner``: ``StreamedRunner.run`` (H2D, kernels, D2H of every slice; the
  min of ``--reps``) on the cells below, at each program's largest dataset,
  with ``host-sync`` and ``host-pipelined``; milliseconds per cell.
* ``moe``: xlstm-350m at full width and depth, then grok-1-314b (2 layers),
  jamba-1.5-large-398b (2) and arctic-480b (1) at full width, as
  ``chip_smoke.py`` phase 3b runs them: fp32, ``Model.prefill`` of 4 x 512
  prompt tokens (timed on its second call), then 7 ``Model.decode_step``s;
  prefill seconds and decode milliseconds a step.
* ``train``: the two backward kernels' device time a call (torch.profiler,
  every launch of the wrapper) at one stablelm-3b training microbatch's
  shapes, fp32, as ``chip_smoke.py`` phase 3c times them; then stablelm-3b
  at full width and depth trained 6 steps of 4 x 512 tokens in 2
  microbatches from seeded weights, and the median step time after the
  first (host clock around each step, synchronized).

Every measurement prints one JSON line; the end gives, per cell, metric and
tree, the median and range, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# (program, partitions, tasks): the fewest and the most slices of vecadd,
# binomial's launch train, and two mid-grid splits
CELLS = (("vecadd", 1, 1), ("vecadd", 32, 64), ("binomial", 1, 1),
         ("mvmult", 4, 8), ("jacobi-1d", 1, 1), ("jacobi-1d", 2, 16))
BACKENDS = ("host-sync", "host-pipelined")
METRICS = {"runner": ("ms",), "train": ("device_ms", "step_s"), "moe": ("prefill_s", "decode_ms")}
# (arch, layers kept of its stack, None for all), 4 x 512 prompt, 8 tokens
MOE_CELLS = (("xlstm-350m", None), ("grok-1-314b", 2), ("jamba-1.5-large-398b", 2),
             ("arctic-480b", 1))
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 512, 8
# one stablelm-3b training microbatch (batch 2 of 512 tokens): its attention
# (B, S, H, KV, hd) and its RMSNorm rows x width
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = "stablelm-3b", 4, 512, 2, 6
TRAIN_ATTN, TRAIN_NORM = (2, 512, 32, 32, 80), (1024, 2560)


def moe_worker(label: str, args) -> None:
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.model_zoo import Model

    _build.build_all()
    for arch, depth in MOE_CELLS:
        if args.archs and arch not in args.archs.split(","):
            continue
        cfg = get_arch(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, num_layers=depth,
                                      layer_pattern=tuple(cfg.layer_pattern)[:depth])
        model = Model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), device="cuda",
                             generator=gen, dtype=torch.int32)
        with torch.inference_mode():
            model.prefill(params, {"tokens": toks})  # a first call, untimed (cuBLAS set-up)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, filled = model.prefill(params, {"tokens": toks})
            cache = model.decode_cache(filled, MOE_PROMPT + MOE_GEN)
            del filled
            tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            for i in range(MOE_GEN - 1):
                logits, cache = model.decode_step(params, {"tokens": tok[:, None]}, cache,
                                                  MOE_PROMPT + i)
                tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0 - prefill_s
            if not torch.isfinite(logits).all():
                raise SystemExit(f"{label}: non-finite logits")
        print(json.dumps({"tree": label, "cell": f"{arch} {cfg.num_layers} layers",
                          "prefill_s": prefill_s,
                          "decode_ms": decode_s / (MOE_GEN - 1) * 1e3}), flush=True)
        del model, params, logits, cache, tok
        torch.cuda.empty_cache()


def runner_worker(label: str, args) -> None:
    import numpy as np

    from repro_torch.core.stream_config import StreamConfig
    from repro_torch.core.streams import StreamedRunner
    from repro_torch.core.workloads import get_workload

    for name, p, t in CELLS:
        wl = get_workload(name)
        chunked, shared = wl.make_data(wl.datasets[-1], np.random.default_rng(0))
        for backend in BACKENDS:
            runner = StreamedRunner(wl, chunked, shared, device="cuda", backend=backend)
            ms = runner.run(StreamConfig(p, t), reps=args.reps) * 1e3
            print(json.dumps({"tree": label, "cell": f"{name}@{wl.datasets[-1]} ({p}, {t}) "
                              f"{backend}", "ms": ms}), flush=True)


def train_worker(label: str, args) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model_zoo import Model
    from repro_torch.optim import optimizer as opt_lib

    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def device_ms(fn, sets, iters):
        fn(*sets[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if not us:
            raise SystemExit(f"{label}: the profiler saw no device work")
        return us / iters / 1e3

    B, S, H, KV, hd = TRAIN_ATTN
    sets = []
    for _ in range(4):
        q, k, v = randn((B, S, H, hd)), randn((B, S, KV, hd)), randn((B, S, KV, hd))
        o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        sets.append((q, k, v, o, lse, randn((B, S, H, hd))))
    ms = device_ms(lambda *a: flash_attention_bwd_cuda(*a, causal=True), sets, 20)
    print(json.dumps({"tree": label, "cell": f"flash_attention_bwd {TRAIN_ATTN} fp32",
                      "device_ms": ms}), flush=True)
    rows, d = TRAIN_NORM
    sets = [(randn((rows, d)), randn((d,)), randn((rows, d))) for _ in range(4)]
    ms = device_ms(rmsnorm_bwd_cuda, sets, 100)
    print(json.dumps({"tree": label, "cell": f"rmsnorm_bwd {TRAIN_NORM} fp32",
                      "device_ms": ms}), flush=True)
    del sets

    cfg = get_arch(TRAIN_ARCH)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS)
    state = opt_lib.init_state(params, ocfg)
    step = train_mod.make_train_step(model, ocfg, TRAIN_MB)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    times = []
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
                 for k, v in data.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(json.dumps({"tree": label, "cell": f"{TRAIN_ARCH} train step "
                      f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches",
                      "step_s": statistics.median(times[1:]), "loss": float(loss)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="src directory of tree a")
    ap.add_argument("--b", help="src directory of tree b")
    ap.add_argument("--workload", choices=sorted(METRICS), required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5, help="runner: runs per cell, min taken")
    ap.add_argument("--archs", default="", help="moe: a comma-separated subset of its archs")
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        src, label = args.worker
        sys.path.insert(0, os.path.abspath(src))
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        {"runner": runner_worker, "train": train_worker, "moe": moe_worker}[args.workload](
            label, args)
        return 0
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    trees = {"a": args.a, "b": args.b}
    for path in trees.values():
        if not os.path.isdir(os.path.join(path, "repro_torch")):
            raise SystemExit(f"no repro_torch under {path}")
    rows = []
    for r in range(args.rounds):
        for label in ("ab" if r % 2 == 0 else "ba"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
                 "--reps", str(args.reps), "--archs", args.archs,
                 "--worker", trees[label], label],
                capture_output=True, text=True)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode != 0:
                raise SystemExit(f"worker {label} failed with {out.returncode}")
            for line in out.stdout.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
                    rows.append(json.loads(line))
    for cell in dict.fromkeys(r["cell"] for r in rows):
        for metric in METRICS[args.workload]:
            if not any(metric in r for r in rows if r["cell"] == cell):
                continue
            parts = []
            for label in trees:
                vals = [r[metric] for r in rows if r["tree"] == label and r["cell"] == cell]
                parts.append(f"{label} median {statistics.median(vals):.4f} "
                             f"({min(vals):.4f}-{max(vals):.4f}, n={len(vals)})")
            print(f"{cell:40s} {metric:9s} " + ", ".join(parts))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
