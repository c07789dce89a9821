"""End-to-end training entry point (the JAX package's ``launch/train.py``).

Wires the subsystems together: model zoo -> parameters and AdamW state on
the device -> streamed (microbatched) train step -> prefetching data feed
-> atomic checkpointing with auto-resume -> straggler watchdog.  On a card
every RMSNorm and attention of the step, forward and backward, runs
through the hand-written kernels (``kernels.ops``).

Reduced configs by default; ``--full`` trains the published widths and
depth (stablelm-3b fits one 80 GB card in fp32 at batch 4 x 512 in two
microbatches).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --device cpu --steps 5                                 # plain versions
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.core.stream_config import StreamConfig
from repro_torch.core.streams import streamify_train_step
from repro_torch.data.pipeline import DataConfig, PrefetchFeeder, SyntheticLM
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import RunConfig
from repro_torch.optim import optimizer as opt_lib


class StragglerWatchdog:
    """Detects stuck steps (dead/slow node analogue).  If a step exceeds
    `factor` x the rolling median it is logged; if it exceeds `timeout_s`
    the registered recovery callback fires (checkpoint-restore / remesh in
    a real deployment; here: logged + counted so tests can assert)."""

    def __init__(self, factor: float = 5.0, timeout_s: float = 300.0):
        self.factor = factor
        self.timeout_s = timeout_s
        self.history: list[float] = []
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.history.append(dt)
        med = float(np.median(self.history[-50:]))
        slow = len(self.history) > 5 and (
            dt > self.factor * med or dt > self.timeout_s)
        if slow:
            self.flagged.append(step)
        return slow


@dataclasses.dataclass
class TrainLoopResult:
    steps_run: int
    final_loss: float
    losses: list
    resumed_from: Optional[int]
    straggler_steps: list


def make_train_step(model: Model, ocfg: opt_lib.AdamWConfig, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: the mean loss and gradient over ``microbatches`` (the
    ``mesh`` backend), then one AdamW update, in place."""
    grad_fn = streamify_train_step(lambda p, b: model.loss(p, b),
                                   StreamConfig(1, microbatches))

    def train_step(params, opt_state, batch):
        loss, _, grads = grad_fn(params, batch)
        params, opt_state, om = opt_lib.apply_updates(params, grads, opt_state, ocfg)
        return params, opt_state, loss, om

    return train_step


def _restored(tree, device):
    """A restored checkpoint tree in the port's layout: tensors on
    ``device`` (the optimizer's step stays on the host), sequences as
    lists."""
    if isinstance(tree, dict):
        return {k: (v if k == "step" else _restored(v, device)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_restored(v, device) for v in tree]
    return tree.to(device)


def train_loop(
    arch: str,
    *,
    steps: int = 50,
    batch: int = 8,
    seq: int = 64,
    microbatches: int = 1,
    reduced: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 20,
    lr: float = 1e-3,
    seed: int = 0,
    prefetch: int = 2,
    verbose: bool = True,
    device="cuda",
) -> TrainLoopResult:
    """Train ``arch`` for ``steps`` steps on ``device`` (the card unless the
    caller passes ``device="cpu"``; raises where CUDA is missing)."""
    model = Model(get_arch(arch).reduced() if reduced else get_arch(arch),
                  RunConfig(), device=device)
    cfg, dev = model.cfg, model.device

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    ocfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                               total_steps=steps)
    opt_state = opt_lib.init_state(params, ocfg)
    train_step = make_train_step(model, ocfg, microbatches)

    # ---- fault tolerance: auto-resume --------------------------------------
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step, resumed_from = 0, None
    if ckpt is not None:
        latest, tree = ckpt.restore()
        if tree is not None:
            del params, opt_state
            params = _restored(tree["params"], dev)
            opt_state = _restored(tree["opt"], dev)
            start_step = int(tree["meta"]["step"]) + 1
            resumed_from = latest
            if verbose:
                print(f"resumed from checkpoint step {latest}")

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, frontend_dim=cfg.frontend_dim if cfg.frontend else 0))
    feeder = PrefetchFeeder(data, dev, depth=prefetch, start_step=start_step)
    watchdog = StragglerWatchdog()

    losses: list[float] = []
    try:
        for step in range(start_step, steps):
            got_step, dev_batch = feeder.next()
            assert got_step == step
            t0 = time.perf_counter()
            params, opt_state, loss, om = train_step(params, opt_state, dev_batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            watchdog.observe(step, dt)
            losses.append(loss)
            if verbose and (step % 10 == 0 or step == steps - 1):
                print(f"step {step:4d} loss {loss:8.4f} "
                      f"gnorm {float(om['grad_norm']):7.3f} {dt*1e3:7.1f}ms")
            if ckpt is not None and (step + 1) % ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state,
                                 "meta": {"step": step}})
    finally:
        feeder.stop()
        if ckpt is not None:
            ckpt.wait()

    return TrainLoopResult(
        steps_run=len(losses), final_loss=losses[-1] if losses else float("nan"),
        losses=losses, resumed_from=resumed_from,
        straggler_steps=watchdog.flagged)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args()
    res = train_loop(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        microbatches=args.microbatches, reduced=not args.full,
        ckpt_dir=args.ckpt_dir, lr=args.lr, device=args.device)
    print(f"done: {res.steps_run} steps, final loss {res.final_loss:.4f}")


if __name__ == "__main__":
    main()
