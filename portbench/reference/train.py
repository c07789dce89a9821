"""The first training steps, in plain PyTorch: the mean loss and gradient
over the microbatches, global-norm clipping, and AdamW (Loshchilov and
Hutter, decoupled weight decay) with a linear warmup into a cosine
schedule, in fp32.

``steps`` returns what the comparison reads: each step's loss, the first
step's gradient after clipping (as the optimizer takes it) by leaf, the
norm of each leaf's change after the last step, and the first step's
gradient norm by leaf before clipping, which picks the leaves whose change
counts.  ``fault`` plants one of the faults the comparison must catch in
the reference put in the program's place: ``half_batch`` (the last
microbatches left out, the mean over the rest) or ``double_leaf`` (the
first block's ``w_in`` gradient doubled).
"""
from __future__ import annotations

import math

import torch

from portbench.lib import traffic, weights
from portbench.lib.dims import Dims
from portbench.reference import model


def lr_at(opt: dict, step: int) -> float:
    """A linear warmup into a cosine decay, the only schedule a cell sets."""
    if opt["schedule"] != "cosine":
        raise ValueError(f"the reference follows a cosine schedule; got {opt['schedule']!r}")
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * frac))


def _norms(ts) -> list[float]:
    return torch.stack([torch.linalg.vector_norm(t) for t in ts]).tolist()


def steps(dm: Dims, wl: dict, seed: int, device, n_steps: int, *, prec: str = "fp32",
          fault: str | None = None) -> dict:
    opt = wl["optimizer"]
    params = weights.make(dm, seed, device)
    leaves = weights.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    doubled = weights.leaf_names(dm).index("blocks.0.ffn.w_in")
    n_micro = wl["microbatches"]
    used = n_micro // 2 if fault == "half_batch" else n_micro
    out: dict = {"losses": []}
    for i in range(n_steps):
        batch = traffic.train_batch(dm, wl, seed, i, device)
        rows = batch["tokens"].shape[0] // n_micro
        total = 0.0
        for j in range(used):
            sl = slice(j * rows, (j + 1) * rows)
            loss = model.loss(params, batch["tokens"][sl], batch["labels"][sl], dm, prec=prec,
                              remat=True)
            loss.backward()
            total += loss.item()
        out["losses"].append(total / used)
        with torch.no_grad():
            grads = []
            for p in leaves:
                grads.append(p.grad.div_(used))
                p.grad = None
            if fault == "double_leaf":
                grads[doubled].mul_(2.0)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
            if i == 0:
                out["grad_raw"] = _norms(grads)
            t = i + 1
            lr = lr_at(opt, t)
            b1, b2 = opt["b1"], opt["b2"]
            for p, g, mi, vi in zip(leaves, grads, m, v):
                g.mul_(scale)
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mi / (1 - b1 ** t)) / (torch.sqrt(vi / (1 - b2 ** t)) + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
            if i == 0:
                out["grad"] = _norms(grads)
            del grads
    with torch.no_grad():
        p0 = weights.leaves(weights.make(dm, seed, device))
        out["change"] = _norms(p - q for p, q in zip(leaves, p0))
    return out
