"""AdamW, as the JAX package's ``optim/optimizer.py`` computes it:
  - cosine / linear / constant schedules after a linear warmup,
  - optional bf16 first and second moments (halves optimizer memory),
  - global-norm clipping.

Each leaf is updated in fp32 with the JAX package's order of operations,
so an fp32 run matches it to rounding.  Unlike the JAX version, which
returns new trees, :func:`apply_updates` writes the new parameters and
moments into the tensors it is given (in place, under ``torch.no_grad``):
at stablelm-3b's 2.8 B parameters a second copy of parameters and moments
would not fit beside them on one 80 GB card.  The returned trees are the
same objects.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"                  # cosine | linear | const


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a 0-d fp32
    tensor computed on the host in fp32 as the JAX package computes it."""
    step = _f32(step.cpu() if isinstance(step, torch.Tensor) else step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        decay = _f32(1.0)
    else:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + torch.cos(_f32(math.pi) * frac))
        else:
            decay = 1.0 - frac
    return _f32(cfg.lr) * warm * decay


def init_state(params, cfg: AdamWConfig) -> dict:
    """Step 0 (a host int32 scalar) and zero moments like each parameter,
    in ``cfg.state_dtype``."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32),
            "m": tree_lib.map(zeros, params),
            "v": tree_lib.map(zeros, params)}


def state_logical_axes(param_axes, cfg: AdamWConfig) -> dict:
    """Optimizer state shards exactly like its parameter."""
    return {"step": (), "m": param_axes, "v": param_axes}


def _global_norm(tree) -> torch.Tensor:
    total = 0
    for g in tree_lib.leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}), the
    trees updated in place; ``grad_norm`` is before clipping."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(_f32(b1), step.float())
    bc2 = 1.0 - torch.pow(_f32(b2), step.float())
    flat_p = tree_lib.leaves(params)
    flat_g = tree_lib.leaves(grads)
    flat_m = tree_lib.leaves(state["m"])
    flat_v = tree_lib.leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"params, grads and moments differ in leaves: {len(flat_p)}, "
                         f"{len(flat_g)}, {len(flat_m)}, {len(flat_v)}")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
