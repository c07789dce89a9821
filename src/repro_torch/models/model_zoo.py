"""Model facade: arch name -> params / prefill / decode on one device.

``Model`` wraps the decoder (``repro_torch.models.transformer``) behind the
serving entry points of the JAX package's ``Model``:
    forward_logits(params, batch)        -- full forward
    prefill(params, batch)               -- last-token logits + k/v cache
    decode_step(params, batch, cache, t) -- one token against the cache
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.models import transformer
from repro_torch.models.transformer import RunConfig


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raise if it asks for CUDA on a machine
    without it, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch versions")
    return dev


class Model:
    def __init__(self, cfg: ArchConfig, rcfg: Optional[RunConfig] = None, *,
                 device="cuda"):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.rcfg = rcfg or RunConfig()
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen``, a generator on this model's device."""
        return transformer.init_params(gen, self.cfg, self.rcfg, device=self.device)

    def forward_logits(self, params, batch):
        logits, _, _ = transformer.forward(params, batch, self.cfg, self.rcfg)
        return logits

    def prefill(self, params, batch):
        """Returns (last-token logits, populated per-layer k/v cache)."""
        logits, _, cache = transformer.forward(
            params, batch, self.cfg, self.rcfg, build_cache=True, last_only=True)
        return logits[:, -1], cache

    def init_cache(self, batch_size: int, max_seq: int):
        return transformer.init_cache(self.cfg, self.rcfg, batch_size, max_seq,
                                      device=self.device)

    def decode_step(self, params, batch, cache, t: int):
        """One serving step: the token at position ``t``; ``cache`` is
        updated in place and returned."""
        logits, _, new_cache = transformer.forward(
            params, batch, self.cfg, self.rcfg, cache=cache, t=t)
        return logits[:, 0], new_cache


def build_model(arch: str, rcfg: Optional[RunConfig] = None, *,
                reduced: bool = False, device="cuda") -> Model:
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    return Model(cfg, rcfg, device=device)
