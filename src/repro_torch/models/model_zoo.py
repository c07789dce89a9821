"""Model facade: arch name -> params / prefill / decode on one device.

``Model`` wraps the decoder (``repro_torch.models.transformer``) behind the
serving entry points of the JAX package's ``Model``:
    loss(params, batch)                  -- next-token loss + MoE aux
    forward_logits(params, batch)        -- full forward
    prefill(params, batch)               -- last-token logits + filled states
    decode_cache(filled, max_seq)        -- the decode cache they start
    decode_step(params, batch, cache, t) -- one token against the cache
and, for sharding, the shapes and logical axes of the parameters, the
cache and the inputs of a cell (``abstract_params``, ``cache_axes``,
``input_specs``), as ``meta`` tensors: they allocate nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import RunConfig


class Model:
    def __init__(self, cfg: ArchConfig, rcfg: Optional[RunConfig] = None, *,
                 device="cuda"):
        self.cfg = cfg
        self.rcfg = rcfg or RunConfig()
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters from ``gen``, a generator on this model's device."""
        return transformer.init_params(gen, self.cfg, self.rcfg, device=self.device)

    def abstract_params(self):
        """(params, axes): ``init_params``' tree as ``meta`` tensors (shapes
        and dtypes, no allocation), and its logical axes."""
        shapes = transformer.init_params(None, self.cfg, self.rcfg, device="meta")
        return shapes, transformer.param_logical_axes(self.cfg, self.rcfg)

    def loss(self, params, batch):
        """Returns (loss, {"ce", "moe_aux"}) for ``batch["labels"]``."""
        return transformer.loss_fn(params, batch, self.cfg, self.rcfg)

    def forward_logits(self, params, batch):
        logits, _, _ = transformer.forward(params, batch, self.cfg, self.rcfg)
        return logits

    def prefill(self, params, batch):
        """Returns (last-token logits, per-layer decode state: k/v over the
        prompt, or the recurrent state after it)."""
        logits, _, cache = transformer.forward(
            params, batch, self.cfg, self.rcfg, build_cache=True, last_only=True)
        return logits[:, -1], cache

    def init_cache(self, batch_size: int, max_seq: int):
        return transformer.init_cache(self.cfg, self.rcfg, batch_size, max_seq,
                                      device=self.device)

    def cache_axes(self) -> list:
        return transformer.cache_logical_axes(self.cfg)

    def decode_cache(self, filled: list, max_seq: int) -> list:
        """The decode cache after a prefill: each attention layer's k/v
        copied into a cache of ``max_seq`` positions, each recurrent layer's
        state taken whole (the JAX ``serve``'s ``grow``)."""
        first = next(iter(filled[0].values()))
        cache = self.init_cache(first.shape[0], max_seq)
        for l, layer_filled in enumerate(filled):
            if "k" in layer_filled:
                for kv in ("k", "v"):
                    cache[l][kv][:, :layer_filled[kv].shape[1]] = layer_filled[kv]
            else:
                cache[l] = layer_filled
        return cache

    def decode_step(self, params, batch, cache, t: int):
        """One serving step: the token at position ``t``.  Returns the
        logits and the cache: attention k/v updated in place, recurrent
        states replaced."""
        logits, _, new_cache = transformer.forward(
            params, batch, self.cfg, self.rcfg, cache=cache, t=t)
        return logits[:, 0], new_cache

    def input_specs(self, shape: InputShape, *, dtype=torch.int32) -> dict:
        """``meta`` stand-ins for every model input of a cell."""
        B, S = shape.global_batch, shape.seq_len
        f32 = torch.bfloat16 if self.rcfg.compute_dtype == torch.bfloat16 else torch.float32
        spec = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": spec((B, S), dtype)}
            if self.cfg.frontend:
                specs["embeds"] = spec((B, S, self.cfg.frontend_dim), f32)
            if shape.kind == "train":
                specs["labels"] = spec((B, S), dtype)
            return specs
        # decode: one new token; the KV/state cache covers seq_len positions.
        specs = {"tokens": spec((B, 1), dtype)}
        if self.cfg.frontend:
            specs["embeds"] = spec((B, 1, self.cfg.frontend_dim), f32)
        return specs


def build_model(arch: str, rcfg: Optional[RunConfig] = None, *,
                reduced: bool = False, device="cuda") -> Model:
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    return Model(cfg, rcfg, device=device)
