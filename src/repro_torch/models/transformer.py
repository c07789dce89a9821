"""Decoder: attention blocks with a dense MLP, stacked by
``ArchConfig.layer_pattern``.

The JAX package scans over stacked pattern repeats (``jax.lax.scan``); here
the blocks are a Python list, one dict per layer, applied in a loop.  Layer
``l`` has block type ``layer_pattern[l % len(layer_pattern)]``, the order
the scan visits them in.

This slice ports the ``attn`` block and the dense FFN.  The other block
types and MoE FFNs raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers

_PENDING = "ROADMAP.md queue 1, item 8 'mamba, MoE and xLSTM blocks'"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs orthogonal to the architecture (those that matter on
    one card)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    cache_dtype: torch.dtype = torch.float32
    q_block: int = 512
    kv_block: int = 512


# ---------------------------------------------------------------------------
# Per-block init
# ---------------------------------------------------------------------------


def _has_ffn(cfg: ArchConfig, pos: int) -> bool:
    b = cfg.layer_pattern[pos]
    if cfg.ffn_on == "none":
        return False
    if cfg.ffn_on == "attn" and b != "attn":
        return False
    return cfg.d_ff > 0 or cfg.moe is not None


def _is_moe(cfg: ArchConfig, pos: int) -> bool:
    if cfg.moe is None or not _has_ffn(cfg, pos):
        return False
    moe_set = set(cfg.moe_layer_indices)
    return (not moe_set) or (pos in moe_set)


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError if ``cfg`` needs a block this slice lacks."""
    for pos, btype in enumerate(cfg.layer_pattern):
        if btype != "attn":
            raise NotImplementedError(
                f"{cfg.name}: block type {btype!r} is not ported yet ({_PENDING})")
        if _is_moe(cfg, pos):
            raise NotImplementedError(
                f"{cfg.name}: MoE FFNs are not ported yet ({_PENDING})")


def _attn_init(gen, cfg: ArchConfig, kw) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": layers.dense_init(gen, (d, H, hd), **kw),
        "wk": layers.dense_init(gen, (d, KV, hd), **kw),
        "wv": layers.dense_init(gen, (d, KV, hd), **kw),
        "wo": layers.dense_init(gen, (H, hd, d), fan_in=H * hd, **kw),
    }


def _block_init(gen, cfg: ArchConfig, pos: int, kw) -> dict:
    p: dict = {"norm1": layers.rmsnorm_init(cfg.d_model, **kw),
               "attn": _attn_init(gen, cfg, kw)}
    if _has_ffn(cfg, pos):
        p["norm2"] = layers.rmsnorm_init(cfg.d_model, **kw)
        p["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                   gated=cfg.gated_mlp, **kw)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, rcfg: RunConfig, *,
                device="cpu") -> dict:
    """Random parameters from ``gen`` (which must live on ``device``), with
    the JAX package's distributions and layouts."""
    check_supported(cfg)
    kw = dict(dtype=rcfg.param_dtype, device=device)
    params: dict = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "final_norm": layers.rmsnorm_init(cfg.d_model, **kw),
        "lm_head": layers.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                     fan_in=cfg.d_model, **kw),
    }
    if cfg.frontend:
        params["frontend_proj"] = layers.dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), fan_in=cfg.frontend_dim, **kw)
    P = len(cfg.layer_pattern)
    params["blocks"] = [_block_init(gen, cfg, l % P, kw)
                        for l in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, rcfg: RunConfig, batch: int, max_seq: int, *,
               device="cpu") -> list:
    """One {"k", "v"} dict of (batch, max_seq, KV, hd) zeros per layer."""
    check_supported(cfg)
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=rcfg.cache_dtype, device=device),
             "v": torch.zeros(shape, dtype=rcfg.cache_dtype, device=device)}
            for _ in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _attn_apply(p, x, cfg: ArchConfig, rcfg: RunConfig, *, positions,
                cache=None, t=None, build_cache=False):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = attn_lib.apply_rope(q, positions, cfg.rope_theta)
    k = attn_lib.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None:
        o = attn_lib.flash_attention(q, k, v, causal=True, q_block=rcfg.q_block,
                                     kv_block=rcfg.kv_block)
        if build_cache:
            new_cache = {"k": k.to(rcfg.cache_dtype), "v": v.to(rcfg.cache_dtype)}
    else:
        if x.shape[1] != 1 or t is None:
            raise ValueError(f"decode takes one token per sequence at a position "
                             f"t; got {x.shape[1]} tokens, t={t}")
        kc, vc = cache["k"], cache["v"]
        o, kc, vc = attn_lib.decode_attention_local(
            q, k.to(kc.dtype), v.to(vc.dtype), kc, vc, t)
        new_cache = {"k": kc, "v": vc}
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    return out, new_cache


def _block_apply(p, x, cfg: ArchConfig, rcfg: RunConfig, pos: int, *,
                 positions, cache=None, t=None, build_cache=False):
    """Returns (x, new_cache)."""
    xn = layers.rmsnorm_apply(p["norm1"], x, eps=cfg.norm_eps)
    h, new_cache = _attn_apply(p["attn"], xn, cfg, rcfg, positions=positions,
                               cache=cache, t=t, build_cache=build_cache)
    x = x + h
    if _has_ffn(cfg, pos):
        xn2 = layers.rmsnorm_apply(p["norm2"], x, eps=cfg.norm_eps)
        x = x + layers.mlp_apply(p["ffn"], xn2)
    return x, new_cache


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch, cfg: ArchConfig, rcfg: RunConfig):
    x = layers.embedding_lookup(params["embed"], batch["tokens"])
    if cfg.frontend:
        fe = torch.einsum("bsf,fd->bsd", batch["embeds"].to(x.dtype),
                          params["frontend_proj"])
        x = x + fe
    return x.to(rcfg.compute_dtype)


def forward(params, batch, cfg: ArchConfig, rcfg: RunConfig, *,
            cache=None, t=None, build_cache=False, last_only=False):
    """Full forward.  ``cache`` None => prefill/train over (B, S); else a
    one-step decode at position ``t`` that updates ``cache`` in place.
    ``build_cache`` makes the full-sequence pass also return the populated
    per-layer k/v (serving prefill).  ``last_only`` applies the final norm
    and LM head to the last position only, which is all prefill needs.
    Returns (logits, aux_loss, new_cache); aux_loss is 0 (no MoE yet)."""
    check_supported(cfg)
    x = _embed_inputs(params, batch, cfg, rcfg)
    S = x.shape[1]
    if cache is None:
        positions = torch.arange(S, device=x.device)
    else:
        positions = t + torch.arange(1, device=x.device)

    P = len(cfg.layer_pattern)
    caches = [] if (cache is not None or build_cache) else None
    for l, bp in enumerate(params["blocks"]):
        c = cache[l] if cache is not None else None
        x, nc = _block_apply(bp, x, cfg, rcfg, l % P, positions=positions,
                             cache=c, t=t, build_cache=build_cache)
        if caches is not None:
            caches.append(nc)

    if last_only:
        x = x[:, -1:]
    x = layers.rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    logits = layers.lm_head_apply(params["lm_head"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, caches
