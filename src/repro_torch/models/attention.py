"""Attention: RoPE, causal GQA attention through the flash kernel, the
naive oracle, and single-device decode attention over a preallocated KV
cache.

Distributed flash-decode over a sequence-sharded cache
(``decode_attention_sharded`` in the JAX package) comes with the sharding
slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, *, device="cpu") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, nheads, head_dim); positions: (S,) or (B, S).

    Split-half rotation in fp32: the first and second halves of head_dim
    are the two coordinates of each pair (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    angles = angles[..., :, None, :]                          # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Causal GQA attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd), GQA without expanding K/V.

    Goes through ``kernels.ops.flash_attention``: the hand-written kernel on
    CUDA, the plain version on the CPU."""
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, q_block=q_block, kv_block=kv_block)


# The naive O(S^2)-memory oracle for tests: one implementation, shared with
# the kernel checks.
reference_attention = flash_attention_ref


# ---------------------------------------------------------------------------
# Single-device decode attention
# ---------------------------------------------------------------------------


def decode_attention_local(q, k_new, v_new, k_cache, v_cache, t: int):
    """One decode step of q (B,1,H,hd) against a (B,S,KV,hd) cache.

    Writes k_new/v_new (B,1,KV,hd) into the caches IN PLACE at position
    ``t``: the JAX version returns updated copies, which here would cost a
    copy of the whole cache per layer per step.  Attends to positions
    ``<= t``.  Returns (out (B,1,H,hd), k_cache, v_cache)."""
    k_cache[:, t] = k_new[:, 0]
    v_cache[:, t] = v_new[:, 0]
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * scale
    mask = torch.arange(S, device=q.device) <= t
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    out = (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, 1, H, hd), k_cache, v_cache
