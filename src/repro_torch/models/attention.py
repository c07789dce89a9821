"""Attention: RoPE, causal GQA attention through the flash kernel, the
naive oracle, single-device decode attention over a preallocated KV cache,
and distributed flash-decode over a cache sharded along the sequence.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd), GQA without expanding K/V
    (the kernel groups the query heads of each KV head itself).

    Goes through ``kernels.ops.flash_attention``: the hand-written kernel on
    CUDA, the plain version on the CPU."""
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, q_block=q_block, kv_block=kv_block)


def expand_kv(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,heads,hd), each KV head repeated for its group
    of query heads (``jnp.repeat`` on the head axis): the JAX package's
    ``gqa_grouped=False``."""
    B, S, KV, hd = t.shape
    if KV == heads:
        return t
    return t[:, :, :, None, :].expand(B, S, KV, heads // KV, hd).reshape(B, S, heads, hd)


# The naive O(S^2)-memory oracle for tests: one implementation, shared with
# the kernel checks.
reference_attention = flash_attention_ref


# ---------------------------------------------------------------------------
# Single-device decode attention
# ---------------------------------------------------------------------------


def decode_attention_local(q, k_new, v_new, k_cache, v_cache, t: int, *, t_device=None):
    """One decode step of q (B,1,H,hd) against a (B,S,KV,hd) cache.

    Writes k_new/v_new (B,1,KV,hd) into the caches IN PLACE at position
    ``t``: the JAX version returns updated copies, which here would cost a
    copy of the whole cache per layer per step.  Attends to positions
    ``<= t``.  Returns (out (B,1,H,hd), k_cache, v_cache).

    Goes through ``kernels.ops.decode_attention``: the hand-written
    flash-decode kernel on CUDA, the plain version on the CPU.  The kernel
    reads t from ``t_device`` where one is given (a one-element int64
    tensor holding ``t``: a CUDA graph's replays)."""
    return ops.decode_attention(q.contiguous(), k_new.contiguous(), v_new.contiguous(),
                                k_cache, v_cache, t, t_device=t_device)


# ---------------------------------------------------------------------------
# Distributed flash-decode over a sequence-sharded KV cache
# ---------------------------------------------------------------------------
#
# The KV cache (B, S, KV, hd) is sharded S over the mesh's 'model' dim
# (a few KV heads cannot shard a 16-way dim, long sequences can).  Each
# model rank holds a contiguous S / n slab; a decode step
#   1. writes the new k/v into whichever slab owns position t,
#   2. computes partial attention (per-slab max, exp-sum, weighted V),
#   3. combines the partials with all-reduces over 'model': flash-decode.


def _local_decode_attn(q, k_loc, v_loc, t: int, shard_base: int, scale: float):
    """Partial attention of q (B,1,H,hd) against a local slab
    (B,s_loc,KV,hd) holding positions shard_base...: (m, l, o) in fp32,
    the row max (B,KV,G), the exp-sum and the weighted sum of V."""
    B, s_loc, KV, hd = k_loc.shape
    H = q.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_loc.float()) * scale
    mask = shard_base + torch.arange(s_loc, device=q.device) <= t
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_loc.float())
    return m, l, o


def decode_attention_sharded(q, k_new, v_new, k_cache, v_cache, t: int, *, mesh,
                             dp_axes: tuple, logit_scale=None):
    """One decode step against a KV cache sharded along the sequence over
    ``mesh``'s ``model`` dim: the distributed flash-decode.

    Every tensor is this rank's local part, as ``DTensor.to_local()`` gives
    it for a cache laid out by ``transformer.cache_logical_axes`` under
    ``AxisRules.pod()``: q (b,1,H,hd), k_new/v_new (b,1,KV,hd) and the
    caches (b, S/n, KV, hd) are this rank's batch rows (the batch split
    over ``dp_axes``) and, for the caches, its slab of positions
    [r*S/n, (r+1)*S/n) for model rank r of n.  The owner slab takes the new
    k/v IN PLACE (the write position clamped into the slab, as the JAX
    package clamps it).  The partials combine with a MAX all-reduce of the
    row max and one SUM all-reduce of the rescaled exp-sums and weighted V
    over ``mesh.get_group("model")``, on the device.  Returns
    (out (b,1,H,hd), k_cache, v_cache)."""
    for a in dp_axes:
        if a not in mesh.mesh_dim_names:
            raise ValueError(f"dp axis {a!r} is not a dim of the mesh {mesh.mesh_dim_names}")
    if type(q) is not torch.Tensor:
        from torch.distributed.tensor import DTensor

        if isinstance(q, DTensor):
            return _decode_sharded_dtensor(q, k_new, v_new, k_cache, v_cache, t, mesh=mesh,
                                           dp_axes=dp_axes, logit_scale=logit_scale)
    B, _, H, hd = q.shape
    scale = logit_scale if logit_scale is not None else 1.0 / (hd ** 0.5)
    s_loc = k_cache.shape[1]
    base = mesh.get_local_rank("model") * s_loc
    # 1. masked cache write: only the owner slab takes the update.
    lp = min(max(t - base, 0), s_loc - 1)
    if base <= t < base + s_loc:
        k_cache[:, lp] = k_new[:, 0]
        v_cache[:, lp] = v_new[:, 0]
    # 2. partial flash-decode on the local slab.
    m, l, o = _local_decode_attn(q, k_cache, v_cache, t, base, scale)
    # 3. combine the partials across 'model'.
    group = mesh.get_group("model")
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    lo = torch.cat([(l * corr)[..., None], o * corr[..., None]], dim=-1)
    dist.all_reduce(lo, op=dist.ReduceOp.SUM, group=group)
    l_g, o_g = lo[..., 0], lo[..., 1:]
    out = (o_g / l_g.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, 1, H, hd), k_cache, v_cache


def _decode_sharded_dtensor(q, k_new, v_new, k_cache, v_cache, t: int, *, mesh, dp_axes,
                            logit_scale):
    """``decode_attention_sharded`` on DTensors (a model with DTensor
    parameters and caches): q and the new k/v go to this rank's batch rows
    with every head, the step runs on the local parts (the caches are laid
    out by ``cache_logical_axes``: batch rows over ``dp_axes``, the
    sequence over ``model``), and the output comes back a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dm = q.device_mesh
    rows = [Shard(0) if n in dp_axes else Replicate() for n in dm.mesh_dim_names]
    q, k_new, v_new = (a.redistribute(dm, rows) for a in (q, k_new, v_new))
    o, _, _ = decode_attention_sharded(q.to_local(), k_new.to_local(), v_new.to_local(),
                                       k_cache.to_local(), v_cache.to_local(), t, mesh=mesh,
                                       dp_axes=dp_axes, logit_scale=logit_scale)
    out = DTensor.from_local(o, dm, rows, run_check=False, shape=q.shape, stride=q.stride())
    return out, k_cache, v_cache
