"""Flash-decode on Hopper: the wrapper of ``csrc/decode_attention.cu``.

The kernel replaces no Pallas kernel: the JAX package's decode attention
(``models/attention.py``, ``decode_attention_local``) is plain jnp, and its
plain PyTorch version is ``kernels.ref.decode_attention_ref``.  It was added
because that plain version copies every layer's whole k/v caches each
decode step; the kernel reads only the filled positions, in place, and
writes the new token's k/v in the same launch.  CUDA C++ for ``sm_90a``,
built by ``kernels._build`` at first use and called through ctypes on
PyTorch's current stream; see the source's header for its design and bound.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, INT, PTR, Entry, aligned
from repro_torch.kernels.flash_attention import HEAD_DIMS

MAX_GROUP = 16   # query heads a k/v head
MIN_SPLIT = 32   # the shortest split: one tile of the kernel's positions

_FWD = Entry("decode_attention", "decode_attention_fwd", [PTR] * 7 + [INT] * 7 + [F32, PTR, PTR])


def plan_splits(t: int, batch: int, kv_heads: int, sms: int) -> int:
    """The number of splits of positions ``0..t``, one block each per (batch
    row, k/v head): as many as keep the grid of ``n_splits x kv_heads x
    batch`` blocks within one block an SM, and never a split shorter than
    ``MIN_SPLIT`` positions, so short caches take fewer.  A split more costs
    its partials, the merge launch and, on an H100, time: at 128 blocks
    (yi-9b.decode) 1 split ran 3-9% faster than 2, and at 16 blocks 8 splits
    ran as fast as or faster than 16.  Split ``s`` of ``n`` covers positions
    ``s * (t + 1) // n`` up to ``(s + 1) * (t + 1) // n``."""
    return max(1, min(sms // (batch * kv_heads), (t + 1) // MIN_SPLIT))


def splits(k_cache: torch.Tensor, t: int) -> int:
    """The split count of a launch at position ``t`` on ``k_cache``
    (B,S,KV,hd): :func:`plan_splits` at the SM count of the cache's device.
    The wrapper launches with it and a CUDA graph of the decode step keys
    on it (``models/decode_graph.py``), so a replay runs the split count
    that the eager step would."""
    B, _, KV, _ = k_cache.shape
    return plan_splits(t, B, KV, _build.sm_count(k_cache.device.index))


def _check(q, k_new, v_new, k_cache, v_cache, t: int) -> None:
    """Raise on anything the kernel does not take; the device last, so that
    every other refusal shows on CPU tensors too."""
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want caches (B,S,KV,hd) of one shape; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, S, KV, hd = k_cache.shape
    if (q.dim() != 4 or q.shape[0] != B or q.shape[1] != 1 or q.shape[3] != hd
            or KV < 1 or q.shape[2] % KV):
        raise ValueError(f"q {tuple(q.shape)} does not fit caches {tuple(k_cache.shape)}: "
                         f"want (B,1,H,hd) with H a multiple of KV")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if x.shape != (B, 1, KV, hd):
            raise ValueError(f"want {name} (B,1,KV,hd) = {(B, 1, KV, hd)}; got {tuple(x.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.shape[2] // KV > MAX_GROUP:
        raise ValueError(f"{q.shape[2] // KV} query heads a k/v head; at most {MAX_GROUP}")
    tensors = (q, k_new, v_new, k_cache, v_cache)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"want q, k_new, v_new and the caches all fp32; got "
                        f"{', '.join(str(x.dtype) for x in tensors)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("q, k_new, v_new and the caches must be contiguous")
    if not 0 <= t < S:
        raise ValueError(f"t={t} is outside the caches' {S} positions")
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"want every tensor on one CUDA device; got "
                         f"{', '.join(str(x.device) for x in tensors)}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must start on a 16-byte boundary")


def _check_t_device(t_device, q) -> None:
    if (type(t_device) is not torch.Tensor or t_device.dtype != torch.int64
            or t_device.shape != (1,) or t_device.device != q.device):
        raise ValueError(f"want t_device a one-element int64 tensor on {q.device}")


def decode_attention_cuda(q, k_new, v_new, k_cache, v_cache, t, *, t_device=None):
    """One decode step of q (B,1,H,hd) against fp32 caches (B,S,KV,hd) by the
    hand-written kernel: k_new/v_new (B,1,KV,hd) are written into the caches
    at position ``t`` in place, and each query head attends to positions
    ``<= t``.  Returns (out (B,1,H,hd), k_cache, v_cache).  Raises on
    anything it cannot launch.

    ``t_device``: None, or a one-element int64 tensor on q's device that
    holds ``t`` when the launch runs; the kernel then reads t there, so a
    launch captured in a CUDA graph serves every later step that writes its
    own t there first.  ``t`` itself is still range-checked and picks the
    split count, which such a graph keeps."""
    t = operator.index(t)
    if t_device is not None:
        _check_t_device(t_device, q)
    _check(q, k_new, v_new, k_cache, v_cache, t)
    q, k_new, v_new = aligned(q), aligned(k_new), aligned(v_new)
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    n_splits = splits(k_cache, t)
    o = torch.empty_like(q)
    # each split's (max, sum, weighted sum) of every (b, h) row
    part = (torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32, device=q.device)
            if n_splits > 1 else None)
    _FWD.launch(q.device.index, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
                None if part is None else part.data_ptr(), B, S, H, KV, hd, t, n_splits,
                1.0 / (hd ** 0.5), None if t_device is None else t_device.data_ptr())
    return o, k_cache, v_cache
