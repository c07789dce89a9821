"""Public kernel entry points, with the signatures of the JAX package's
``kernels/ops.py``.

For a CUDA tensor each one launches its hand-written kernel or raises; for
a CPU tensor it computes the plain PyTorch version in ``kernels.ref``.
Nothing falls back from one to the other.

Where autograd needs a gradient (grad mode on and an input that requires
one), the call goes through a ``torch.autograd.Function`` whose forward
launches the forward kernel (for attention with its row log-sum-exp) and
whose backward launches the hand-written backward kernel; on the CPU the
same Function runs the plain forward and the plain backward.  Otherwise
(serving, ``torch.no_grad``) the forward is called directly, as before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                                     flash_attention_ref, rmsnorm_bwd_ref, rmsnorm_ref)


def _route(t: torch.Tensor, what: str) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{what}: no kernel for device {t.device}")


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cuda":
            # the tensors the kernel read, so the backward reads the same
            q, k, v = _fa._aligned(q), _fa._aligned(k), _fa._aligned(v)
            o, lse = _fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        else:
            o = flash_attention_ref(q, k, v, causal=causal)
            lse = flash_attention_lse_ref(q, k, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()  # e.g. from the einsum of the output projection
        if q.device.type == "cuda":
            dq, dk, dv = _fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      causal=ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        if x.device.type == "cuda":
            y = _rms.rmsnorm_cuda(x, scale, eps=eps)
        else:
            y = rmsnorm_ref(x, scale, eps=eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cuda":
            dx, dscale = _rms.rmsnorm_bwd_cuda(x, scale, dy, eps=ctx.eps)
        else:
            dx, dscale = rmsnorm_bwd_ref(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 128,
                    kv_block: int = 128):
    """GQA attention (B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd).

    ``q_block`` and ``kv_block`` are the TPU kernel's tile sizes, kept so
    callers are interchangeable.  The Hopper kernel tiles by its own design
    (16 folded query rows per warp, 32-key tiles) and takes any Sq and Sk,
    and the result does not depend on the block sizes beyond rounding.
    """
    if q_block < 1 or kv_block < 1:
        raise ValueError(f"block sizes must be positive: {q_block}, {kv_block}")
    route = _route(q, "flash_attention")
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    if route == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)


def rmsnorm(x, scale, *, eps: float = 1e-5, row_block: int = 256):
    """RMSNorm of x (..., d) with scale (d,).  ``row_block`` is the TPU
    kernel's row tile, kept for the same reason; the Hopper kernel normalises
    one row per thread block."""
    if row_block < 1:
        raise ValueError(f"row_block must be positive: {row_block}")
    route = _route(x, "rmsnorm")
    if _wants_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    if route == "cuda":
        return _rms.rmsnorm_cuda(x, scale, eps=eps)
    return rmsnorm_ref(x, scale, eps=eps)


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {"flash_attention": _fa.launches, "flash_attention_bwd": _fa.bwd_launches,
            "rmsnorm": _rms.launches, "rmsnorm_bwd": _rms.bwd_launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _fa.bwd_launches = 0
    _rms.launches = 0
    _rms.bwd_launches = 0
