"""Public kernel entry points, with the signatures of the JAX package's
``kernels/ops.py``.

For a CUDA tensor each one launches its hand-written kernel or raises; for
a CPU tensor it computes the plain PyTorch version in ``kernels.ref``.
Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref


def _route(t: torch.Tensor, what: str) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{what}: no kernel for device {t.device}")


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
    if _route(q, "flash_attention") == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)


def rmsnorm(x, scale, *, eps: float = 1e-5, row_block: int = 256):
    """RMSNorm of x (..., d) with scale (d,).  ``row_block`` is the TPU
    kernel's row tile, kept for the same reason; the Hopper kernel normalises
    one row per thread block."""
    if row_block < 1:
        raise ValueError(f"row_block must be positive: {row_block}")
    if _route(x, "rmsnorm") == "cuda":
        return _rms.rmsnorm_cuda(x, scale, eps=eps)
    return rmsnorm_ref(x, scale, eps=eps)


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {"flash_attention": _fa.launches, "rmsnorm": _rms.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _rms.launches = 0
