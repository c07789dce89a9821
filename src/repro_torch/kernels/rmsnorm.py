"""Fused RMSNorm on Hopper: the wrappers of ``csrc/rmsnorm.cu`` and of its
backward, ``csrc/rmsnorm_bwd.cu``.

The forward replaces ``rmsnorm_pallas`` of the JAX package's
``kernels/rmsnorm.py``; the backward is its gradient, which the JAX package
leaves to XLA's autodiff of the jnp RMSNorm.  Both kernels are CUDA C++ for
``sm_90a``, built by ``kernels._build`` at first use and called through
ctypes on PyTorch's current stream; see the sources' headers for their
design and bounds.

In the eager steps (hybrid and MoE decode, a cache's first dense decode
step and its capture, prefill, training) a decode row's host time is most
of its cost, so the wrapper does only its checks: the entry resolves once,
and ``scale`` is converted only when it is not fp32 and contiguous already.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F32, I64, INT, PTR, Entry

MAX_WIDTH = 8192  # the widest row the kernel keeps in registers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FWD = Entry("rmsnorm", "rmsnorm_fwd", [PTR] * 3 + [I64, INT, F32, INT, PTR])
_BWD = Entry("rmsnorm_bwd", "rmsnorm_bwd", [PTR] * 6 + [INT, I64, INT, F32, INT, INT, PTR])


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    """Raise on what the kernels cannot take; returns the dtype code."""
    shape = x.shape
    d = shape[-1] if shape else 0
    if scale.shape != (d,) or not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"want x (..., d) with 1 <= d <= {MAX_WIDTH} and "
                         f"scale (d,); got {tuple(shape)}, {tuple(scale.shape)}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"want x fp32 or bf16; got {x.dtype}")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"want x and scale on one CUDA device; got "
                         f"{x.device}, {scale.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return code


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of x (..., d) with scale (d,), by the hand-written kernel.
    Raises on anything it cannot launch."""
    code = _check(x, scale)
    device, d = x.device, x.shape[-1]
    # The kernel reads the scale in fp32, as the reference upcasts it.
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    _FWD.launch(device.index, x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                x.numel() // d, d, eps, code)
    return out


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                     eps: float = 1e-5):
    """Gradients (dx, dscale) of :func:`rmsnorm_cuda` at (x, scale) for the
    output gradient ``dy``, by the hand-written backward kernels: dx in x's
    dtype, dscale in scale's (the forward reads scale upcast to fp32).
    Raises on anything it cannot launch."""
    code = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"want dy like x {tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")
    device, d = x.device, x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    # dscale is written as fp32 or bf16; any other parameter dtype gets the
    # fp32 sums cast.  As in the forward, scale is converted only when it is
    # not fp32 and contiguous already.
    out_dtype = scale.dtype if scale.dtype in _DTYPE_CODE else torch.float32
    dscale = torch.empty(d, dtype=out_dtype, device=device)
    scale32 = scale
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale32 = scale.to(torch.float32).contiguous()
    sms = _build.sm_count(device.index)
    # two blocks per SM, each over a contiguous run of rows, each writing one
    # row of partial dscale sums
    n_parts = min(rows, 2 * sms)
    partial = torch.empty((n_parts, d), dtype=torch.float32, device=device)
    _BWD.launch(device.index, x.data_ptr(), scale32.data_ptr(), dy.data_ptr(),
                dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(), n_parts, rows, d, eps,
                code, _DTYPE_CODE[out_dtype])
    return dx, dscale if out_dtype == scale.dtype else dscale.to(scale.dtype)
