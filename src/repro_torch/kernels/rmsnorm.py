"""Fused RMSNorm on Hopper: the wrappers of ``csrc/rmsnorm.cu`` and of its
backward, ``csrc/rmsnorm_bwd.cu``.

The forward replaces ``rmsnorm_pallas`` of the JAX package's
``kernels/rmsnorm.py``; the backward is its gradient, which the JAX package
leaves to XLA's autodiff of the jnp RMSNorm.  Both kernels are CUDA C++ for
``sm_90a``, built by ``kernels._build`` at first use and called through
ctypes on PyTorch's current stream; see the sources' headers for their
design and bounds.  ``launches`` and ``bwd_launches`` count the calls of
each wrapper that launched its kernel.

The wrapper is on the decode path 97 times per step at 4 rows, where its
host time is most of the cost, so it does as little per call as keeps every
check: the ctypes function is resolved once, the stream handle is read raw,
and ``scale`` is converted only when it is not fp32 and contiguous already.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 8192  # the widest row the kernel keeps in registers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None
_SMS: dict[int, int] = {}  # streaming multiprocessors of each device


def _load() -> ctypes.CDLL:
    global _lib
    lib = _build.load("rmsnorm")
    lib.rmsnorm_fwd.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_fwd.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _load_bwd() -> ctypes.CDLL:
    global _bwd_lib
    lib = _build.load("rmsnorm_bwd")
    lib.rmsnorm_bwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_bwd.restype = ctypes.c_int
    lib.rmsnorm_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_bwd_error_string.restype = ctypes.c_char_p
    _bwd_lib = lib
    return lib


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
    global launches
    code = _check(x, scale)
    device, d = x.device, x.shape[-1]
    # The kernel reads the scale in fp32, as the reference upcasts it.
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    lib = _lib or _load()
    err = _build.call_on_stream(
        device.index, lib.rmsnorm_fwd, x.data_ptr(), scale.data_ptr(),
        out.data_ptr(), x.numel() // d, d, eps, code,
        0)  # threads per row: the kernel's own choice
    if err:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: {msg} ({err})")
    launches += 1
    return out


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                     eps: float = 1e-5):
    """Gradients (dx, dscale) of :func:`rmsnorm_cuda` at (x, scale) for the
    output gradient ``dy``, by the hand-written backward kernels: dx in x's
    dtype, dscale in scale's (the forward reads scale upcast to fp32).
    Raises on anything it cannot launch."""
    global bwd_launches
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
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    # two blocks per SM, each over a contiguous run of rows, each writing one
    # row of partial dscale sums
    n_parts = min(rows, 2 * sms)
    partial = torch.empty((n_parts, d), dtype=torch.float32, device=device)
    lib = _bwd_lib or _load_bwd()
    err = _build.call_on_stream(
        device.index, lib.rmsnorm_bwd, x.data_ptr(), scale32.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(), n_parts, rows, d, eps,
        code, _DTYPE_CODE[out_dtype])
    if err:
        msg = lib.rmsnorm_bwd_error_string(err).decode()
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: {msg} ({err})")
    bwd_launches += 1
    return dx, dscale if out_dtype == scale.dtype else dscale.to(scale.dtype)
