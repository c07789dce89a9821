"""Fused RMSNorm on Hopper: the wrapper of ``csrc/rmsnorm.cu``.

Replaces ``rmsnorm_pallas`` of the JAX package's ``kernels/rmsnorm.py``.
The kernel is CUDA C++ for ``sm_90a``, built by ``kernels._build`` at first
use and called through ctypes on PyTorch's current stream; see the source's
header for its design and bound.  ``launches`` counts the kernel launches
this wrapper made.

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
_lib: ctypes.CDLL | None = None


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


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of x (..., d) with scale (d,), by the hand-written kernel.
    Raises on anything it cannot launch."""
    global launches
    shape = x.shape
    d = shape[-1] if shape else 0
    if scale.shape != (d,) or not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"want x (..., d) with 1 <= d <= {MAX_WIDTH} and "
                         f"scale (d,); got {tuple(shape)}, {tuple(scale.shape)}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"want x fp32 or bf16; got {x.dtype}")
    device = x.device
    if device.type != "cuda" or scale.device != device:
        raise ValueError(f"want x and scale on one CUDA device; got "
                         f"{device}, {scale.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
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
