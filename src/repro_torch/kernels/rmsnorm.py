"""Fused RMSNorm on Hopper: the wrapper of ``csrc/rmsnorm.cu``.

Replaces ``rmsnorm_pallas`` of the JAX package's ``kernels/rmsnorm.py``.
The kernel is CUDA C++ for ``sm_90a``, built by ``kernels._build`` at first
use and called through ctypes on PyTorch's current stream; see the source's
header for its design and bound.  ``launches`` counts the kernel launches
this wrapper made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 256 * 32  # the widest row the kernel keeps in registers
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                 eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm of x (..., d) with scale (d,), by the hand-written kernel.
    Raises on anything it cannot launch."""
    global launches
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or scale.shape != (d,) or not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"want x (..., d) with 1 <= d <= {MAX_WIDTH} and "
                         f"scale (d,); got {tuple(x.shape)}, {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"want x fp32 or bf16; got {x.dtype}")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"want x and scale on one CUDA device; got "
                         f"{x.device}, {scale.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    # The kernel reads the scale in fp32, as the reference upcasts it.
    scale32 = scale.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_fwd(x.data_ptr(), scale32.data_ptr(), out.data_ptr(),
                              x.numel() // d, d, eps, _DTYPE_CODE[x.dtype],
                              stream)
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: {msg} ({err})")
    launches += 1
    return out
