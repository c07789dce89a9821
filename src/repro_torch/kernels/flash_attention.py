"""Flash attention on Hopper: the wrappers of ``csrc/flash_attention.cu``
and of its backward, ``csrc/flash_attention_bwd.cu``.

The forward replaces ``flash_attention_pallas`` of the JAX package's
``kernels/flash_attention.py``; the backward is its gradient, which the JAX
package leaves to XLA's autodiff of the jnp attention.  Both kernels are
CUDA C++ for ``sm_90a``, built by ``kernels._build`` at first use and
called through ctypes on PyTorch's current stream; see the sources' headers
for their design and bounds.  ``launches`` and ``bwd_launches`` count the
calls of each wrapper that launched its kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Every head dim of a config the port serves: 16 (reduced configs), 32,
# 64 (musicgen-medium), 80 (stablelm-3b), 128 and 160 (pixtral-12b).
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _load_bwd() -> ctypes.CDLL:
    global _bwd_lib
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch.argtypes = [ctypes.c_int] * 6
    lib.flash_attention_bwd_scratch.restype = ctypes.c_longlong
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    _bwd_lib = lib
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Sq,H,hd), k and v (B,Sk,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want q, k, v all fp32 or all bf16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"want q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy where a view starts off the 16-byte grid
    that the kernel's 16-byte copies need (a fresh allocation is on it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, return_lse: bool = False):
    """GQA attention (B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype,
    by the hand-written kernel; with ``return_lse`` also each row's
    log-sum-exp of the scaled, masked scores, (B,H,Sq) in fp32, which the
    backward needs.  Raises on anything it cannot launch."""
    global launches
    _check(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _lib or _load()
    err = _build.call_on_stream(
        q.device.index, lib.flash_attention_fwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), 1.0 / (hd ** 0.5),
        _DTYPE_CODE[q.dtype])
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True):
    """Gradients (dq, dk, dv) of :func:`flash_attention_cuda` at (q, k, v),
    given its output ``o`` and row log-sum-exp ``lse`` (B,H,Sq) fp32, for
    the output gradient ``do``; each in its input's dtype, by the
    hand-written backward kernels.  Raises on anything it cannot launch."""
    global bwd_launches
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"want {name} like q {tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"want lse (B,H,Sq) = {(B, H, Sq)} fp32 contiguous on "
                         f"{q.device}; got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    dq = torch.empty_like(q)
    # dk and dv stay zero where no query row exists to write them
    dk = torch.empty_like(k) if Sq else torch.zeros_like(k)
    dv = torch.empty_like(v) if Sq else torch.zeros_like(v)
    lib = _bwd_lib or _load_bwd()
    # rowsum(dO*O), then the dK/dV kernel's partial sums where it splits rows
    D = torch.empty(lib.flash_attention_bwd_scratch(B, Sq, Sk, H, KV, hd),
                    dtype=torch.float32, device=q.device)
    err = _build.call_on_stream(
        q.device.index, lib.flash_attention_bwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), D.data_ptr(),
        B, Sq, Sk, H, KV, hd, int(causal), 1.0 / (hd ** 0.5), _DTYPE_CODE[q.dtype])
    if err:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: {msg} ({err})")
    bwd_launches += 1
    return dq, dk, dv
