"""Flash attention on Hopper: the wrappers of ``csrc/flash_attention.cu``
and of its backward, ``csrc/flash_attention_bwd.cu``.

The forward replaces ``flash_attention_pallas`` of the JAX package's
``kernels/flash_attention.py``; the backward is its gradient, which the JAX
package leaves to XLA's autodiff of the jnp attention.  Both kernels are
CUDA C++ for ``sm_90a``, built by ``kernels._build`` at first use and
called through ctypes on PyTorch's current stream; see the sources' headers
for their design and bounds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F32, I64, INT, PTR, Entry, aligned

# Every head dim of a config the port serves: 16 (reduced configs), 32,
# 64 (musicgen-medium), 80 (stablelm-3b), 128 and 160 (pixtral-12b).
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FWD = Entry("flash_attention", "flash_attention_fwd",
             [PTR] * 5 + [INT] * 7 + [F32, INT, PTR])
_BWD = Entry("flash_attention_bwd", "flash_attention_bwd",
             [PTR] * 10 + [INT] * 7 + [F32, INT, PTR])
_BWD_SCRATCH = Entry("flash_attention_bwd", "flash_attention_bwd_scratch", [INT] * 6, I64)


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, return_lse: bool = False):
    """GQA attention (B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd) in q's dtype,
    by the hand-written kernel; with ``return_lse`` also each row's
    log-sum-exp of the scaled, masked scores, (B,H,Sq) in fp32, which the
    backward needs.  Raises on anything it cannot launch."""
    _check(q, k, v)
    q, k, v = aligned(q), aligned(k), aligned(v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _FWD.launch(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, hd, int(causal),
                1.0 / (hd ** 0.5), _DTYPE_CODE[q.dtype])
    return (o, lse) if return_lse else o


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True):
    """Gradients (dq, dk, dv) of :func:`flash_attention_cuda` at (q, k, v),
    given its output ``o`` and row log-sum-exp ``lse`` (B,H,Sq) fp32, for
    the output gradient ``do``; each in its input's dtype, by the
    hand-written backward kernels.  Raises on anything it cannot launch."""
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
    q, k, v, o, do = (aligned(t) for t in (q, k, v, o, do))
    dq = torch.empty_like(q)
    # dk and dv stay zero where no query row exists to write them
    dk = torch.empty_like(k) if Sq else torch.zeros_like(k)
    dv = torch.empty_like(v) if Sq else torch.zeros_like(v)
    # rowsum(dO*O), then the dK/dV kernel's partial sums where it splits rows
    D = torch.empty(_BWD_SCRATCH(B, Sq, Sk, H, KV, hd), dtype=torch.float32,
                    device=q.device)
    _BWD.launch(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                D.data_ptr(), B, Sq, Sk, H, KV, hd, int(causal), 1.0 / (hd ** 0.5),
                _DTYPE_CODE[q.dtype])
    return dq, dk, dv
