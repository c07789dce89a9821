"""The kernels' operations and bytes from their shapes, and the H100's peaks.
A whole step's operations and bytes depend on the model's form and are its
family's (``families/<family>.py``), counted by the same rules.

Peaks: one NVIDIA H100 SXM5 (80 GB HBM3) at its 700 W limit, NVIDIA's data
sheet, dense rates without sparsity (copied from the port's
``roofline/analysis.py`` and ``chip_smoke.bound``, so that a program change
cannot move the yardstick):

- ``PEAK_TF32`` 495 TFLOP/s, TF32 on the tensor cores.  Every ``mfu.*``
  and every kernel roofline of a compute-bound kernel divides by it: no
  fp32-accurate product (3xTF32, a bf16 split) runs faster than one TF32
  product, so no fp32 program can read above 100% of it.
- Beside it, for the record: 67 TFLOP/s fp32 on the CUDA cores, and 165
  TFLOP/s for 3xTF32 (three TF32 products per fp32 product).
- ``HBM_BW`` 3.35 TB/s.

Counts are of what the served output or the training step needs, not of
what a kernel executes: causal attention counts each (query, key) pair at
or below the diagonal once; a prefill's LM head counts the last position
only; no recomputation is counted.  Every tensor is fp32 (4 bytes).
"""
from __future__ import annotations

PEAK_TF32 = 495e12
HBM_BW = 3.35e12
F32 = 4


def causal_pairs(q_len: int, k_len: int) -> int:
    """(query, key) pairs a causal attention of ``q_len`` queries needs
    against ``k_len`` keys, the queries being the last ``q_len`` positions."""
    past = k_len - q_len
    return q_len * past + q_len * (q_len + 1) // 2


def flash_fwd(batch: int, q_len: int, k_len: int, heads: int, kv_heads: int,
              head_dim: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal flash-attention forward: 2 products on
    the needed pairs; q, k, v read and o written once."""
    flops = 4.0 * batch * heads * head_dim * causal_pairs(q_len, k_len)
    io = (2 * batch * q_len * heads + 2 * batch * k_len * kv_heads) * head_dim * F32
    return flops, float(io)


def flash_bwd(batch: int, q_len: int, k_len: int, heads: int, kv_heads: int,
              head_dim: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal flash-attention backward: the 5
    products it needs (S again, dP, dV, dQ, dK); q, o, dO, dq and k, v, dk,
    dv once each, and the row log-sum-exp read."""
    flops = 10.0 * batch * heads * head_dim * causal_pairs(q_len, k_len)
    io = ((4 * batch * q_len * heads + 4 * batch * k_len * kv_heads) * head_dim
          + batch * heads * q_len) * F32
    return flops, float(io)


def flash_decode(rows: int, position: int, heads: int, kv_heads: int,
                 head_dim: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one flash-decode call at ``position`` (0-based):
    one query a row against the ``position + 1`` keys then filled, 2
    products; the k/v of those positions read once, the new token's k/v
    written into the cache, q read and o written once."""
    flops = 4.0 * rows * heads * head_dim * (position + 1)
    kv_row = 2 * kv_heads * head_dim  # k and v of one position
    io = rows * ((position + 1) * kv_row + kv_row + 2 * heads * head_dim) * F32
    return flops, float(io)


def roofline_s(flops: float, nbytes: float) -> float:
    """Least seconds on the card: the larger of operations over the TF32
    peak and bytes over HBM's rate."""
    return max(flops / PEAK_TF32, nbytes / HBM_BW)
