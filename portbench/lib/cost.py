"""Operations and bytes from a configuration's shapes, and the H100's peaks.

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

from portbench.lib.dims import Dims

PEAK_TF32 = 495e12
HBM_BW = 3.35e12
F32 = 4


def block_linear_params(dm: Dims) -> int:
    """Weights of one block's products: q, k, v, o and the SwiGLU's three."""
    d, qd, kvd = dm.d_model, dm.heads * dm.head_dim, dm.kv_heads * dm.head_dim
    return d * qd + 2 * d * kvd + qd * d + 3 * d * dm.d_ff


def linear_params(dm: Dims) -> int:
    """Weights of every block's products (not the embedding or the head)."""
    return dm.layers * block_linear_params(dm)


def causal_pairs(q_len: int, k_len: int) -> int:
    """(query, key) pairs a causal attention of ``q_len`` queries needs
    against ``k_len`` keys, the queries being the last ``q_len`` positions."""
    past = k_len - q_len
    return q_len * past + q_len * (q_len + 1) // 2


def attention_flops(dm: Dims, batch: int, q_len: int, k_len: int) -> float:
    """QK^T and PV of every layer: 2 products of 2 FLOPs per pair and dim."""
    return 4.0 * batch * dm.heads * dm.head_dim * causal_pairs(q_len, k_len) * dm.layers


def prefill_flops(dm: Dims, batch: int, length: int) -> float:
    """A prefill of ``batch`` prompts of ``length``: the blocks' products
    for every token, causal attention, the head at the last position."""
    tokens = batch * length
    return (2.0 * tokens * linear_params(dm) + attention_flops(dm, batch, length, length)
            + 2.0 * batch * dm.vocab * dm.d_model)


def decode_flops(dm: Dims, batch: int, position: int) -> float:
    """One decode step at ``position`` (0-based): one token a sequence
    against the ``position + 1`` keys then filled."""
    return (2.0 * batch * (linear_params(dm) + dm.vocab * dm.d_model)
            + attention_flops(dm, batch, 1, position + 1))


def train_flops(dm: Dims, batch: int, length: int) -> float:
    """Forward and backward of a training step (no recomputation): every
    product three times (forward, and the two gradients), attention's 2
    forward products and 4 backward ones, the head at every position."""
    tokens = batch * length
    return (6.0 * tokens * (linear_params(dm) + dm.vocab * dm.d_model)
            + 3.0 * attention_flops(dm, batch, length, length))


def decode_bytes(dm: Dims, batch: int, position: int) -> float:
    """Least bytes of one decode step: every weight read once (the
    embedding's rows of this step's tokens only), the k/v of the
    ``position + 1`` filled positions read once, this step's k/v written."""
    d = dm.d_model
    weights = (linear_params(dm) + dm.vocab * d + (2 * dm.layers + 1) * d) * F32
    kv_row = 2 * dm.kv_heads * dm.head_dim * F32 * dm.layers  # k and v of one position
    return weights + batch * d * F32 + batch * (position + 1) * kv_row + batch * kv_row


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


def roofline_s(flops: float, nbytes: float) -> float:
    """Least seconds on the card: the larger of operations over the TF32
    peak and bytes over HBM's rate."""
    return max(flops / PEAK_TF32, nbytes / HBM_BW)
