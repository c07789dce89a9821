"""The work of the port's weight-streaming product (``kernels/csrc/decode_proj.cu``)
in a step, from a family's sizes, counted by ``lib/cost.py``'s rules.

The port's decode step hands the kernel every dense product at a decode
batch: each attention layer's q/k/v (one launch, three weights) and its
output projection, each dense SwiGLU MLP's first two (one launch that
applies the gate) and its last, and the head.  The MoE's batched expert
products and the Mamba mixers' products keep their own (a family's
``moe_layers`` are not dense MLPs; the Llama form has none).  A prefill
hands it the head at the last position alone.  Both families' ``Dims`` give
the sizes read here.
"""
from __future__ import annotations

from portbench.lib import cost


def cost_of(dm, rows: int, *, prefill: bool = False) -> tuple[float, float]:
    """(FLOPs, least bytes) of the kernel's products in one decode step (or
    prefill) at ``rows`` rows: each weight read once, each launch's rows
    read and its outputs written."""
    d, qd, kvd, F, V = (dm.d_model, dm.heads * dm.head_dim, dm.kv_heads * dm.head_dim,
                        dm.d_ff, dm.vocab)
    weights, io = V * d, rows * (d + V)
    if not prefill:
        attn, dense = dm.attn_layers, dm.layers - getattr(dm, "moe_layers", 0)
        weights += attn * (d * qd + 2 * d * kvd + qd * d) + dense * 3 * d * F
        io += rows * (attn * ((d + qd + 2 * kvd) + (qd + d)) + dense * ((d + F) + (F + d)))
    return 2.0 * rows * weights, float((weights + io) * cost.F32)
