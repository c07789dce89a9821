"""Int8 gradient compression with error feedback, for the data-parallel
reduce (the JAX package's ``optim/grad_compression.py``).

Each rank quantizes its local gradient to int8 against one scale that all
ranks agree on, sums the int8 payload as int32 over a ``torch.distributed``
group (4x less traffic than fp32), dequantizes, and keeps the quantization
residual as error feedback added to the next step's gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib


def quantize_int8(g: torch.Tensor):
    """(q int8, scale fp32) with g ~ q * scale and |q| <= 127; rounding
    half to even, as ``jnp.round``."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_tree(grads, error, *, group=None):
    """All-reduce ``grads`` over ``group`` (the default group when None)
    with int8 compression and error feedback.  Returns (reduced_grads,
    new_error): the mean over ranks of the dequantized gradients, and each
    rank's residual.  ``grads`` and ``error`` are this rank's trees."""
    n = dist.get_world_size(group)

    def one(g, e):
        g = g.to(torch.float32) + e
        # agree on ONE scale across ranks first (int8 payloads with
        # per-rank scales cannot be summed), then quantize and sum as int32
        scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        reduced = summed.to(torch.float32) * scale / n
        new_e = g - q.to(torch.float32) * scale
        return reduced, new_e

    pairs = tree_lib.map(one, grads, error)
    return (tree_lib.map(lambda _, pr: pr[0], grads, pairs),
            tree_lib.map(lambda _, pr: pr[1], grads, pairs))
