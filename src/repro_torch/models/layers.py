"""Core layers: initialisers, RMSNorm, MLP, embedding and LM head.

Parameters are plain dicts of tensors in the JAX package's layouts, so
``repro_torch.weights`` converts a JAX parameter tree by copying.  The
logical-axes machinery of the JAX ``Leaf`` only serves sharding and is not
carried over.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Initializers (the JAX package's distributions; not its random bits)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, *, fan_in=None, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan_in) (first axis by
    default)."""
    fan = fan_in if fan_in is not None else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.mul_(1.0 / max(fan, 1) ** 0.5)
    return w.to(dtype)


def embed_init(gen: torch.Generator, shape, *, dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(generator=gen)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, *, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Through the RMSNorm kernel on CUDA, its plain version on the CPU."""
    return ops.rmsnorm(x.contiguous(), params["scale"], eps=eps)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU or classic GELU)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *, gated: bool,
             dtype=torch.float32, device="cpu") -> dict:
    kw = dict(dtype=dtype, device=device)
    p = {"w_in": dense_init(gen, (d_model, d_ff), **kw),
         "w_out": dense_init(gen, (d_ff, d_model), **kw)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), **kw)
    return p


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, vocab: int, d_model: int, *,
                   dtype=torch.float32, device="cpu") -> dict:
    return {"table": embed_init(gen, (vocab, d_model), dtype=dtype, device=device)}


def embedding_lookup(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def lm_head_apply(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to vocab logits (weights (vocab, d_model))."""
    return x @ table.T
