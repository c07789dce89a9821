"""Core layers: initialisers, RMSNorm, MLP, embedding, LM head and the
next-token loss.

Parameters are plain dicts of tensors in the JAX package's layouts, so
``repro_torch.weights`` converts a JAX parameter tree by copying.  Where
the JAX package wraps each parameter in a ``Leaf`` that carries its
logical axes, every initialiser here takes the axes beside the shape and
checks that they name every dim; given ``AXES`` as its generator it
returns the axes tuple instead of a tensor.  So the same init code builds
the parameter tree and its logical-axes tree
(``transformer.param_logical_axes``), and the two cannot drift apart.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Initializers (the JAX package's distributions; not its random bits)
# ---------------------------------------------------------------------------


class _AxesOnly:
    """The type of ``AXES``."""

    def __repr__(self) -> str:
        return "layers.AXES"


#: Pass as the generator of an initialiser (or of ``init_params``) to get
#: the logical axes (a tuple of names or None, one per dim) in place of a
#: tensor.
AXES = _AxesOnly()


def param(gen, shape, axes, make):
    """``make()``, the parameter of ``shape``, or its logical ``axes`` when
    ``gen`` is ``AXES``; raises if ``axes`` does not name every dim."""
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"logical axes {axes} do not match the shape {tuple(shape)}")
    return axes if gen is AXES else make()


def dense_init(gen: torch.Generator, shape, axes, *, fan_in=None, dtype=torch.float32,
               device="cpu"):
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan_in) (first axis by
    default)."""
    def make():
        fan = fan_in if fan_in is not None else shape[0]
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.mul_(1.0 / max(fan, 1) ** 0.5)
        return w.to(dtype)
    return param(gen, shape, axes, make)


def embed_init(gen: torch.Generator, shape, axes, *, dtype=torch.float32, device="cpu"):
    def make():
        w = torch.empty(shape, dtype=torch.float32, device=device)
        w.normal_(generator=gen)
        return w.to(dtype)
    return param(gen, shape, axes, make)


def zeros_init(gen, shape, axes, *, dtype=torch.float32, device="cpu"):
    """Zeros (``gen`` only selects ``AXES``)."""
    return param(gen, shape, axes,
                 lambda: torch.zeros(shape, dtype=dtype, device=device))


def ones_init(gen, shape, axes, *, dtype=torch.float32, device="cpu"):
    """Ones (``gen`` only selects ``AXES``)."""
    return param(gen, shape, axes,
                 lambda: torch.ones(shape, dtype=dtype, device=device))


def param_count(tree) -> int:
    """Number of parameters in a tree of dicts and lists of tensors."""
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_count(v) for v in tree)
    return tree.numel()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(gen, d: int, *, dtype=torch.float32, device="cpu") -> dict:
    return {"scale": ones_init(gen, (d,), ("embed",), dtype=dtype, device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Through the RMSNorm kernel on CUDA, its plain version on the CPU."""
    return ops.rmsnorm(x.contiguous(), params["scale"], eps=eps)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU or classic GELU)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *, gated: bool,
             dtype=torch.float32, device="cpu") -> dict:
    kw = dict(dtype=dtype, device=device)
    p = {"w_in": dense_init(gen, (d_model, d_ff), ("embed", "ff"), **kw),
         "w_out": dense_init(gen, (d_ff, d_model), ("ff", "embed"), **kw)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), ("embed", "ff"), **kw)
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
    return {"table": embed_init(gen, (vocab, d_model), ("vocab", "embed"), dtype=dtype,
                                device=device)}


def embedding_lookup(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def lm_head_apply(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Project hidden states to vocab logits (weights (vocab, d_model))."""
    return x @ table.T


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy: logits (B,S,V), upcast to fp32,
    labels (B,S); with ``mask`` (B,S), the mean over the masked-in
    positions (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
