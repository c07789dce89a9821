"""A decoder in the Llama form, as Yi-9B publishes it and as the port runs
StableLM-3B-4E1T (see each configuration's ``departures``):

    h = x + Wo attn(rope(Wq n1(x)), rope(Wk n1(x)), Wv n1(x))
    y = h + Wdown (silu(Wgate n2(h)) * Wup n2(h))

with RMSNorm ``x * rsqrt(mean(x^2) + eps) * w``, rotary embedding on
split halves of each head (Hugging Face's ``rotate_half``), causal
grouped-query attention (query head ``i`` reads k/v head ``i // group``),
a final RMSNorm and an untied LM head.  The weights are the port's layout
(``families/llama.py``): ``wq`` (d, H, hd), ``wo`` (H, hd, d), and so on;
``dm`` is that family's ``Dims``.  ``to_tf32``, ``mm``, ``rmsnorm``,
``rope`` and ``attention`` serve other families' references too.

``prec`` is ``"fp32"`` (the configuration's precision; TF32 must be off on
the card) or ``"tf32"``, the control: every product's operands rounded to
TF32's 10-bit mantissa, as the tensor cores take them, the sums in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SCORES_ELEMS = 1 << 28  # fp32 scores of one attention chunk: 1 GiB


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g, ta, tb = to_tf32(g), to_tf32(a), to_tf32(b)
        ga = g @ tb.mT
        gb = ta.mT @ g
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return a @ b
    if prec == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"precision must be fp32 or tf32; got {prec!r}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, heads, hd) at positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, dm, prec: str) -> torch.Tensor:
    """Causal attention of q (B, T, H, hd) against k, v (B, T, KV, hd), a
    batch row and a chunk of heads at a time (at most ``SCORES_ELEMS``
    scores each)."""
    B, T, H, hd = q.shape
    k = k.repeat_interleave(dm.group, dim=2)
    v = v.repeat_interleave(dm.group, dim=2)
    chunk = max(1, min(H, SCORES_ELEMS // (T * T)))
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    rows = []
    for b in range(B):
        parts = []
        for h0 in range(0, H, chunk):
            qs, ks, vs = (t[b, :, h0:h0 + chunk].transpose(0, 1) for t in (q, k, v))
            s = mm(qs, ks.mT, prec) * hd ** -0.5
            p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
            parts.append(mm(p, vs, prec).transpose(0, 1))
        rows.append(torch.cat(parts, dim=1))
    return torch.stack(rows)


def block(p: dict, x: torch.Tensor, dm, prec: str) -> torch.Tensor:
    B, T, d = x.shape
    a = p["attn"]
    h = rmsnorm(x, p["norm1"]["scale"], dm.norm_eps)
    q = mm(h, a["wq"].reshape(d, -1), prec).view(B, T, dm.heads, dm.head_dim)
    k = mm(h, a["wk"].reshape(d, -1), prec).view(B, T, dm.kv_heads, dm.head_dim)
    v = mm(h, a["wv"].reshape(d, -1), prec).view(B, T, dm.kv_heads, dm.head_dim)
    o = attention(rope(q, dm.rope_theta), rope(k, dm.rope_theta), v, dm, prec)
    x = x + mm(o.reshape(B, T, -1), a["wo"].reshape(-1, d), prec)
    f = p["ffn"]
    h = rmsnorm(x, p["norm2"]["scale"], dm.norm_eps)
    return x + mm(F.silu(mm(h, f["w_gate"], prec)) * mm(h, f["w_in"], prec), f["w_out"], prec)


def forward(params: dict, tokens: torch.Tensor, dm, *, prec: str = "fp32",
            logits_from: int = 0, remat: bool = False) -> torch.Tensor:
    """Logits (B, T - logits_from, V) of ``tokens`` (B, T) at positions
    ``logits_from`` on.  ``remat`` recomputes each block in the backward
    (only the blocks' inputs are kept), so a training step fits beside the
    optimizer's state."""
    x = params["embed"]["table"][tokens]
    for p in params["blocks"]:
        if remat:
            x = checkpoint(block, p, x, dm, prec, use_reentrant=False)
        else:
            x = block(p, x, dm, prec)
    x = rmsnorm(x[:, logits_from:], params["final_norm"]["scale"], dm.norm_eps)
    return mm(x, params["lm_head"].T, prec)


def loss(params: dict, tokens, labels, dm, *, prec: str = "fp32",
         remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``labels`` given ``tokens``."""
    logits = forward(params, tokens, dm, prec=prec, remat=remat)
    return F.cross_entropy(logits.reshape(-1, dm.vocab), labels.reshape(-1))
