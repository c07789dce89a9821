"""Plain PyTorch versions of every hand-written kernel.

The wrappers in ``kernels.ops`` call these for tensors on the CPU, and the
card checks hold each kernel against them on the same inputs.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Naive GQA attention (B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd).

    Scores and softmax in fp32, output in ``v``'s dtype.  Queries and keys
    are aligned at position 0 (query i sees keys 0..i under ``causal``).
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * scale
    if causal:
        qp = torch.arange(Sq, device=q.device)
        mask = qp[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(v.dtype)


def decode_attention_ref(q, k_new, v_new, k_cache, v_cache, t: int):
    """One decode step of q (B,1,H,hd) against a (B,S,KV,hd) cache.

    Writes k_new/v_new (B,1,KV,hd) into the caches IN PLACE at position
    ``t``: the JAX version returns updated copies, which here would cost a
    copy of the whole cache per layer per step.  Attends to positions
    ``<= t``.  Returns (out (B,1,H,hd), k_cache, v_cache)."""
    k_cache[:, t] = k_new[:, 0]
    v_cache[:, t] = v_new[:, 0]
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float()) * scale
    mask = torch.arange(S, device=q.device) <= t
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    out = (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(B, 1, H, hd), k_cache, v_cache


def decode_proj_ref(x: torch.Tensor, *ws: torch.Tensor, transposed: bool = False,
                    gated: bool = False) -> tuple:
    """``x @ w`` for each weight, w taken as (K, N) (its leading dims
    multiplying to x's last dim K) or, where ``transposed``, ``x @ w.T`` for
    w (N, K); where ``gated``, for ``ws = (w_in, w_gate)``, the one output
    ``silu(x @ w_gate) * (x @ w_in)``.  Each (..., N)."""
    K = x.shape[-1]
    ys = [x @ (w.T if transposed else w.reshape(K, -1)) for w in ws]
    if gated:
        return (torch.nn.functional.silu(ys[1]) * ys[0],)
    return tuple(ys)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, cast back to x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Backward versions, written from the formulas (not through autograd), so
# that the CPU tests can hold them against ``jax.vjp`` of the JAX oracles.
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """Scaled fp32 scores (B,KV,G,Sq,Sk) and the mask of visible keys."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / (hd ** 0.5))
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(
            Sk, device=q.device)[None, :]
    return s, mask


def _by_head(t: torch.Tensor) -> torch.Tensor:
    """(B,KV,G,Sq,...) -> (B,H,Sq,...)."""
    return t.reshape(t.shape[0], t.shape[1] * t.shape[2], *t.shape[3:])


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True) -> torch.Tensor:
    """Per-row log-sum-exp of the scaled, masked scores, (B,H,Sq) in fp32:
    what the forward kernel writes beside its output for the backward."""
    s, mask = _scores(q, k, causal)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return _by_head(torch.logsumexp(s, dim=-1))


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` at (q, k, v) for
    the output gradient ``do``, given its output ``o`` and row
    log-sum-exp ``lse`` (B,H,Sq):

        P  = exp(S * scale - lse) on visible keys, 0 elsewhere
        dV = sum over the group's heads of P^T dO
        dS = P * (dO V^T - rowsum(dO * O))
        dQ = scale * dS K,  dK = scale * sum over the group of dS^T Q

    in fp32, each cast to its input's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    s, mask = _scores(q, k, causal)
    lse_g = lse.float().reshape(B, KV, G, Sq)
    p = torch.where(mask, torch.exp(s - lse_g[..., None]), torch.zeros_like(s))
    dog = do.reshape(B, Sq, KV, G, hd).float()
    og = o.reshape(B, Sq, KV, G, hd).float()
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    D = (dog * og).sum(-1).permute(0, 2, 3, 1)  # (B,KV,G,Sq)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds,
                      q.reshape(B, Sq, KV, G, hd).float()) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                    eps: float = 1e-5):
    """Gradients (dx, dscale) of ``rmsnorm_ref`` at (x, scale) for the
    output gradient ``dy``, with r = rsqrt(mean(x^2) + eps) per row:

        dx     = r * (dy * s) - x * r^3 * sum(dy * s * x) / d
        dscale = sum over rows of dy * x * r

    in fp32; dx in x's dtype, dscale in scale's."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    g = dy.float().reshape(-1, d)
    sf = scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gs = g * sf
    dot = (gs * xf).sum(dim=-1, keepdim=True)
    dx = r * gs - xf * (r * r * r) * (dot / d)
    dscale = (g * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)
