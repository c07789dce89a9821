"""Mixture-of-Experts FFN: GShard/Switch-style dispatch and combine.

Top-k routing with a capacity factor; tokens past an expert's capacity are
dropped (their combine weight is zero), and the dense-residual path
(arctic) and the residual stream keep them alive.  A Switch load-balance
auxiliary loss is returned.  Each step reproduces the JAX package's
``moe_apply``: the same groups, ties broken toward the lower expert index
as ``lax.top_k`` breaks them, the same capacity positions.  On one card
the experts run as one batched matmul over the expert axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, *, gated: bool,
             dtype=torch.float32, device="cpu") -> dict:
    E, Fd = cfg.num_experts, cfg.expert_d_ff
    kw = dict(dtype=dtype, device=device)
    ff_axis = "expert_ff_tp" if cfg.sharding == "tp" else "expert_ff"
    e_axis = None if cfg.sharding == "tp" else "expert"
    p = {
        "router": layers.dense_init(gen, (d_model, E), ("embed", None), **kw),
        "w_in": layers.dense_init(gen, (E, d_model, Fd), (e_axis, "embed", ff_axis),
                                  fan_in=d_model, **kw),
        "w_out": layers.dense_init(gen, (E, Fd, d_model), (e_axis, ff_axis, "embed"),
                                   fan_in=Fd, **kw),
    }
    if gated:
        p["w_gate"] = layers.dense_init(gen, (E, d_model, Fd), (e_axis, "embed", ff_axis),
                                        fan_in=d_model, **kw)
    if cfg.dense_residual:
        p["dense"] = layers.mlp_init(gen, d_model, cfg.dense_d_ff, gated=gated, **kw)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, largest first, equal values in
    ascending index order (``lax.top_k``'s order; ``torch.topk`` promises
    none): a stable descending sort."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
              capacity_factor: float = 1.25, group_size: int = 512):
    """x (B,S,D) -> (output (B,S,D), aux load-balance loss, a scalar).

    Tokens are regrouped to (n_groups, g) before dispatch, g being
    ``group_size`` halved until it divides the token count, and each group
    gives each expert C = max(1, int(cf*g*k/E)) slots."""
    B0, S0, D = x.shape
    tokens = B0 * S0
    g = group_size
    while tokens % g:
        g //= 2
    x = x.reshape(tokens // g, g, D)
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = max(1, int(capacity_factor * S * K / E))

    router_logits = x.float() @ params["router"].float()            # (B,S,E)
    probs = torch.softmax(router_logits, dim=-1)
    gate_w, gate_idx = _top_k(probs, K)                               # (B,S,K)
    gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)

    # Position of each token in its expert's buffer, per routing slot: an
    # exclusive cumsum over the (S*K) axis, s-major and k-minor.
    slot_onehot = F.one_hot(gate_idx, E).float()                      # (B,S,K,E)
    flat = slot_onehot.reshape(B, S * K, E)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    pos_in_expert = (pos_in_expert * flat).sum(dim=-1).reshape(B, S, K)
    keep = pos_in_expert < C                                          # drop overflow
    gate_w = gate_w * keep

    # jax.nn.one_hot gives a zero row for a position past C; F.one_hot
    # raises on it, so clamp and mask.
    pos = pos_in_expert.long().clamp(max=C - 1)
    cap_onehot = F.one_hot(pos, C).float() * keep[..., None]          # (B,S,K,C)
    dispatch = torch.einsum("bske,bskc->bsec", slot_onehot, cap_onehot)
    combine = torch.einsum("bske,bskc->bsec", slot_onehot * gate_w[..., None], cap_onehot)

    expert_in = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    xe = expert_in.permute(1, 0, 2, 3).reshape(E, B * C, D)          # (E, B*C, D)
    h = torch.bmm(xe, params["w_in"])
    if "w_gate" in params:
        h = F.silu(torch.bmm(xe, params["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    expert_out = torch.bmm(h, params["w_out"]).reshape(E, B, C, D).permute(1, 0, 2, 3)

    y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), expert_out)

    if cfg.dense_residual:
        y = y + layers.mlp_apply(params["dense"], x)

    # Switch-style load-balance aux loss over the top-1 slot.
    frac_tokens = slot_onehot[:, :, 0, :].mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * (frac_tokens * frac_probs).sum()
    return y.reshape(B0, S0, D), aux
