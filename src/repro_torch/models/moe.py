"""Mixture-of-Experts FFN: GShard/Switch-style dispatch and combine, or
dropless top-k routing.

Top-k routing with a capacity factor; tokens past an expert's capacity are
dropped (their combine weight is zero), and the dense-residual path
(arctic) and the residual stream keep them alive.  A Switch load-balance
auxiliary loss is returned.  Each step reproduces the JAX package's
``moe_apply``: the same groups, ties broken toward the lower expert index
as ``lax.top_k`` breaks them, the same capacity positions.  On one card
the experts run as one batched matmul over the expert axis.

With ``MoEConfig.dropless`` (the port's own; Jamba, Mixtral) no token is
dropped: every routed (token, expert) pair is computed once with its
expert's weights (``_dropless``).

``record_routes()`` opens a routing record: while it is open, each call
appends its (tokens, K) tensor of chosen experts, in call order.  It keeps
a reference to the tensor the routing made (no copy, no launch); closed,
as it is by default, it costs one read of a module variable.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers
from repro_torch.parallel.sharding_rules import AxisRules


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


# the open routing record (a list), or None
_routes: list | None = None


@contextlib.contextmanager
def record_routes():
    """A routing record: the list it yields gets each MoE call's (tokens, K)
    chosen experts (int64, ``top_k``'s order), in call order, while open."""
    global _routes
    outer, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = outer


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis, largest first, equal values in
    ascending index order (``lax.top_k``'s order; ``torch.topk`` promises
    none): a stable descending sort."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              rules: AxisRules = layers._NULL_RULES, *,
              capacity_factor: float = 1.25, group_size: int = 512):
    """x (B,S,D) -> (output (B,S,D), aux load-balance loss, a scalar).

    Tokens are regrouped to (n_groups, g) before dispatch, g being
    ``group_size`` halved until it divides the token count, and each group
    gives each expert C = max(1, int(cf*g*k/E)) slots.  With
    ``cfg.dropless`` nothing is grouped or dropped (``_dropless``)."""
    if cfg.dropless:
        return _dropless(params, x, cfg, rules)
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
    # laid out by batch, and so its gradient: the top-k's and the aux loss's
    # would come back split over the group's tokens, which the router's
    # product then flattens into a strided shard, and DTensor plans every
    # redistribute of one by a search (minutes a layer on a 16 x 16 mesh)
    probs = rules.constrain(torch.softmax(router_logits, dim=-1), "batch", None, None)
    # the router's two consumers (the top-k and the aux loss) and the gates
    # hand their gradients back laid out by batch, so the ops between take
    # no layout that DTensor picks by how the groups divide over the mesh
    gate_w, gate_idx = _top_k(rules.constrain(probs, "batch", None, None, grad=True), K)
    if _routes is not None:
        _routes.append(gate_idx.reshape(-1, K))
    if cfg.renormalize:
        gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)
    gate_w = rules.constrain(gate_w, "batch", None, None, grad=True)        # (B,S,K)

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
    expert_in = rules.constrain(expert_in, "batch", "expert", None, "embed_act")
    xe = expert_in.permute(1, 0, 2, 3).reshape(E, B * C, D)          # (E, B*C, D)
    h = torch.bmm(xe, params["w_in"])
    if "w_gate" in params:
        h = F.silu(torch.bmm(xe, params["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    expert_out = torch.bmm(h, params["w_out"]).reshape(E, B, C, D).permute(1, 0, 2, 3)
    expert_out = rules.constrain(expert_out, "batch", "expert", None, "embed_act")

    if rules.enabled:
        # einsum's product over (e, c), written out: its own permute and
        # view of the expert-split operand leave DTensor a strided shard (a
        # planner search, ~50 s a layer on a 16 x 16 mesh)
        y = torch.bmm(combine.to(x.dtype).reshape(B, S, E * C),
                      expert_out.contiguous().reshape(B, E * C, D))
    else:
        y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), expert_out)

    if cfg.dense_residual:
        y = y + layers.mlp_apply(params["dense"], x, rules)

    # Switch-style load-balance aux loss over the top-1 slot.
    frac_tokens = slot_onehot[:, :, 0, :].mean(dim=(0, 1))
    frac_probs = rules.constrain(probs, "batch", None, None, grad=True).mean(dim=(0, 1))
    aux = E * (frac_tokens * frac_probs).sum()
    return rules.constrain(y.reshape(B0, S0, D), "batch", "seq", "embed_act"), aux


def _count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``idx`` (1-D) equal each of 0..n-1, on its device with no
    host synchronisation (``bincount`` reads the largest index back)."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _dropless(params: dict, x: torch.Tensor, cfg: MoEConfig,
              rules: AxisRules = layers._NULL_RULES):
    """Dropless top-k: each token goes to the K experts of largest router
    probability (ties to the lower index), its gates those probabilities,
    divided by their sum where ``cfg.renormalize``; no capacity, no token
    dropped.  Returns (y (B,S,D), the aux loss over the top-1 slot).

    One token a sequence (decode) makes no host synchronisation: each
    expert takes every token, as in a buffer of capacity T with token t in
    slot t (so nothing can overflow), and the E products run as one batched
    product, E/K times the least FLOPs but the same weight bytes, which
    bound it at a decode batch; a token's output sums its K experts' rows
    by their gates, the others' by 0.  Longer inputs (prefill) read each
    expert's row count once and run one product an expert over the rows
    sorted by expert, the least FLOPs."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.num_experts, cfg.top_k
    xt = x.reshape(T, D)
    probs = torch.softmax(xt.float() @ params["router"].float(), dim=-1)      # (T,E)
    gate_w, gate_idx = _top_k(probs, K)                                        # (T,K)
    if _routes is not None:
        _routes.append(gate_idx)
    if cfg.renormalize:
        gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)
    gate_w = gate_w.to(x.dtype)
    if S == 1:
        combine = torch.zeros((T, E), dtype=x.dtype, device=x.device).scatter_(
            1, gate_idx, gate_w)                                               # (T,E)
        # the experts' weights (E, D, F) and (E, F, D) batch mlp_apply's products
        out = layers.mlp_apply(params, xt.expand(E, T, D))                     # (E,T,D)
        y = torch.einsum("te,etd->td", combine, out)
    else:
        flat = gate_idx.reshape(-1)                                            # (T*K,)
        order = torch.sort(flat, stable=True).indices
        counts = _count(flat, E).tolist()                      # one sync a layer
        rows = xt[order // K]
        mlp = [k for k in ("w_in", "w_gate", "w_out") if k in params]
        outs = [layers.mlp_apply({k: params[k][e] for k in mlp}, part)
                for e, part in enumerate(rows.split(counts))]
        routed = torch.empty((T * K, D), dtype=x.dtype, device=x.device)
        routed[order] = torch.cat(outs) * gate_w.reshape(-1)[order, None]
        y = routed.view(T, K, D).sum(dim=1)
    if cfg.dense_residual:
        y = y + layers.mlp_apply(params["dense"], xt, rules)
    frac_tokens = _count(gate_idx[:, 0], E).float() / T
    aux = E * (frac_tokens * probs.mean(dim=0)).sum()
    return y.reshape(B, S, D), aux
