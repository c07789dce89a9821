"""A Jamba decoder as ``transformers`` writes it (``models/jamba/
modeling_jamba.py``, 4.57.6; AI21-Jamba2-Mini's ``config.json``), in plain
PyTorch, fp32, for the configuration's judge:

    h = x + mixer(n1(x))          mixer: attention or Mamba, by layer
    y = h + ffn(n2(h))            ffn: a SwiGLU MLP, or the MoE, by layer

- RMSNorm ``x * rsqrt(mean(x^2) + eps) * w`` (``JambaRMSNorm``);
- attention (``JambaAttention``): grouped-query, causal, no rotary
  embedding and no positional encoding of any kind;
- the Mamba mixer (``JambaMambaMixer.slow_forward``): ``in_proj`` into x and
  the gate z, a depthwise causal conv with bias and SiLU, ``x_proj`` into
  dt, B and C, an RMSNorm on each of the three, dt through ``dt_proj`` (with
  bias) and softplus, then the selective scan as a loop over time, ``h_t =
  exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = h_t C_t + D x_t``, the gate
  ``y * silu(z)`` and ``out_proj``; A = -exp(A_log);
- the MoE (``JambaSparseMoeBlock``): the router's softmax, its top-K, the
  gates those probabilities (not renormalised), and a loop over the
  experts, each over the tokens routed to it, added into the output;
- a final RMSNorm and an untied LM head.

Departures from the ``transformers`` code, none of them in the arithmetic:
the weights are the port's layout (``families/jamba.py``): ``wq`` (d, H,
hd), ``in_proj`` (d, 2E), ``conv_w`` (W, E), the experts stacked (E, d, F),
and so on; the scan computes each step's ``exp(dt A)`` and ``dt B x`` in
the step, where ``transformers`` makes them for the whole sequence at
once, so a check of thousands of positions fits beside the weights; ties
in the top-K go to the lower index (``torch.topk`` promises no order);
the router and the scan's ``h C`` are products through ``mm``, so the
control rounds their operands too.

``routes``, where given, is one (B, T, K) tensor of chosen experts a MoE
layer: the reference then follows those choices (the program's, teacher
forced) with the reference's own probabilities as gates, and reports
``route_gap``, the widest gap by which a chosen expert's probability lies
below the reference's own K-th largest at that position and layer (0 where
the chosen set is the reference's own).  ``prec`` is as in
``reference/model.py``: ``"fp32"``, or ``"tf32"``, the control.  It imports
nothing of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import attention, mm, rmsnorm


def _mamba(p: dict, x: torch.Tensor, dm, prec: str) -> torch.Tensor:
    """The mixer over x (B, T, d)."""
    B, T, _ = x.shape
    E, N, R, W = dm.inner, dm.d_state, dm.dt_rank, dm.d_conv
    xs, z = mm(x, p["in_proj"], prec).chunk(2, dim=-1)                   # (B,T,E)
    xs = F.conv1d(xs.transpose(1, 2), p["conv_w"].t()[:, None, :], p["conv_b"],
                  padding=W - 1, groups=E)[..., :T]
    xs = F.silu(xs).transpose(1, 2)                                       # (B,T,E)
    dt, Bm, Cm = torch.split(mm(xs, p["x_proj"], prec), [R, N, N], dim=-1)
    dt = rmsnorm(dt, p["dt_norm"]["scale"], dm.norm_eps)
    Bm = rmsnorm(Bm, p["B_norm"]["scale"], dm.norm_eps)
    Cm = rmsnorm(Cm, p["C_norm"]["scale"], dm.norm_eps)
    dt = F.softplus(mm(dt, p["dt_proj"], prec) + p["dt_bias"])            # (B,T,E)
    A = -torch.exp(p["A_log"])                                            # (E,N)
    h = torch.zeros((B, E, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        d_t = dt[:, t, :, None]                                           # (B,E,1)
        h = torch.exp(d_t * A) * h + d_t * Bm[:, t, None, :] * xs[:, t, :, None]
        ys.append(mm(h, Cm[:, t, :, None], prec)[..., 0])                 # (B,E)
    y = torch.stack(ys, dim=1) + xs * p["D"]
    return mm(y * F.silu(z), p["out_proj"], prec)


def _attention(p: dict, x: torch.Tensor, dm, prec: str) -> torch.Tensor:
    B, T, d = x.shape
    q = mm(x, p["wq"].reshape(d, -1), prec).view(B, T, dm.heads, dm.head_dim)
    k = mm(x, p["wk"].reshape(d, -1), prec).view(B, T, dm.kv_heads, dm.head_dim)
    v = mm(x, p["wv"].reshape(d, -1), prec).view(B, T, dm.kv_heads, dm.head_dim)
    o = attention(q, k, v, dm, prec)
    return mm(o.reshape(B, T, -1), p["wo"].reshape(-1, d), prec)


def _mlp(w_in, w_gate, w_out, x, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, prec)) * mm(x, w_in, prec), w_out, prec)


def _moe(p: dict, x: torch.Tensor, dm, prec: str, route, gaps: list, taken: list,
         probs_out) -> torch.Tensor:
    B, T, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(mm(xt, p["router"], prec), dim=-1)              # (BT,E)
    if probs_out is not None:
        probs_out.append(probs.view(B, T, -1))
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    kth = top.values[:, dm.top_k - 1]
    chosen = top.indices[:, :dm.top_k] if route is None else route.reshape(-1, dm.top_k)
    gate = probs.gather(1, chosen)                                        # (BT,K)
    gaps.append((kth[:, None] - gate).clamp(min=0).max())
    taken.append(chosen.view(B, T, dm.top_k))
    out = torch.zeros_like(xt)
    for e in range(dm.experts):
        tok, slot = torch.where(chosen == e)
        if tok.numel() == 0:
            continue
        y = _mlp(p["w_in"][e], p["w_gate"][e], p["w_out"][e], xt[tok], prec)
        out.index_add_(0, tok, y * gate[tok, slot, None])
    return out.view(B, T, d)


def run(params: dict, tokens: torch.Tensor, dm, *, prec: str = "fp32", logits_from: int = 0,
        routes=None, probs=None):
    """(logits (B, T - logits_from, V), route_gap, the routes taken: one
    (B, T, K) tensor a MoE layer) of ``tokens`` (B, T).  ``routes``: the
    choices to follow (see the module's docstring), None to route freely.
    ``probs``, a list, gets each MoE layer's router probabilities (B, T, E)."""
    x = params["embed"]["table"][tokens]
    gaps, taken = [], []
    for l, p in enumerate(params["blocks"]):
        h = rmsnorm(x, p["norm1"]["scale"], dm.norm_eps)
        x = x + (_attention(p["attn"], h, dm, prec) if dm.kinds[l] == "attn"
                 else _mamba(p["mamba"], h, dm, prec))
        h = rmsnorm(x, p["norm2"]["scale"], dm.norm_eps)
        f = p["ffn"]
        if dm.moe[l]:
            route = None if routes is None else routes[len(taken)]
            x = x + _moe(f, h, dm, prec, route, gaps, taken, probs)
        else:
            x = x + _mlp(f["w_in"], f["w_gate"], f["w_out"], h, prec)
    x = rmsnorm(x[:, logits_from:], params["final_norm"]["scale"], dm.norm_eps)
    gap = max((float(g) for g in gaps), default=0.0)
    return mm(x, params["lm_head"].T, prec), gap, taken


def forward(params: dict, tokens: torch.Tensor, dm, *, prec: str = "fp32",
            logits_from: int = 0, remat: bool = False) -> torch.Tensor:
    """Logits (B, T - logits_from, V) of ``tokens`` (B, T), routing freely
    (``remat`` is for training, which this family does not run)."""
    return run(params, tokens, dm, prec=prec, logits_from=logits_from)[0]
