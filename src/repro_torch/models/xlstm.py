"""xLSTM blocks (arXiv:2405.04517): sLSTM (scalar memory, exponential
gating, head-block-diagonal recurrence) and mLSTM (matrix memory,
attention-like key/value outer products).

Both are exact recurrences, run as a loop over time for the full sequence
(prefill) and as one step for decode, with every state in fp32.  As in the
JAX package: no causal-conv preprocessing on the q/k path, and RMSNorm in
place of GroupNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models import layers

# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _round64(x: float) -> int:
    """Round projection widths up to a multiple of 64 (the JAX package's
    widths: 1024*4/3 = 1365 becomes 1408)."""
    return max(64, int(-(-x // 64)) * 64)


def slstm_init(gen: torch.Generator, d_model: int, num_heads: int, cfg: XLSTMConfig, *,
               dtype=torch.float32, device="cpu") -> dict:
    dh = d_model // num_heads
    E = _round64(cfg.proj_factor_slstm * d_model)
    kw = dict(dtype=dtype, device=device)
    return {
        # i, f, z, o stacked on the last dim
        "W": layers.dense_init(gen, (d_model, 4 * d_model), ("embed", "inner"), **kw),
        "R": layers.dense_init(gen, (num_heads, dh, 4 * dh), ("heads", None, None),
                               fan_in=dh, **kw),
        "b": layers.zeros_init(gen, (4 * d_model,), ("inner",), **kw),
        "up": layers.dense_init(gen, (d_model, E), ("embed", "inner"), **kw),
        "down": layers.dense_init(gen, (E, d_model), ("inner", "embed"), fan_in=E, **kw),
    }


def _slstm_cell(R: torch.Tensor, wx_t: torch.Tensor, state: dict, num_heads: int) -> dict:
    """One sLSTM step.  R (H, dh, 4dh) fp32, wx_t (B, 4D) the precomputed
    W@x + b; state a dict of (B, D) fp32 tensors."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    B, D = h.shape
    rh = torch.einsum("bhd,hde->bhe", h.reshape(B, num_heads, D // num_heads),
                      R).reshape(B, 4 * D)
    pre = (wx_t + rh).float()
    i_t, f_t, z_t, o_t = pre.chunk(4, dim=-1)
    m_new = torch.maximum(f_t + m, i_t)
    i_g = torch.exp(i_t - m_new)
    f_g = torch.exp(f_t + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_t)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_apply(params: dict, x: torch.Tensor, num_heads: int, *, state=None,
                return_state: bool = False):
    B, S, D = x.shape
    wx = x @ params["W"] + params["b"]                             # (B,S,4D)
    if state is None:
        state = slstm_init_state(B, D, device=x.device)
    R = params["R"].float()  # the fp32 state meets R in fp32, as in JAX
    hs = []
    for t in range(S):
        state = _slstm_cell(R, wx[:, t], state, num_heads)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)                         # (B,S,D)
    u = F.gelu(h @ params["up"], approximate="tanh")  # jax.nn.gelu's default form
    out = u @ params["down"]
    if return_state:
        return out, state
    return out


def slstm_init_state(batch: int, d_model: int, *, device="cpu") -> dict:
    def z():
        return torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, d_model), -1e30, dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, d_model: int, num_heads: int, cfg: XLSTMConfig, *,
               dtype=torch.float32, device="cpu") -> dict:
    E = _round64(cfg.proj_factor_mlstm * d_model)
    dh = E // num_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": layers.dense_init(gen, (d_model, 2 * E), ("embed", "inner"), **kw),
        "Wq": layers.dense_init(gen, (num_heads, dh, dh), ("heads", None, None),
                                 fan_in=dh, **kw),
        "Wk": layers.dense_init(gen, (num_heads, dh, dh), ("heads", None, None),
                                 fan_in=dh, **kw),
        "Wv": layers.dense_init(gen, (num_heads, dh, dh), ("heads", None, None),
                                 fan_in=dh, **kw),
        "w_if": layers.dense_init(gen, (E, 2 * num_heads), ("inner", None), **kw),
        "out_proj": layers.dense_init(gen, (E, d_model), ("inner", "embed"), fan_in=E, **kw),
    }


def _mlstm_step(state: dict, q_t, k_t, v_t, i_t, f_t):
    """One mLSTM step on fp32 q/k/v (B,H,dh) and gates (B,H).  Returns the
    new state and h_t (B,H,dh)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(f_t + m, i_t)                            # (B,H)
    i_g = torch.exp(i_t - m_new)
    f_g = torch.exp(f_t + m - m_new)
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * (
        v_t[..., :, None] * k_t[..., None, :])                     # (B,H,dh,dh)
    n_new = f_g[..., None] * n + i_g[..., None] * k_t              # (B,H,dh)
    num = torch.einsum("bhve,bhe->bhv", C_new, q_t)
    den = torch.abs(torch.einsum("bhe,bhe->bh", n_new, q_t))
    den = torch.maximum(den, torch.exp(-m_new))
    return {"C": C_new, "n": n_new, "m": m_new}, num / den[..., None]


def mlstm_apply(params: dict, x: torch.Tensor, num_heads: int, cfg: XLSTMConfig, *,
                state=None, return_state: bool = False):
    B, S, D = x.shape
    E = _round64(cfg.proj_factor_mlstm * D)
    H, dh = num_heads, E // num_heads

    xz = x @ params["in_proj"]
    xi, z = xz.chunk(2, dim=-1)
    xih = xi.reshape(B, S, H, dh)
    q = torch.einsum("bshd,hde->bshe", xih, params["Wq"]).float()
    k = (torch.einsum("bshd,hde->bshe", xih, params["Wk"]) / (dh ** 0.5)).float()
    v = torch.einsum("bshd,hde->bshe", xih, params["Wv"]).float()
    gates = (xi @ params["w_if"]).float()
    i_t, f_t = gates.chunk(2, dim=-1)                              # (B,S,H)
    f_t = -F.softplus(-f_t)  # log sigmoid: a stable forget gate in log space

    if state is None:
        state = mlstm_init_state(B, H, dh, device=x.device)
    hs = []
    for t in range(S):
        state, h_t = _mlstm_step(state, q[:, t], k[:, t], v[:, t], i_t[:, t], f_t[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(B, S, E).to(x.dtype)
    h = h * F.silu(z)
    out = h @ params["out_proj"]
    if return_state:
        return out, state
    return out


def mlstm_init_state(batch: int, num_heads: int, dh: int, *, device="cpu") -> dict:
    return {
        "C": torch.zeros((batch, num_heads, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, num_heads, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, num_heads), -1e30, dtype=torch.float32, device=device),
    }
