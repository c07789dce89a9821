"""Mamba selective-SSM block (arXiv:2312.00752).

The full-sequence pass (prefill) runs the depthwise causal convolution over
the whole sequence, then the selective scan as a loop over time with the
state h (B, E, N) in fp32; the per-step terms exp(dt*A) and dt*B*x are
computed a chunk of time steps at a time, so each step of the loop is one
fused multiply-add.  Decode is a single recurrence step carrying
(ssm_state, conv_state).  E = expand * d_model is the inner width.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers

# time steps whose scan terms are materialised at once: bounds the extra
# memory to 3 * B * SCAN_CHUNK * E * N fp32 values
SCAN_CHUNK = 64


def _dt_rank(d_model: int, cfg: SSMConfig) -> int:
    return cfg.dt_rank or -(-d_model // 16)


def mamba_init(gen: torch.Generator, d_model: int, cfg: SSMConfig, *,
               dtype=torch.float32, device="cpu") -> dict:
    E = cfg.expand * d_model
    N = cfg.state_dim
    R = _dt_rank(d_model, cfg)
    kw = dict(dtype=dtype, device=device)
    # S4D-real initialization for A.
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device).repeat(E, 1)
    return {
        "in_proj": layers.dense_init(gen, (d_model, 2 * E), **kw),
        "conv_w": layers.dense_init(gen, (cfg.conv_width, E), fan_in=cfg.conv_width, **kw),
        "conv_b": layers.zeros_init((E,), **kw),
        "x_proj": layers.dense_init(gen, (E, R + 2 * N), **kw),
        "dt_proj": layers.dense_init(gen, (R, E), **kw),
        "dt_bias": layers.zeros_init((E,), **kw),
        "A_log": torch.log(a),
        "D": layers.ones_init((E,), device=device),
        "out_proj": layers.dense_init(gen, (E, d_model), fan_in=E, **kw),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution in fp32.  x (B,S,E), w (W,E) -> (B,S,E).

    Like ``lax.conv_general_dilated`` it is a cross-correlation (the kernel
    is not flipped): out[t] = sum_j w[j] * x[t - W + 1 + j], zero before 0.
    """
    W, S = w.shape[0], x.shape[1]
    lhs = x.float().transpose(1, 2)                 # (B,E,S)
    rhs = w.float().t()[:, None, :]                 # (E,1,W)
    out = F.conv1d(lhs, rhs, padding=W - 1, groups=x.shape[-1])[..., :S]
    return (out.transpose(1, 2) + b).to(x.dtype)


def _ssm_params(params, xc, d_model, cfg):
    """xc (..., E) -> dt (..., E), Bp (..., N), Cp (..., N), all fp32."""
    N = cfg.state_dim
    R = _dt_rank(d_model, cfg)
    dbc = xc @ params["x_proj"]
    dt_x, Bp, Cp = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus(dt_x @ params["dt_proj"] + params["dt_bias"])
    return dt.float(), Bp.float(), Cp.float()


def _scan(dt, Bp, Cp, xcf, A):
    """The selective scan over time.  dt, xcf (B,S,E), Bp, Cp (B,S,N),
    A (E,N).  Returns y (B,S,E) and the last state (B,E,N), fp32."""
    B, S, E = dt.shape
    h = torch.zeros((B, E, A.shape[1]), dtype=torch.float32, device=dt.device)
    ys = []
    for t0 in range(0, S, SCAN_CHUNK):
        sl = slice(t0, t0 + SCAN_CHUNK)
        dtc = dt[:, sl, :, None]
        dA = torch.exp(dtc * A)                                   # (B,c,E,N)
        dBx = dtc * Bp[:, sl, None, :] * xcf[:, sl, :, None]
        hs = []
        for i in range(dA.shape[1]):
            h = torch.addcmul(dBx[:, i], h, dA[:, i])             # h*dA + dBx
            hs.append(h)
        ys.append(torch.einsum("bten,btn->bte", torch.stack(hs, dim=1), Cp[:, sl]))
    return torch.cat(ys, dim=1), h


def mamba_apply(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
                ssm_state=None, conv_state=None, return_state: bool = False):
    """x (B,S,D).  With states given (decode), S must be 1.

    Returns y (B,S,D) and, if ``return_state``, the new (ssm_state,
    conv_state): the last state of the scan and the last W-1 pre-conv
    inputs (left-padded with zeros when S < W-1).
    """
    B, S, D = x.shape
    W = cfg.conv_width

    xz = x @ params["in_proj"]
    x1, z = xz.chunk(2, dim=-1)
    A = -torch.exp(params["A_log"])                               # (E,N)

    if ssm_state is None:
        # --- full-sequence path -------------------------------------------
        xc = F.silu(_conv_causal(x1, params["conv_w"], params["conv_b"]))
        dt, Bp, Cp = _ssm_params(params, xc, D, cfg)
        xcf = xc.float()
        ys, new_ssm = _scan(dt, Bp, Cp, xcf, A)
        y = ys + params["D"] * xcf                                # (B,S,E)
        new_conv = None
        if return_state:
            pad = torch.zeros((B, max(W - 1 - S, 0), x1.shape[-1]), dtype=x1.dtype,
                              device=x.device)
            new_conv = torch.cat([pad, x1[:, -(W - 1):]], dim=1)
    else:
        # --- single-step decode -------------------------------------------
        if S != 1:
            raise ValueError(f"mamba decode takes one token per sequence; got {S}")
        window = torch.cat([conv_state, x1], dim=1)              # (B,W,E)
        xc = torch.einsum("bwe,we->be", window.float(),
                          params["conv_w"].float()) + params["conv_b"]
        xc = F.silu(xc)                                           # (B,E)
        dt, Bp, Cp = _ssm_params(params, xc, D, cfg)
        dA = torch.exp(dt[..., None] * A)
        dBx = dt[..., None] * Bp[:, None, :] * xc.float()[..., None]
        new_ssm = ssm_state * dA + dBx
        y = torch.einsum("ben,bn->be", new_ssm, Cp) + params["D"] * xc
        y = y[:, None, :]                                         # (B,1,E)
        new_conv = window[:, 1:]

    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    if return_state:
        return out, new_ssm, new_conv
    return out


def mamba_state_shapes(batch: int, d_model: int, cfg: SSMConfig) -> dict:
    E = cfg.expand * d_model
    return {
        "ssm": (batch, E, cfg.state_dim),
        "conv": (batch, cfg.conv_width - 1, E),
    }
