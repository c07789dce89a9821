"""Mamba selective-SSM block (arXiv:2312.00752).

The full-sequence pass (prefill) runs the depthwise causal convolution over
the whole sequence, then the selective scan as a loop over time with the
state h (B, E, N) in fp32; the per-step terms exp(dt*A) and dt*B*x are
computed a chunk of time steps at a time, so each step of the loop is one
fused multiply-add.  Decode is a single recurrence step carrying
(ssm_state, conv_state).  E = expand * d_model is the inner width.

With ``SSMConfig.inner_norms`` (the port's own; Jamba's mixer) dt, B and C
each pass an RMSNorm of its own width (dt_rank, state_dim, state_dim) after
``x_proj`` and before ``dt_proj`` and the scan, in both paths; their scales
are the leaves ``dt_norm``, ``B_norm`` and ``C_norm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models import layers
from repro_torch.parallel.sharding_rules import AxisRules

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
    p = {
        "in_proj": layers.dense_init(gen, (d_model, 2 * E), ("embed", "inner"), **kw),
        "conv_w": layers.dense_init(gen, (cfg.conv_width, E), ("conv", "inner"),
                                    fan_in=cfg.conv_width, **kw),
        "conv_b": layers.zeros_init(gen, (E,), ("inner",), **kw),
        "x_proj": layers.dense_init(gen, (E, R + 2 * N), ("inner", None), **kw),
        "dt_proj": layers.dense_init(gen, (R, E), (None, "inner"), **kw),
        "dt_bias": layers.zeros_init(gen, (E,), ("inner",), **kw),
        # S4D-real initialization for A.
        "A_log": layers.param(gen, (E, N), ("inner", "ssm_state"), lambda: torch.log(
            torch.arange(1, N + 1, dtype=torch.float32, device=device).repeat(E, 1))),
        "D": layers.ones_init(gen, (E,), ("inner",), device=device),
        "out_proj": layers.dense_init(gen, (E, d_model), ("inner", "embed"), fan_in=E, **kw),
    }
    if cfg.inner_norms:
        for name, width in (("dt_norm", R), ("B_norm", N), ("C_norm", N)):
            p[name] = {"scale": layers.ones_init(gen, (width,), (None,), **kw)}
    return p


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 rules: AxisRules = layers._NULL_RULES) -> torch.Tensor:
    """Depthwise causal conv over the sequence: x (B,S,E), w (W,E), b (E,).

    Like ``lax.conv_general_dilated`` it is a cross-correlation (the kernel
    is not flipped): out[t] = sum_j w[j] * x[t - W + 1 + j], zero before 0.
    Under enabled rules it is W shifted multiply-adds over the zero-padded
    sequence, which keep E split where it is split over a mesh (DTensor's
    convolution rule would hand each shard of the channels the whole
    channel count as its group count).
    """
    W, S = w.shape[0], x.shape[1]
    if not rules.enabled:
        lhs = x.float().transpose(1, 2)                 # (B,E,S)
        rhs = w.float().t()[:, None, :]                 # (E,1,W)
        out = F.conv1d(lhs, rhs, padding=W - 1, groups=x.shape[-1])[..., :S]
        return (out.transpose(1, 2) + b).to(x.dtype)
    xp = F.pad(x.float(), (0, 0, W - 1, 0))         # (B, W-1+S, E)
    wf = w.float()
    out = xp[:, :S] * wf[0]
    for j in range(1, W):
        out = out + xp[:, j:j + S] * wf[j]
    return (out + b).to(x.dtype)


def _inner_norms(params, dt_x, Bp, Cp, eps: float):
    """dt_x, B and C through their RMSNorms (``SSMConfig.inner_norms``)."""
    return tuple(layers.rmsnorm_apply(params[name], a, eps=eps)
                 for name, a in (("dt_norm", dt_x), ("B_norm", Bp), ("C_norm", Cp)))


def _ssm_params(params, xc, d_model, cfg, rules: AxisRules, eps: float):
    """xc (B, [S,] E) -> dt (..., E), Bp (..., N), Cp (..., N), all fp32."""
    N = cfg.state_dim
    R = _dt_rank(d_model, cfg)
    # laid out by batch (and sequence): a sum over the split E that DTensor
    # would otherwise reduce-scatter over the sequence, which the scan's
    # per-chunk product flattens into a strided shard (a planner search)
    dbc = rules.constrain(xc @ params["x_proj"], "batch", *("seq",) * (xc.ndim - 2), None,
                          grad=True)
    dt_x, Bp, Cp = torch.split(dbc, [R, N, N], dim=-1)
    if cfg.inner_norms:
        dt_x, Bp, Cp = _inner_norms(params, dt_x, Bp, Cp, eps)
    dt = F.softplus(dt_x @ params["dt_proj"] + params["dt_bias"])
    return dt.float(), Bp.float(), Cp.float()


def _scan(dt, Bp, Cp, xcf, A):
    """The selective scan over time.  dt, xcf (B,S,E), Bp, Cp (B,S,N),
    A (E,N).  Returns y (B,S,E) and the last state (B,E,N), fp32."""
    B, S, E = dt.shape
    h = torch.zeros((B, E, A.shape[1]), dtype=torch.float32, device=dt.device)
    ys = []
    # split and unbind once, not a slice a chunk and a step: the gradient of
    # a slice is as long as the sequence, and summing one a step is
    # quadratic in the backward
    for dtc, Bc, Cc, xc in zip(*(a.split(SCAN_CHUNK, dim=1) for a in (dt, Bp, Cp, xcf))):
        dtc = dtc[..., None]
        dA = torch.exp(dtc * A)                                   # (B,c,E,N)
        dBx = dtc * Bc[:, :, None, :] * xc[..., None]
        hs = []
        for dBx_i, dA_i in zip(dBx.unbind(1), dA.unbind(1)):
            h = torch.addcmul(dBx_i, h, dA_i)                     # h*dA + dBx
            hs.append(h)
        ys.append(torch.einsum("bten,btn->bte", torch.stack(hs, dim=1), Cc))
    return torch.cat(ys, dim=1), h


def mamba_apply(params: dict, x: torch.Tensor, cfg: SSMConfig,
                rules: AxisRules = layers._NULL_RULES, *,
                ssm_state=None, conv_state=None, return_state: bool = False,
                norm_eps: float = 1e-6):
    """x (B,S,D).  With states given (decode), S must be 1.  ``norm_eps``
    is the inner RMSNorms' (``cfg.inner_norms``).

    Returns y (B,S,D) and, if ``return_state``, the new (ssm_state,
    conv_state): the last state of the scan and the last W-1 pre-conv
    inputs (left-padded with zeros when S < W-1).
    """
    B, S, D = x.shape
    W = cfg.conv_width

    xz = rules.constrain(x @ layers.gathered(params["in_proj"], rules, "embed", "inner"),
                         "batch", "seq", "inner")
    x1, z = xz.chunk(2, dim=-1)
    A = -torch.exp(params["A_log"])                               # (E,N)

    if ssm_state is None:
        # --- full-sequence path -------------------------------------------
        xc = F.silu(_conv_causal(x1, params["conv_w"], params["conv_b"], rules))
        dt, Bp, Cp = _ssm_params(params, xc, D, cfg, rules, norm_eps)
        xcf = xc.float()
        # the scan runs on each rank's batch rows and inner channels as plain
        # tensors: DTensor would lay a step out by its sizes, which depend on
        # the length
        ys, new_ssm = rules.local(
            _scan, (dt, Bp, Cp, xcf, A),
            (("batch", None, "inner"), ("batch", None, None), ("batch", None, None),
             ("batch", None, "inner"), ("inner", None)),
            (("batch", None, "inner"), ("batch", "inner", None)))
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
        dt, Bp, Cp = _ssm_params(params, xc, D, cfg, rules, norm_eps)
        dA = torch.exp(dt[..., None] * A)
        dBx = dt[..., None] * Bp[:, None, :] * xc.float()[..., None]
        new_ssm = ssm_state * dA + dBx
        y = torch.einsum("ben,bn->be", new_ssm, Cp) + params["D"] * xc
        y = y[:, None, :]                                         # (B,1,E)
        new_conv = window[:, 1:]

    y = y.to(x.dtype) * F.silu(z)
    out_proj = layers.gathered(params["out_proj"], rules, "inner", "embed")
    out = rules.constrain(y @ out_proj, "batch", "seq", "embed_act")
    if return_state:
        return out, new_ssm, new_conv
    return out


def mamba_state_shapes(batch: int, d_model: int, cfg: SSMConfig) -> dict:
    E = cfg.expand * d_model
    return {
        "ssm": (batch, E, cfg.state_dim),
        "conv": (batch, cfg.conv_width - 1, E),
    }
