"""The two analytical baselines the paper compares against (§5.2).

Both need per-program coefficients fitted from small empirical probes — the
same probes our feature extractor already measures (transfer time, compute
time vs. data size).

Liu et al. [12]: linear models  T_t = alpha*m + beta,  T_c = eta*m + gamma;
kernel-dominated total  T = alpha*m + N*gamma/m + N*eta + beta  minimized at
m* = sqrt(N*gamma/alpha)  ->  n = N/m*.  Transfer-dominated programs get
m = N/2 (2 tasks).  #partitions := #tasks (as the paper does on XeonPhi).

Werkhoven et al. [10]: LogGP transfer model; the optimal #tasks solves
  B_dh*G_dh + g*(Ns-1) = max(T_kernel/Ns + B_dh/Ns*G_dh,
                             B_hd/Ns*G_hd + T_kernel/Ns).
We solve it numerically by evaluating the predicted makespan over the
candidate Ns grid and taking the argmin — equivalent and robust.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.stream_config import StreamConfig


@dataclasses.dataclass
class ProgramProbe:
    """Per-program empirical probe (seconds / bytes)."""

    n_rows: int
    bytes_h2d: float
    bytes_d2h: float
    t_transfer: float   # H2D time of the full input
    t_kernel: float     # single-stream kernel time
    t_overhead: float = 20e-6  # per-dispatch overhead (beta / g / o)


def liu_config(probe: ProgramProbe, max_tasks: int = 64) -> StreamConfig:
    N = float(probe.n_rows)
    alpha = probe.t_transfer / max(probe.bytes_h2d, 1.0)   # s/byte
    beta = probe.t_overhead
    eta = probe.t_kernel / N                               # s/row
    gamma = probe.t_overhead                               # per-task kernel setup

    if probe.t_kernel >= probe.t_transfer:
        # kernel-dominated: m* = sqrt(N*gamma/alpha_rows)
        alpha_rows = probe.t_transfer / N
        m_star = math.sqrt(N * gamma / max(alpha_rows, 1e-12))
        n = N / max(m_star, 1.0)
    else:
        # transfer-dominated: optimal m = N/2 -> 2 tasks
        n = 2.0
    n = int(np.clip(round(n), 1, max_tasks))
    return StreamConfig(partitions=n, tasks=n)


def werkhoven_config(probe: ProgramProbe, max_tasks: int = 64) -> StreamConfig:
    """Evaluate the LogGP makespan for each Ns and take the argmin."""
    g = probe.t_overhead
    Gdh = probe.t_transfer / max(probe.bytes_h2d, 1.0)  # s/byte (symmetric)
    Ghd = Gdh
    Bdh, Bhd = probe.bytes_d2h, probe.bytes_h2d
    Tk = probe.t_kernel

    best_ns, best_t = 1, float("inf")
    ns = 1
    while ns <= max_tasks:
        if Bdh > Bhd:
            rhs = Tk / ns + (Bdh / ns) * Gdh
        else:
            rhs = (Bhd / ns) * Ghd + Tk / ns
        makespan = max(Bdh * Gdh + g * (ns - 1), rhs) + Bhd * Ghd / ns
        if makespan < best_t:
            best_ns, best_t = ns, makespan
        ns *= 2
    return StreamConfig(partitions=best_ns, tasks=best_ns)


def probe_from_features(feats: dict) -> ProgramProbe:
    """Build a probe from the raw feature dict (features.RAW_FEATURE_NAMES)."""
    return ProgramProbe(
        n_rows=int(feats["loop_count"]),
        bytes_h2d=float(feats["dts"]),
        bytes_d2h=float(feats["out_bytes"]),
        t_transfer=float(feats["t_transfer_us"]) * 1e-6,
        t_kernel=float(feats["t_compute_us"]) * 1e-6,
    )
