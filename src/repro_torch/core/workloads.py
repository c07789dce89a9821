"""The streamed-benchmark suite: 39 programs mirroring the paper's Table 4
(NVIDIA SDK / AMD SDK / Parboil / POLYBENCH), as chunkable torch kernels.

Each workload is a data-parallel kernel over a leading "iteration space"
axis (the paper's outer parallel loop).  The streamed executor
(repro_torch.core.streams) splits that axis into #tasks transfer/compute
chunks and #partitions kernel sub-slices.  ``chunked`` arrays are
partitioned; ``shared`` arrays are transferred once (the paper's
buffer-validity tracking elides their re-transfer).

``make_data`` returns numpy arrays exactly as the JAX package's does (the
same ``rng`` gives byte-identical inputs); a kernel takes dicts of tensors
on one device and returns one float32 tensor.  Kernels run eagerly: the
products go to cuBLAS, the FFTs to cuFFT, everything else to PyTorch's
elementwise, scan and scatter kernels.  fp32 products stay fp32 (PyTorch's
default ``torch.backends.cuda.matmul.allow_tf32 = False``).

Like the paper's convolutionFFT2d / convolutionSeparable, the conv/fft
entries carry algorithm-dependent parameters and count as separate
programs (fftx2y2 is the third FFT aspect variant, bringing the suite to
exactly 39 programs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    suite: str
    kernel: Callable          # kernel(chunk: dict, shared: dict) -> tensor
    make_data: Callable       # make_data(scale, rng) -> (chunked, shared)
    datasets: tuple           # scale parameters (>= ~10 per workload)
    sequential_inner: bool = False
    # how per-chunk results relate to the unsplit run:
    #   concat — row-independent (result rows concatenate)
    #   sum    — chunks yield partial reductions that add up
    #   local  — chunk-local statistics (paper's generator would keep the
    #            reduction on one stream); only executability is asserted
    combine: str = "concat"


_REGISTRY: dict[str, Workload] = {}


def register(wl: Workload) -> Workload:
    assert wl.name not in _REGISTRY
    _REGISTRY[wl.name] = wl
    return wl


def get_workload(name: str) -> Workload:
    return _REGISTRY[name]


def list_workloads() -> list[str]:
    return sorted(_REGISTRY)


def _scales(lo: int, hi: int, n: int = 10) -> tuple:
    """Dataset sizes: {2^k} U {3*2^k} in [lo, hi].  Power-of-two-friendly
    sizes keep the streamed chunk shapes equal across task splits."""
    out = set()
    v = 1
    while v <= hi:
        if v >= lo:
            out.add(v)
        if lo <= 3 * v <= hi:
            out.add(3 * v)
        v *= 2
    return tuple(sorted(out))


def _f32(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# NVIDIA SDK (11 programs)
# ---------------------------------------------------------------------------

register(Workload(
    "vecadd", "nvidia",
    kernel=lambda c, s: c["a"] + c["b"],
    make_data=lambda n, rng: (
        {"a": _f32(rng, n, 256), "b": _f32(rng, n, 256)}, {}),
    datasets=_scales(256, 8192),
))

register(Workload(
    "dotprod", "nvidia",
    kernel=lambda c, s: torch.sum(c["a"] * c["b"], dim=1),
    make_data=lambda n, rng: (
        {"a": _f32(rng, n, 512), "b": _f32(rng, n, 512)}, {}),
    datasets=_scales(128, 4096),
))

register(Workload(
    "scalarprod", "nvidia",
    kernel=lambda c, s: torch.sum(c["a"] * c["b"], dim=(0, 1))[None],
    make_data=lambda n, rng: (
        {"a": _f32(rng, n, 1024), "b": _f32(rng, n, 1024)}, {}),
    datasets=_scales(128, 4096),
    combine="sum",
))

register(Workload(
    "transpose", "nvidia",
    kernel=lambda c, s: torch.swapaxes(c["x"], 1, 2) * 1.0,
    make_data=lambda n, rng: ({"x": _f32(rng, n, 64, 64)}, {}),
    datasets=_scales(32, 1024),
))

register(Workload(
    "mvmult", "nvidia",
    kernel=lambda c, s: c["A"] @ s["v"],
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 768)}, {"v": _f32(rng, 768)}),
    datasets=_scales(128, 8192),
))


def _fwt_kernel(c, s):
    x = c["x"]
    n = x.shape[-1]
    h = 1
    while h < n:
        x = x.reshape(x.shape[0], -1, 2, h)
        a = x[:, :, 0, :]
        b = x[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2).reshape(x.shape[0], n)
        h *= 2
    return x


register(Workload(
    "fwt", "nvidia",
    kernel=_fwt_kernel,
    make_data=lambda n, rng: ({"x": _f32(rng, n, 512)}, {}),
    datasets=_scales(64, 2048),
))


def _montecarlo_kernel(c, s):
    # European call payoff over per-row precomputed gaussian paths.
    S0, K, r, sig, T = 100.0, 100.0, 0.05, 0.2, 1.0
    z = c["z"]
    st = S0 * torch.exp((r - 0.5 * sig**2) * T + sig * math.sqrt(T) * z)
    payoff = torch.clamp(st - K, min=0.0)
    return math.exp(-r * T) * torch.mean(payoff, dim=1)


register(Workload(
    "montecarlo", "nvidia",
    kernel=_montecarlo_kernel,
    make_data=lambda n, rng: ({"z": _f32(rng, n, 512)}, {}),
    datasets=_scales(64, 2048),
))


def _convsep_kernel_radius(radius):
    def kern(c, s):
        img = c["img"]
        k = s["k"]
        # separable conv: rows then cols, via shift-and-add
        out = torch.zeros_like(img)
        for i in range(-radius, radius + 1):
            out = out + k[i + radius] * torch.roll(img, i, dims=2)
        out2 = torch.zeros_like(out)
        for i in range(-radius, radius + 1):
            out2 = out2 + k[i + radius] * torch.roll(out, i, dims=1)
        return out2
    return kern


register(Workload(
    "convsepr1", "nvidia",
    kernel=_convsep_kernel_radius(1),
    make_data=lambda n, rng: (
        {"img": _f32(rng, n, 64, 64)}, {"k": _f32(rng, 3)}),
    datasets=_scales(16, 512),
))

register(Workload(
    "convsepr8", "nvidia",
    kernel=_convsep_kernel_radius(8),
    make_data=lambda n, rng: (
        {"img": _f32(rng, n, 64, 64)}, {"k": _f32(rng, 17)}),
    datasets=_scales(16, 512),
))


def _fft_kernel(c, s):
    return torch.abs(torch.fft.fft2(c["img"]))


def _register_fft(name, h, w):
    register(Workload(
        name, "nvidia",
        kernel=_fft_kernel,
        make_data=lambda n, rng, h=h, w=w: ({"img": _f32(rng, n, h, w)}, {}),
        datasets=_scales(16, 512),
    ))


_register_fft("fftx1y1", 64, 64)
_register_fft("fftx4y3", 128, 32)
_register_fft("fftx2y2", 32, 128)

# ---------------------------------------------------------------------------
# AMD SDK (4 programs)
# ---------------------------------------------------------------------------


def _binomial_kernel(c, s):
    # T-step binomial option pricing per row (sequential backward induction).
    # The constants are Python floats, so every product stays float32.
    T = 48
    S0, K_, r, sig = c["S0"], 100.0, 0.05, 0.2
    dt = 1.0 / T
    u = math.exp(0.2 * math.sqrt(dt))
    d = 1.0 / u
    p = (math.exp(r * dt) - d) / (u - d)
    disc = math.exp(-r * dt)
    j = torch.arange(T + 1, dtype=torch.float32, device=S0.device)
    st = S0[:, None] * (u ** j) * (d ** (T - j))
    v = torch.clamp(st - K_, min=0.0)
    # two launches per step: the JAX kernel's disc * (p * up + (1 - p) *
    # down) with disc folded into the weights, and its zero pad dropped
    # (one node fewer per step; the pad only ever reaches nodes that no
    # longer feed node 0)
    w_up, w_down = disc * p, disc * (1 - p)
    for _ in range(T):
        v = torch.add(v[:, :-1] * w_down, v[:, 1:], alpha=w_up)
    return v[:, 0]


register(Workload(
    "binomial", "amd",
    kernel=_binomial_kernel,
    make_data=lambda n, rng: (
        {"S0": 90 + 20 * rng.random(n).astype(np.float32)}, {}),
    datasets=_scales(256, 16384),
    sequential_inner=True,
))


def _blackscholes_kernel(c, s):
    S, K, T = c["S"], c["K"], c["T"]
    r, sig = 0.05, 0.2
    d1 = (torch.log(S / K) + (r + 0.5 * sig**2) * T) / (sig * torch.sqrt(T))
    d2 = d1 - sig * torch.sqrt(T)
    cdf = lambda x: 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    call = S * cdf(d1) - K * torch.exp(-r * T) * cdf(d2)
    put = K * torch.exp(-r * T) * cdf(-d2) - S * cdf(-d1)
    return torch.stack([call, put], dim=1)


register(Workload(
    "blackscholes", "amd",
    kernel=_blackscholes_kernel,
    make_data=lambda n, rng: (
        {"S": 80 + 40 * rng.random((n, 64)).astype(np.float32),
         "K": 80 + 40 * rng.random((n, 64)).astype(np.float32),
         "T": 0.1 + rng.random((n, 64)).astype(np.float32)}, {}),
    datasets=_scales(64, 4096),
))

register(Workload(
    "dct", "amd",
    kernel=lambda c, s: torch.einsum(
        "ij,njk,lk->nil", s["D"], c["img"], s["D"]),
    make_data=lambda n, rng: (
        {"img": _f32(rng, n, 32, 32)},
        {"D": np.cos(np.pi / 32 * np.outer(
            np.arange(32) + 0.5, np.arange(32))).astype(np.float32)}),
    datasets=_scales(32, 1024, 16),
))

register(Workload(
    "prefix", "amd",
    kernel=lambda c, s: torch.cumsum(c["x"], dim=1),
    make_data=lambda n, rng: ({"x": _f32(rng, n, 2048)}, {}),
    datasets=_scales(64, 2048),
))

# ---------------------------------------------------------------------------
# Parboil (8 programs)
# ---------------------------------------------------------------------------


def _bfs_kernel(c, s):
    frontier = c["frontier"]
    A = s["adj"]
    visited = frontier
    for _ in range(4):  # fixed-depth level-synchronous expansion
        frontier = torch.clamp(frontier @ A, 0.0, 1.0) * (1.0 - visited)
        visited = torch.clamp(visited + frontier, 0.0, 1.0)
    return visited


register(Workload(
    "bfs", "parboil",
    kernel=_bfs_kernel,
    make_data=lambda n, rng: (
        {"frontier": (rng.random((n, 256)) < 0.01).astype(np.float32)},
        {"adj": (rng.random((256, 256)) < 0.02).astype(np.float32)}),
    datasets=_scales(32, 1024),
))

_LBM_W = [4 / 9] + [1 / 9] * 4 + [1 / 36] * 4
_LBM_SHIFTS = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
               (1, 1), (-1, -1), (1, -1), (-1, 1)]


def _lbm_kernel(c, s):
    f = c["f"]  # (n, 9, H, W) distribution functions
    w = torch.tensor(_LBM_W, dtype=torch.float32, device=f.device)
    rho = torch.sum(f, dim=1, keepdim=True)
    streamed = torch.stack(
        [torch.roll(f[:, i], s_, dims=(1, 2))
         for i, s_ in enumerate(_LBM_SHIFTS)], dim=1)
    feq = w[None, :, None, None] * rho
    return streamed + 0.6 * (feq - streamed)


register(Workload(
    "lbm", "parboil",
    kernel=_lbm_kernel,
    make_data=lambda n, rng: ({"f": _f32(rng, n, 9, 32, 32)}, {}),
    datasets=_scales(16, 256),
))


def _histo_kernel(c, s):
    # one 256-bin histogram per row; adding 1.0 per hit keeps the counts
    # exact in any order of the atomic adds
    x = c["x"].long()
    out = torch.zeros((x.shape[0], 256), dtype=torch.float32, device=x.device)
    return out.scatter_add_(1, x, torch.ones(x.shape, dtype=torch.float32,
                                             device=x.device))


register(Workload(
    "histo", "parboil",
    kernel=_histo_kernel,
    make_data=lambda n, rng: (
        {"x": rng.integers(0, 256, (n, 1024)).astype(np.int32)}, {}),
    datasets=_scales(32, 1024),
))


def _mriq_kernel(c, s):
    phase = 2 * math.pi * (c["x"] @ s["k"].T)  # (n, K)
    return torch.stack([torch.sum(s["phi"] * torch.cos(phase), dim=1),
                        torch.sum(s["phi"] * torch.sin(phase), dim=1)], dim=1)


register(Workload(
    "mri-q", "parboil",
    kernel=_mriq_kernel,
    make_data=lambda n, rng: (
        {"x": _f32(rng, n, 3)},
        {"k": _f32(rng, 512, 3), "phi": _f32(rng, 512)}),
    datasets=_scales(128, 8192),
))


def _mrigrid_kernel(c, s):
    # float adds in the order the atomics land: hold it to the sum tolerance
    val = c["val"]
    grid = torch.zeros((64 * 64,), dtype=torch.float32, device=val.device)
    return grid.index_add_(0, c["idx"].reshape(-1).long(),
                           val.reshape(-1))[None]


register(Workload(
    "mri-gridding", "parboil",
    kernel=_mrigrid_kernel,
    make_data=lambda n, rng: (
        {"idx": rng.integers(0, 64 * 64, (n, 64)).astype(np.int32),
         "val": _f32(rng, n, 64)}, {}),
    datasets=_scales(64, 2048),
    combine="sum",
))


def _sad_kernel(c, s):
    blocks = c["blk"]  # (n, 16, 16)
    ref = s["ref"]     # (24, 24) search window
    outs = []
    for dy in range(0, 9, 4):
        for dx in range(0, 9, 4):
            win = ref[dy:dy + 16, dx:dx + 16]
            outs.append(torch.sum(torch.abs(blocks - win), dim=(1, 2)))
    return torch.stack(outs, dim=1)


register(Workload(
    "sad", "parboil",
    kernel=_sad_kernel,
    make_data=lambda n, rng: (
        {"blk": _f32(rng, n, 16, 16)}, {"ref": _f32(rng, 24, 24)}),
    datasets=_scales(128, 8192),
))

register(Workload(
    "sgemm", "parboil",
    kernel=lambda c, s: c["A"] @ s["B"],
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 384)}, {"B": _f32(rng, 384, 384)}),
    datasets=_scales(64, 2048),
))

register(Workload(
    "spmv", "parboil",
    kernel=lambda c, s: torch.sum(c["val"] * s["v"][c["idx"].long()], dim=1),
    make_data=lambda n, rng: (
        {"val": _f32(rng, n, 64),
         "idx": rng.integers(0, 4096, (n, 64)).astype(np.int32)},
        {"v": _f32(rng, 4096)}),
    datasets=_scales(256, 16384),
))

# ---------------------------------------------------------------------------
# POLYBENCH (15 programs)
# ---------------------------------------------------------------------------

register(Workload(
    "2mm", "polybench",
    kernel=lambda c, s: 1.5 * (c["A"] @ s["B"]) @ s["C"] + 1.2 * c["D"],
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 256), "D": _f32(rng, n, 256)},
        {"B": _f32(rng, 256, 256), "C": _f32(rng, 256, 256)}),
    datasets=_scales(64, 2048),
))

register(Workload(
    "3mm", "polybench",
    kernel=lambda c, s: (c["A"] @ s["B"]) @ (s["C"] @ s["D"]),
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 256)},
        {"B": _f32(rng, 256, 256), "C": _f32(rng, 256, 256),
         "D": _f32(rng, 256, 256)}),
    datasets=_scales(64, 2048),
))


def _adi_kernel(c, s):
    u = c["u"]  # (n, H, W)
    for _ in range(2):
        u = u + 0.1 * (torch.roll(u, 1, dims=2) - 2 * u
                       + torch.roll(u, -1, dims=2))
        u = u + 0.1 * (torch.roll(u, 1, dims=1) - 2 * u
                       + torch.roll(u, -1, dims=1))
    return u


register(Workload(
    "adi", "polybench",
    kernel=_adi_kernel,
    make_data=lambda n, rng: ({"u": _f32(rng, n, 48, 48)}, {}),
    datasets=_scales(16, 512),
))


def _correlation_kernel(c, s):
    x = c["x"]  # (n, M)
    xm = x - torch.mean(x, dim=0, keepdim=True)
    sd = torch.sqrt(torch.mean(xm**2, dim=0, keepdim=True)) + 1e-6
    xn = xm / sd
    return (xn.T @ xn) / x.shape[0]


register(Workload(
    "correlation", "polybench",
    kernel=_correlation_kernel,
    make_data=lambda n, rng: ({"x": _f32(rng, n, 128)}, {}),
    datasets=_scales(256, 8192),
    combine="local",
))


def _covariance_kernel(c, s):
    xm = c["x"] - torch.mean(c["x"], dim=0, keepdim=True)
    return (xm.T @ xm) / c["x"].shape[0]


register(Workload(
    "covariance", "polybench",
    kernel=_covariance_kernel,
    make_data=lambda n, rng: ({"x": _f32(rng, n, 128)}, {}),
    datasets=_scales(256, 8192),
    combine="local",
))


def _iir_rows(x, a):
    """y[..., w] = a * y[..., w - 1] + (1 - a) * x[..., w], from y = 0."""
    y = torch.zeros_like(x[..., 0])
    ys = []
    for w in range(x.shape[-1]):
        y = a * y + (1 - a) * x[..., w]
        ys.append(y)
    return torch.stack(ys, dim=-1)


def _deriche_kernel(c, s):
    # recursive (IIR) smoothing along rows: a forward then a backward scan
    a = 0.7
    fwd = _iir_rows(c["img"], a)  # (n, H, W)
    return torch.flip(_iir_rows(torch.flip(fwd, dims=(-1,)), a), dims=(-1,))


register(Workload(
    "deriche", "polybench",
    kernel=_deriche_kernel,
    make_data=lambda n, rng: ({"img": _f32(rng, n, 32, 64)}, {}),
    datasets=_scales(16, 512),
    sequential_inner=True,
))

register(Workload(
    "gemm", "polybench",
    kernel=lambda c, s: 1.5 * c["A"] @ s["B"] + 1.2 * c["C"],
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 320), "C": _f32(rng, n, 320)},
        {"B": _f32(rng, 320, 320)}),
    datasets=_scales(64, 2048),
))


def _gemver_kernel(c, s):
    A = (c["A"] + torch.outer(c["u1"], s["v1"])
         + torch.outer(c["u2"], s["v2"]))
    x = A @ s["y"]
    return A * 1.2 + x[:, None]


register(Workload(
    "gemver", "polybench",
    kernel=_gemver_kernel,
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 256), "u1": _f32(rng, n), "u2": _f32(rng, n)},
        {"v1": _f32(rng, 256), "v2": _f32(rng, 256), "y": _f32(rng, 256)}),
    datasets=_scales(64, 2048),
))

register(Workload(
    "gesummv", "polybench",
    kernel=lambda c, s: 1.5 * (c["A"] @ s["x"]) + 1.2 * (c["B"] @ s["x"]),
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 512), "B": _f32(rng, n, 512)},
        {"x": _f32(rng, 512)}),
    datasets=_scales(128, 4096),
))


def _heat3d_kernel(c, s):
    u = c["u"]  # (n, D, H, W)
    for _ in range(2):
        lap = (torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
               + torch.roll(u, 1, 2) + torch.roll(u, -1, 2)
               + torch.roll(u, 1, 3) + torch.roll(u, -1, 3) - 6 * u)
        u = u + 0.1 * lap
    return u


register(Workload(
    "heat-3d", "polybench",
    kernel=_heat3d_kernel,
    make_data=lambda n, rng: ({"u": _f32(rng, n, 16, 16, 16)}, {}),
    datasets=_scales(16, 512),
))

register(Workload(
    "jacobi-1d", "polybench",
    kernel=lambda c, s: 0.333 * (torch.roll(c["x"], 1, 1) + c["x"]
                                 + torch.roll(c["x"], -1, 1)),
    make_data=lambda n, rng: ({"x": _f32(rng, n, 4096)}, {}),
    datasets=_scales(32, 1024),
))


def _jacobi2d_kernel(c, s):
    u = c["u"]
    for _ in range(2):
        u = 0.2 * (u + torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
                   + torch.roll(u, 1, 2) + torch.roll(u, -1, 2))
    return u


register(Workload(
    "jacobi-2d", "polybench",
    kernel=_jacobi2d_kernel,
    make_data=lambda n, rng: ({"u": _f32(rng, n, 48, 48)}, {}),
    datasets=_scales(16, 512),
))


def _mvt_kernel(c, s):
    x1 = c["A"] @ s["y1"]
    x2 = c["A"].T @ s["y2"][:c["A"].shape[0]]
    return torch.cat([x1, x2])


register(Workload(
    "mvt", "polybench",
    kernel=_mvt_kernel,
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 512)},
        {"y1": _f32(rng, 512), "y2": _f32(rng, 65536)}),
    datasets=_scales(128, 4096),
    combine="local",
))

register(Workload(
    "syrk", "polybench",
    kernel=lambda c, s: c["A"] @ s["Afull"].T,
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 256)}, {"Afull": _f32(rng, 512, 256)}),
    datasets=_scales(64, 2048),
))

register(Workload(
    "syr2k", "polybench",
    kernel=lambda c, s: c["A"] @ s["Bfull"].T + c["B"] @ s["Afull"].T,
    make_data=lambda n, rng: (
        {"A": _f32(rng, n, 256), "B": _f32(rng, n, 256)},
        {"Afull": _f32(rng, 512, 256), "Bfull": _f32(rng, 512, 256)}),
    datasets=_scales(64, 2048),
))


assert len(_REGISTRY) == 39, len(_REGISTRY)
