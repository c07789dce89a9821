"""The decode step's weight products on Hopper: the wrapper of
``csrc/decode_proj.cu``.

The kernel replaces no Pallas kernel: the JAX package leaves its products to
XLA (``jnp.einsum`` in ``models/transformer.py`` and ``models/layers.py``),
and the port leaves them to cuBLAS (``@``) wherever this kernel does not take
them (``kernels.ops.takes_decode_proj``).  It was added because at a decode
batch (a few rows against a large weight) cuBLAS's fp32 SGEMM streams the
weights at under half of HBM's rate.  CUDA C++ for ``sm_90a``, built by
``kernels._build`` at first use and called through ctypes on PyTorch's
current stream; see the source's header for its design and bound.

A weight is taken as the matrix its contiguous storage holds: ``(K, N)``,
where its leading dims multiply to ``K``, x's last dim (``wq`` (d, h, k) is
``(d, h*k)``, ``wo`` (h, k, d) is ``(h*k, d)``), or ``(N, K)`` where
``transposed`` (the LM head's table, ``x @ table.T``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._build import I64, INT, PTR, Entry, aligned

# The most rows a launch takes: the kernel's four 8-row tiles, and still
# past the crossover with cuBLAS's fp32 SGEMM.  At 32 rows on an H100 80GB
# HBM3 (700 W, graph replays; PERF.md, the kernel table) it took 348 us of a yi-9b
# layer's four launches against cuBLAS's 443, and its head 0.42 ms against
# 0.71; only a layer's last MLP product (K 6,912-11,008, N 2,560-4,096) ran
# 1-10% slower than cuBLAS there.  More rows would need more tiles.
MAX_ROWS = 32
COLS = 128        # output columns a block (the source's kCols)
GATED_COLS = 64   # columns of each gated weight a block (kGatedCols)
BK = 32           # k a stage (kBK)
MAX_SPLIT = 8     # blocks a cluster (kMaxSplit)

_FWD = Entry("decode_proj", "decode_proj_fwd", [PTR] * 7 + [INT] * 8 + [PTR])
_CLUSTERS = Entry("decode_proj", "decode_proj_clusters", [INT] * 4, I64)
_FIT: dict = {}  # (device, row tiles, transposed, gated, split) -> clusters held at once
_PLANS: dict = {}  # (device, rows, K, Ns, transposed, gated) -> launch_plan's


def matrix_cols(w: torch.Tensor, K: int, transposed: bool = False):
    """N of ``w`` taken as a ``(K, N)`` matrix (its leading dims multiply to
    K, one dim at least left) or, where ``transposed``, as a 2-D ``(N, K)``
    one; None where it is neither."""
    if transposed:
        return w.shape[0] if w.dim() == 2 and w.shape[1] == K else None
    lead = 1
    for i in range(w.dim() - 1):
        lead *= w.shape[i]
        if lead == K:
            return math.prod(w.shape[i + 1:])
    return None


def plan_split(tiles: int, k_tiles: int, fit) -> int:
    """Blocks a cluster, each a run of k (1 to ``MAX_SPLIT``, at most the
    k-tiles there are): the split whose launch takes the fewest rounds of
    stages, ``ceil(tiles / fit(split))`` waves of clusters (``fit(split)``
    clusters of ``split`` blocks held at once) of ``ceil(k_tiles / split)``
    stages each; the smaller split where two tie.  On an H100 at 32 rows it
    picked the fastest split, or one within 10% of it, at every product of
    yi-9b's and stablelm-3b's decode steps (PERF.md)."""
    def rounds(split):
        held = fit(split)
        return -(-tiles // held) * -(-k_tiles // split) if held > 0 else float("inf")

    return min(range(1, min(MAX_SPLIT, k_tiles) + 1), key=lambda s: (rounds(s), s))


def clusters_fit(index: int, rows: int, transposed: bool, gated: bool, split: int) -> int:
    """Clusters of ``split`` blocks that device ``index`` holds at once for
    a launch of ``rows`` rows: asked of the CUDA occupancy calculator once
    a device and launch form."""
    key = (index, -(-rows // 8), transposed, gated, split)
    n = _FIT.get(key)
    if n is None:
        with torch.cuda.device(index):
            n = _CLUSTERS(rows, int(transposed), int(gated), split)
        if n < 0:
            raise RuntimeError(f"decode_proj occupancy query failed: "
                               f"{_CLUSTERS._message(-n).decode()} ({-n})")
        n = _FIT[key] = int(n)
    return n


def launch_plan(index: int, rows: int, K: int, ns, transposed: bool, gated: bool):
    """(column tiles, blocks a cluster) of a launch on device ``index``,
    planned once a launch form."""
    key = (index, rows, K, tuple(ns), transposed, gated)
    plan = _PLANS.get(key)
    if plan is None:
        tiles = -(-ns[0] // GATED_COLS) if gated else sum(-(-n // COLS) for n in ns)
        plan = _PLANS[key] = (tiles, plan_split(
            tiles, -(-K // BK), lambda s: clusters_fit(index, rows, transposed, gated, s)))
    return plan


def _check(x: torch.Tensor, ws: tuple, transposed: bool, gated: bool) -> list[int]:
    """Raise on anything the kernel does not take; returns each weight's N.
    The device last, so that every other refusal shows on CPU tensors too."""
    if not 1 <= len(ws) <= 3 or (gated and (len(ws) != 2 or transposed)):
        raise ValueError(f"want 1-3 weights, or w_in and w_gate (K, N) where gated; got "
                         f"{len(ws)}{' gated' if gated else ''}"
                         f"{' transposed' if transposed else ''}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"want x (..., K); got {tuple(x.shape)}")
    K = x.shape[-1]
    rows = x.numel() // K
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"x has {rows} rows; the kernel takes 1 to {MAX_ROWS}")
    ns = [matrix_cols(w, K, transposed) for w in ws]
    if any(n is None for n in ns):
        want = "(N, K)" if transposed else "(K, N) (leading dims multiplying to K)"
        raise ValueError(f"want each weight {want} for x (..., K={K}); got "
                         f"{', '.join(str(tuple(w.shape)) for w in ws)}")
    if gated and ws[0].shape != ws[1].shape:
        raise ValueError(f"want w_in and w_gate of one shape; got {tuple(ws[0].shape)}, "
                         f"{tuple(ws[1].shape)}")
    if any(t.dtype != torch.float32 for t in (x, *ws)):
        raise TypeError(f"want x and the weights fp32; got "
                        f"{', '.join(str(t.dtype) for t in (x, *ws))}")
    if K % 4 or any(n < 1 or n % 4 for n in ns):
        raise ValueError(f"want K and every N a positive multiple of 4; got K={K}, N={ns}")
    if not all(t.is_contiguous() for t in (x, *ws)):
        raise ValueError("x and the weights must be contiguous")
    if x.device.type != "cuda" or any(w.device != x.device for w in ws):
        raise ValueError(f"want x and the weights on one CUDA device; got "
                         f"{', '.join(str(t.device) for t in (x, *ws))}")
    if any(w.data_ptr() % 16 for w in ws):
        raise ValueError("the weights must start on a 16-byte boundary")
    return ns


def decode_proj_cuda(x: torch.Tensor, *ws: torch.Tensor, transposed: bool = False,
                     gated: bool = False) -> tuple:
    """``x @ w`` for each weight (1-3, one launch), by the hand-written
    kernel, each (..., N) for x (..., K) of at most ``MAX_ROWS`` rows; where
    ``transposed``, ``x @ w.T`` for w (N, K); where ``gated``, for
    ``ws = (w_in, w_gate)``, the one output ``silu(x @ w_gate) * (x @ w_in)``.
    Raises on anything it cannot launch."""
    ns = _check(x, ws, transposed, gated)
    K = x.shape[-1]
    x = aligned(x)
    lead = x.shape[:-1]
    outs = [torch.empty((*lead, n), dtype=torch.float32, device=x.device)
            for n in ns[:1 if gated else 3]]
    index, rows = x.device.index, x.numel() // K
    _, split = launch_plan(index, rows, K, ns, transposed, gated)
    ptr = lambda seq, i: seq[i].data_ptr() if i < len(seq) else None
    _FWD.launch(index, x.data_ptr(), ptr(ws, 0), ptr(ws, 1), ptr(ws, 2),
                ptr(outs, 0), ptr(outs, 1), ptr(outs, 2), rows, K,
                ns[0], 0 if gated or len(ns) < 2 else ns[1], 0 if len(ns) < 3 else ns[2],
                int(transposed), int(gated), split)
    return tuple(outs)
