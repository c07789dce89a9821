"""CUDA graphs of the dense decode step.

A decode step of a dense decoder launches some 15 kernels a layer, each
from Python through the dispatcher; at a serving batch the host takes
longer to launch a step than the card takes to run it.  Here the step is
captured once per cache as a chain of CUDA graphs and every later step on
that cache replays the chain: 2L + 1 graph launches for L layers, and two
small launches that copy the step's tokens and ``t`` into the graphs'
static inputs.

**Where it engages** (``applies``): on a CUDA device, where every layer is
attention, with no MoE, no frontend, a local decode (no mesh) and fp32
compute and cache.  Every other model keeps the eager step:
a Mamba or xLSTM state comes back as a new tensor each step, not updated
in place; the MoE's routing record (``moe.record_routes``) keeps a
reference to each call's routes, which a replay would overwrite; the
sharded decode runs collectives; and the flash-decode kernel is fp32.

**What makes a replay right.**  The flash-decode kernel and RoPE read
``t`` from a one-element device tensor (``transformer.forward``'s
``t_device``), so the graphs hold no position.  The split count of the
flash-decode kernel, which a graph keeps, comes from t on the host
(``kernels.decode_attention.splits``, as the launch takes it), and is
part of the key.  Every pointer a graph reads is part of the key too:
the parameters' and the cache's, the batch size and the tokens' dtype.  A
step whose key differs from the graphs' runs eagerly (``transformer.forward``,
as a bypassed model does), which also warms every kernel, cuBLAS
handle and workspace the capture needs, and then captures; its logits are
the eager step's.  The key's parameters are compared by pointer: a
weight updated in place is read by the next replay.

**Piecewise at the spans.**  The chain is cut at each decode attention
call: one graph for the embedding and the first layer up to its
attention, one for each attention call (the flash-decode launch with its
merge), one for each stretch from an attention's output to the next
one's input, and one for the last layer's rest, the final norm and the
LM head.  Each attention graph replays inside an ``attn.decode`` span and
the rest inside ``model.decode_step``, where the eager step launches
them, so a profiler puts each kernel (whose correlation id is that of its
graph's launch) under the span it had.  One ``decode.graph`` span
(``GRAPH_SPAN``) holds each replayed step's launches.

**Lifetime.**  A model holds one graph set at a time.  The set holds its
cache weakly: a finalizer on every cache tensor releases the graphs and
their memory pool when the tensor dies, so a dead cache is never replayed
and a set never keeps a cache alive.  A step with another key releases
the set before it captures the next.  Graph tensors made in inference mode
are the graphs' own; the static inputs are ordinary tensors, written in
place in either mode.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.backends.base import new_stream, release_stream
from repro_torch.kernels.decode_attention import splits
from repro_torch.models import transformer
from repro_torch.spans import span

GRAPH_SPAN = "decode.graph"


def applies(cfg, rcfg, device_type: str) -> bool:
    """Whether the decode step of ``cfg`` under ``rcfg`` on a device of
    type ``device_type`` replays CUDA graphs (the module's docstring says
    why each other case keeps the eager step)."""
    return (device_type == "cuda" and all(b == "attn" for b in cfg.layer_pattern)
            and cfg.moe is None and not cfg.frontend
            and rcfg.mesh is None and rcfg.decode_attn == "local"
            and rcfg.compute_dtype == torch.float32 and rcfg.cache_dtype == torch.float32)


def _key(params, batch, cache, t: int) -> tuple:
    """What a graph set must match to serve this step; raises where ``t``
    lies outside the cache, as the kernel's wrapper does."""
    tokens, k0 = batch["tokens"], cache[0]["k"]
    S = k0.shape[1]
    if not 0 <= t < S:
        raise ValueError(f"t={t} is outside the caches' {S} positions")
    return (tuple(tokens.shape), tokens.dtype, tuple(k0.shape), splits(k0, t),
            tuple(x.data_ptr() for x in tree_lib.leaves(params)),
            tuple(c[kv].data_ptr() for c in cache for kv in ("k", "v")))


class _GraphSet:
    """The graphs of one cache: ``pieces`` (the launches outside decode
    attention, L + 1) and ``attns`` (one a layer), replayed alternately,
    their static inputs ``tokens`` and ``t_device``, and ``logits``, the
    last graph's output."""

    def __init__(self, key, tokens, t_device, pieces, attns, logits):
        self.key, self.tokens, self.t_device = key, tokens, t_device
        self.pieces, self.attns, self.logits = pieces, attns, logits
        self.finalizers: list = []

    def hold_weakly(self, cache) -> None:
        """Release the set when any tensor of ``cache`` dies."""
        self.finalizers = [weakref.finalize(c[kv], self.release)
                           for c in cache for kv in ("k", "v")]

    def replay(self, tokens: torch.Tensor, t: int) -> torch.Tensor:
        """One step: logits (B, vocab), a tensor of the caller's."""
        with span(GRAPH_SPAN):
            self.tokens.copy_(tokens)
            self.t_device.fill_(t)
            self.pieces[0].replay()
            for attn, piece in zip(self.attns, self.pieces[1:]):
                with span("attn.decode"):
                    attn.replay()
                piece.replay()
            return self.logits[:, 0].clone()

    def release(self) -> None:
        """Free the graphs and their pool; the set matches no step after."""
        for f in self.finalizers:
            f.detach()
        for g in self.pieces + self.attns:
            g.reset()
        self.finalizers = []
        self.key = self.tokens = self.t_device = self.logits = None
        self.pieces, self.attns = [], []


def _capture(cfg, rcfg, params, batch, cache, t: int, key) -> _GraphSet:
    """Capture one step on ``cache`` as a chain of graphs cut at each
    decode attention call.  Runs nothing on the card."""
    dev = cache[0]["k"].device
    with torch.inference_mode(False):
        tokens = torch.empty(batch["tokens"].shape, dtype=batch["tokens"].dtype, device=dev)
        t_device = torch.empty(1, dtype=torch.int64, device=dev)
    pool = torch.cuda.graph_pool_handle()
    pieces, attns = [], []

    def begin() -> torch.cuda.CUDAGraph:
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=pool, capture_error_mode="thread_local")
        return g

    stream = new_stream(dev)
    # cuBLAS keeps a workspace a (handle, stream), made at its first product
    # there: cleared before, the capture stream's is made inside the
    # capture, from the graphs' pool, whose graphs own it; cleared after,
    # the table holds none of the pool, so the pool goes with the graphs
    torch._C._cuda_clearCublasWorkspaces()
    try:
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            graph = begin()
            try:
                def attn_call(call):
                    nonlocal graph
                    graph.capture_end()
                    pieces.append(graph)
                    graph = begin()
                    out = call()
                    graph.capture_end()
                    attns.append(graph)
                    graph = begin()
                    return out

                logits, _, _ = transformer.forward(params, {"tokens": tokens}, cfg, rcfg,
                                                   cache=cache, t=t, t_device=t_device,
                                                   attn_call=attn_call)
                graph.capture_end()
                pieces.append(graph)
            except BaseException:
                if torch.cuda.is_current_stream_capturing():
                    graph.capture_end()
                raise
    finally:
        torch._C._cuda_clearCublasWorkspaces()
        release_stream(stream)
    return _GraphSet(key, tokens, t_device, pieces, attns, logits)


class DecodeGraphs:
    """A model's decode graphs: at most one set, and how often a step
    captured one (``captures``) and replayed one (``replays``)."""

    def __init__(self, cfg, rcfg):
        self.cfg, self.rcfg = cfg, rcfg
        self.captures = self.replays = 0
        self._set: _GraphSet | None = None

    def step(self, params, batch, cache, t: int):
        """``Model.decode_step``'s (logits (B, vocab), cache): a replay of
        the set that matches, else an eager step and a capture."""
        key = _key(params, batch, cache, t)
        s = self._set
        if s is not None and s.key == key:
            self.replays += 1
            return s.replay(batch["tokens"], t), cache
        self.release()
        logits, _, new_cache = transformer.forward(params, batch, self.cfg, self.rcfg,
                                                   cache=cache, t=t)
        self._set = _capture(self.cfg, self.rcfg, params, batch, cache, t, key)
        self._set.hold_weakly(cache)
        self.captures += 1
        return logits[:, 0], new_cache

    def release(self) -> None:
        """Free the set's graphs and memory now."""
        if self._set is not None:
            self._set.release()
            self._set = None
