"""Static cost of a workload kernel from one torch trace — the port's
counterpart of XLA's ``compiled.cost_analysis()`` and compiled HLO text.

The kernel is traced once with ``make_fx`` on fake tensors of the inputs'
shapes (nothing is computed and no device is touched) into an aten graph,
while ``torch.utils.flop_counter.FlopCounterMode`` counts its FLOPs.  The
graph's op nodes are sorted into the five classes the JAX package reads
off its HLO text with regexes (dot, elementwise, reduce, transcendental,
gather/scatter).

The numbers agree with XLA's only as far as the two graphs agree: the
FLOP counter counts products (``mm``, ``bmm``, ``mv``, ...) and no
elementwise work, so the matmul family comes within a few percent of
XLA's count and elementwise programs read 0; ``bytes_accessed`` is the sum of input and
output bytes over the non-view aten ops, which is what eager torch moves
(XLA's fused graph moves less).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils.flop_counter import FlopCounterMode

# aten op names by class, the counterparts of the HLO op names the JAX
# package matches (``features.py``: dot/convolution; add/subtract/...;
# reduce; exponential/log/...; gather/scatter/dynamic-slice)
_DOT = frozenset({"mm", "bmm", "addmm", "baddbmm", "addmv", "mv", "dot",
                  "matmul", "convolution"})
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "clamp",
    "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_xor"})
_REDUCE = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod",
                     "cumsum"})
_TRANSCENDENTAL = frozenset({"exp", "log", "pow", "tanh", "erf", "sin",
                             "cos", "rsqrt", "sqrt"})
_GATHER = frozenset({"index", "gather", "scatter", "scatter_add",
                     "scatter_add_", "index_add", "index_add_",
                     "index_select", "index_put", "index_put_"})


@dataclasses.dataclass(frozen=True)
class TraceCost:
    n_ops: int            # aten op nodes in the graph
    flops: float          # FlopCounterMode's count
    bytes_accessed: float
    n_dot: int
    n_elementwise: int
    n_reduce: int
    n_transcendental: int
    n_gather_scatter: int
    out_bytes: float      # bytes of the kernel's outputs


def _mv_flops(a_shape, x_shape, *args, out_shape=None, **kwargs) -> int:
    # matrix-vector products, which the counter's own table leaves out
    return 2 * a_shape[0] * a_shape[1]


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_nbytes(x) for x in v)
    return 0


def _node_val_bytes(args) -> int:
    total = 0
    for a in args:
        if isinstance(a, torch.fx.Node):
            total += _nbytes(a.meta.get("val"))
        elif isinstance(a, (list, tuple)):
            total += _node_val_bytes(a)
    return total


def trace_cost(kernel: Callable, chunked: dict, shared: dict) -> TraceCost:
    """Trace ``kernel(chunked, shared)`` at the shapes and dtypes of the
    numpy arrays given and read its static cost off the aten graph."""
    ck, sk = list(chunked), list(shared)

    def flat(*args):
        return kernel(dict(zip(ck, args[:len(ck)])),
                      dict(zip(sk, args[len(ck):])))

    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in [*chunked.values(), *shared.values()]]
    with FlopCounterMode(display=False,
                         custom_mapping={torch.ops.aten.mv: _mv_flops}
                         ) as counter:
        gm = make_fx(flat, tracing_mode="fake")(*args)

    counts = dict.fromkeys(("dot", "elem", "red", "trans", "gs"), 0)
    n_ops = 0
    n_bytes = 0
    out_bytes = 0
    for node in gm.graph.nodes:
        if node.op == "output":
            out_bytes = _node_val_bytes(node.args)
            continue
        if node.op != "call_function":
            continue
        n_ops += 1
        target = node.target
        name = getattr(target, "overloadpacket", target).__name__
        for key, names in (("dot", _DOT), ("elem", _ELEMENTWISE),
                           ("red", _REDUCE), ("trans", _TRANSCENDENTAL),
                           ("gs", _GATHER)):
            if name in names:
                counts[key] += 1
                break
        if not getattr(target, "is_view", False):
            n_bytes += (_node_val_bytes(node.args)
                        + _nbytes(node.meta.get("val")))
    return TraceCost(
        n_ops=n_ops, flops=float(counter.get_total_flops()),
        bytes_accessed=float(n_bytes), n_dot=counts["dot"],
        n_elementwise=counts["elem"], n_reduce=counts["red"],
        n_transcendental=counts["trans"], n_gather_scatter=counts["gs"],
        out_bytes=float(out_bytes))
