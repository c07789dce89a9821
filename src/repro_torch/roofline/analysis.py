"""Three-term roofline analysis of a traced step, the port's counterpart of
the JAX package's ``roofline/analysis.py``.

    compute term    = FLOPs_per_chip            / peak FLOP/s
    memory term     = bytes_per_chip            / HBM bytes/s
    collective term = collective_bytes_per_chip / link bytes/s

The JAX version reads its collectives from the post-SPMD HLO text with
regexes; PyTorch has no such module, so :func:`collective_bytes` walks the
``make_fx`` graph of one rank's DTensor program, in which every
redistribute is a ``_c10d_functional`` node that carries its operand's
shape.  It sums the operand bytes of each all-gather, all-reduce,
reduce-scatter, all-to-all and permute (JAX's ``collective-permute``), and
of the in-place ``c10d`` all-reduce of the sharded decode.  The port's
loops are unrolled in the trace, or composed per block
(``graph_cost.stack_cost``), so no loop multiplier is parsed.

Hardware figures: one NVIDIA H100 SXM5 at its 700 W limit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.roofline.graph_cost import Cost

# H100 SXM5 datasheet figures at 700 W, dense (no sparsity), per GPU.
HBM_BW = 3.35e12                      # HBM3, bytes/s
PEAK_FLOPS_BY_DTYPE = {
    "float32": 67e12,                 # fp32 on the CUDA cores
    "tf32": 495e12,                   # TF32 on the tensor cores
    "bfloat16": 989e12,               # bf16 on the tensor cores
}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]  # the dry-run's cells are bf16
# One 400 Gb/s NDR InfiniBand NIC per GPU, bytes/s: the production meshes
# of 256 and 512 ranks span 32 and 64 eight-GPU nodes, so their
# collectives cross nodes.
LINK_BW = 50e9
# NVLink 4 within one eight-GPU node, bytes/s per direction per GPU, for a
# mesh that fits in one node.
NVLINK_BW = 450e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op overload packet name -> JAX's collective name
_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _operand_bytes(arg) -> int:
    if isinstance(arg, torch.fx.Node):
        v = arg.meta.get("val")
        if isinstance(v, torch.Tensor):
            return v.numel() * v.element_size()
    if isinstance(arg, (list, tuple)):
        return sum(_operand_bytes(a) for a in arg)
    return 0


def collective_bytes(gm: torch.fx.GraphModule) -> dict:
    """Operand bytes of every collective node of a traced program, by JAX's
    collective names, with ``total`` and per-kind ``counts``."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        packet = getattr(node.target, "overloadpacket", None)
        if packet is None or getattr(node.target, "namespace", "") not in _NAMESPACES:
            continue
        kind = _KIND.get(packet.__name__)
        if kind is None:
            continue
        out[kind] += _operand_bytes(node.args[0])
        counts[kind] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts
    return out


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    model_flops: float = 0.0
    n_chips: int = 1
    peak_flops: float = PEAK_FLOPS  # the peak compute_s was taken at

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (global FLOPs): remat/redundancy waste."""
        total = self.flops_per_chip * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable makespan bound: the score."""
        ideal = self.model_flops / (self.n_chips * self.peak_flops)
        return ideal / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
        }


def roofline_from_traced(cost: Cost, *, n_chips: int, coll: Optional[dict] = None,
                         model_flops: float = 0.0, peak_flops: float = PEAK_FLOPS,
                         hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> RooflineTerms:
    """The three terms of a step whose global logical cost is ``cost``
    (``graph_cost``), split evenly over ``n_chips``, and whose rank-0
    program moves ``coll`` (``collective_bytes``) over the links: the
    counterpart of ``roofline_from_compiled``."""
    flops = cost.flops / n_chips
    byts = cost.bytes_fused / n_chips
    coll_total = float((coll or {}).get("total", 0.0))
    return RooflineTerms(
        compute_s=flops / peak_flops,
        memory_s=byts / hbm_bw,
        collective_s=coll_total / link_bw,
        flops_per_chip=flops,
        bytes_per_chip=byts,
        coll_bytes_per_chip=coll_total,
        model_flops=model_flops,
        n_chips=n_chips,
        peak_flops=peak_flops,
    )
