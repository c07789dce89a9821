"""Pod-scale dry-run: trace every (arch x shape x mesh) cell and read its
memory, cost and collective-roofline evidence, the port's counterpart of
the JAX package's ``launch/dryrun.py``.

The JAX version forces 512 host devices and lowers and compiles each cell.
Here the entry point sets up its own world: a ``fake`` process group of 256
or 512 ranks on this process (rank 0) and the production mesh over it
(``launch/mesh.make_production_mesh(device="cpu")``).  Nothing is
allocated: parameters, optimizer state, batch and cache are ``meta``
tensors, laid out by their logical axes (``tree_specs``) as DTensors over
``meta`` local shards.  Nothing compiles either, so the record has no
``compile_s``; its other keys are JAX's, with these counterparts:

- ``lower_s``: the seconds of the rank-0 DTensor traces (``make_fx`` of
  rank 0's program, its collectives as ``_c10d_functional`` nodes);
- ``jaxpr_cost_s``: the seconds of the global traces the walker reads;
- ``memory_analysis``: ``argument_size_in_bytes`` the bytes of rank 0's
  local shards of every input (JAX's ``_sharded_bytes``), and
  ``temp_size_in_bytes`` the peak bytes of everything else live at once in
  a liveness walk of rank 0's traced graph, the port's estimate
  (``temp_size_source`` says so), taken from traces of whole pattern
  groups and extrapolated to the stack (``graph_cost.group_peak``);
- ``hlo_bytes``: the number of nodes in rank 0's graph, with no node whose
  result the program never reads (composed per block like the costs: the
  nodes of the whole unrolled step);
- ``collective_bytes`` / ``collective_counts``: ``analysis.collective_bytes``
  of rank 0's graph;
- ``roofline``: compute and memory terms from the walker's global logical
  cost of the unsharded step (``graph_cost``, traced on ``meta`` tensors)
  divided by the chip count, as the JAX version divides its jaxpr cost;
  the collective term from rank 0's collectives;
- ``xla_cost_analysis``: ``{"flops": ...}``, ``core/trace_cost``'s
  ``FlopCounterMode`` count of rank 0's graph (``graph_cost.flop_counter_flops``;
  products only).

Every trace composes the layer stack from one trace per distinct block
(``graph_cost.stack_cost``), the counterpart of ``scan_layers``;
``--no-scan`` traces the whole unrolled step instead.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.configs.base import SHAPES, ArchConfig, InputShape, get_arch, list_archs
from repro_torch.core.stream_config import StreamConfig
from repro_torch.core.streams import streamify_train_step
from repro_torch.launch.mesh import dp_axes_of, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import RunConfig
from repro_torch.optim import optimizer as opt_lib
from repro_torch.parallel.sharding_rules import AxisRules, _names, placements, tree_specs
from repro_torch.roofline.analysis import HBM_BW, collective_bytes, roofline_from_traced
from repro_torch.roofline.graph_cost import (Cost, flop_counter_flops, graph_cost,
                                             graph_cost_by_class, group_peak, loop_lengths,
                                             peak_live_bytes, stack_cost)


@dataclasses.dataclass
class DryRunOptions:
    multi_pod: bool = False
    remat: str = "dots"
    fsdp: bool = True
    fsdp_over_pod: bool = False
    microbatches: int = 1
    opt_dtype: str = "f32"           # f32 | bf16
    capacity_factor: float = 1.25
    q_block: int = 1024
    kv_block: int = 1024
    moe_group: int = 512
    scan_layers: bool = True
    donate: bool = True
    dp_over_model: bool = False  # no TP: 'model' axis as extra DP

    def tag(self) -> str:
        bits = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                bits.append(f"{f.name}={v}")
        return ",".join(bits) or "baseline"


def _axis_size(mesh, name: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(name))


def build_rules(cfg: ArchConfig, shape: InputShape, mesh,
                opts: DryRunOptions) -> AxisRules:
    model_size = _axis_size(mesh, "model")
    dp_size = 1
    for a in dp_axes_of(mesh):
        dp_size *= _axis_size(mesh, a)
    rules = AxisRules.pod(
        multi_pod=opts.multi_pod,
        fsdp=opts.fsdp,
        fsdp_over_pod=opts.fsdp_over_pod,
        shard_heads=(cfg.num_heads % model_size == 0),
        shard_kv_heads=(cfg.num_kv_heads % model_size == 0),
        tp=not opts.dp_over_model,
    )
    if opts.dp_over_model:
        dp_size *= model_size
    if shape.global_batch % dp_size:
        # long_500k (B=1): batch replicated, sequence still model-sharded.
        r = dict(rules.rules)
        r["batch"] = None
        r["cache_batch"] = None
        rules = AxisRules(rules=r)
    return rules


@dataclasses.dataclass
class Cell:
    """A cell's step and its inputs: ``fn(*args)`` on trees of ``meta``
    tensors (the global, unsharded shapes), ``specs`` the PartitionSpec of
    every tensor leaf (None for a host scalar that stays a plain tensor)."""

    fn: Any
    args: tuple
    specs: tuple


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(arch: str, shape, mesh, opts: DryRunOptions, *, cfg: ArchConfig | None = None,
               seq_len: int | None = None, sharded: bool = True,
               dtype: torch.dtype = torch.bfloat16) -> Cell:
    """The cell's step and inputs.  ``shape`` is a name of ``SHAPES`` or an
    ``InputShape`` of its own (e.g. a card's batch).  ``cfg`` and
    ``seq_len`` replace the arch's config and the shape's length (the block
    traces of ``stack_cost``); ``sharded=False`` builds the unsharded step
    (null rules, local decode; ``mesh`` may be None) whose global cost the
    walker reads.  ``dtype`` is the parameters', activations' and cache's."""
    cfg = cfg or get_arch(arch)
    if isinstance(shape, str):
        shape = SHAPES[shape]
        if shape not in get_arch(arch).shapes():
            raise SystemExit(
                f"SKIP {arch} x {shape.name}: full-attention arch, 500k dense "
                f"KV cache is a non-goal (DESIGN.md §Arch-applicability)")
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    rules, dp = AxisRules.null(), ()
    if sharded:
        rules = build_rules(cfg, shape, mesh, opts)
        dp = dp_axes_of(mesh)
        dp_size = 1
        for a in dp:
            dp_size *= _axis_size(mesh, a)
        if shape.global_batch % dp_size:
            dp = ()  # batch replicated (long_500k B=1)
    rcfg = RunConfig(
        param_dtype=dtype, compute_dtype=dtype, cache_dtype=dtype, rules=rules,
        q_block=opts.q_block, kv_block=opts.kv_block,
        remat=opts.remat if shape.kind == "train" else "none",
        capacity_factor=opts.capacity_factor,
        decode_attn="sharded" if sharded else "local",
        mesh=mesh if sharded else None, dp_axes=dp,
        moe_group_size=opts.moe_group, attn_expand_kv=True,
    )
    model = Model(cfg, rcfg, device="meta")
    params, param_axes = model.abstract_params()
    pspec = tree_specs(param_axes, rules)
    batch = model.input_specs(shape)
    bspec = {k: rules.spec(("batch",) + (None,) * (v.ndim - 1)) for k, v in batch.items()}

    if shape.kind == "train":
        ocfg = opt_lib.AdamWConfig(
            state_dtype=torch.bfloat16 if opts.opt_dtype == "bf16" else torch.float32)
        opt_state = {"step": torch.zeros((), dtype=torch.int32),  # a host scalar
                     "m": tree_lib.map(lambda p: _meta(p.shape, ocfg.state_dtype), params),
                     "v": tree_lib.map(lambda p: _meta(p.shape, ocfg.state_dtype), params)}
        opt_axes = opt_lib.state_logical_axes(param_axes, ocfg)
        ospec = {"step": None, "m": tree_specs(opt_axes["m"], rules),
                 "v": tree_specs(opt_axes["v"], rules)}
        grad_fn = streamify_train_step(lambda p, b: model.loss(p, b),
                                       StreamConfig(1, opts.microbatches))

        def train_step(params, opt_state, batch):
            loss, metrics, grads = grad_fn(params, batch)
            params, opt_state, om = opt_lib.apply_updates(params, grads, opt_state, ocfg)
            return params, opt_state, loss

        return Cell(train_step, (params, opt_state, batch), (pspec, ospec, bspec))
    if shape.kind == "prefill":
        return Cell(model.forward_logits, (params, batch), (pspec, bspec))
    cache = transformer.init_cache(cfg, rcfg, shape.global_batch, shape.seq_len, device="meta")
    cspec = tree_specs(model.cache_axes(), rules)
    t = shape.seq_len - 1  # the last position: every cached key is attended

    def serve_step(params, batch, cache):
        return model.decode_step(params, batch, cache, t)

    return Cell(serve_step, (params, batch, cache), (pspec, bspec, cspec))


# ---------------------------------------------------------------------------
# Tracing: the global step on meta tensors, rank 0's DTensor program
# ---------------------------------------------------------------------------


def _zip(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and its tree of specs
    (PartitionSpecs are tuples, so the spec tree is walked by the tensor
    tree's shape)."""
    if isinstance(tree, dict):
        return {k: _zip(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def _leaves(tree) -> list:
    out: list = []
    _zip(lambda t, s: out.append(t), tree, tree)
    return out


def trace_global(cell: Cell) -> torch.fx.GraphModule:
    """``make_fx`` of the unsharded step on ``meta`` tensors."""
    from torch.fx.experimental.proxy_tensor import make_fx

    flat = _leaves(cell.args)

    def run(*leaves):
        it = iter(leaves)
        return cell.fn(*_zip(lambda t, s: next(it), cell.args, cell.args))

    return make_fx(run, tracing_mode="fake")(*flat)


def local_shards(cell: Cell, mesh) -> tuple:
    """(rank 0's local ``meta`` shard of every input leaf, their placements),
    in ``_leaves`` order; a host scalar (spec None) stays as it is."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    locs, pls = [], []

    def one(t, spec):
        if spec is None:
            locs.append(t)
            pls.append(None)
            return
        pl = placements(mesh, spec, t.shape)
        shp, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        locs.append(_meta(shp, t.dtype))
        pls.append(pl)

    _zip(one, cell.args, cell.specs)
    return locs, pls


def trace_rank0(cell: Cell, mesh) -> torch.fx.GraphModule:
    """``make_fx`` of rank 0's program: its local shards wrapped as DTensors
    inside the trace, so DTensor's redistributes are traced as collectives;
    the outputs are laid out as the inputs (parameters, state) or
    replicated (the loss), as the JAX version's ``out_shardings``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels import ops

    ops.ensure_sharding_rules()
    locs, pls = local_shards(cell, mesh)
    globals_ = _leaves(cell.args)
    replicated = [Replicate()] * mesh.ndim

    def run(*leaves):
        it = iter(zip(leaves, pls, globals_))

        def wrap(_, __):
            local, pl, g = next(it)
            if pl is None:
                return local
            return DTensor.from_local(local, mesh, pl, run_check=False, shape=g.shape,
                                      stride=g.stride())

        with implicit_replication():
            out = cell.fn(*_zip(wrap, cell.args, cell.args))

            def unwrap(x):
                if not isinstance(x, DTensor):
                    return x
                if x.ndim == 0 or any(p.is_partial() for p in x.placements):
                    x = x.redistribute(mesh, replicated)
                return x.to_local()
            return _zip(lambda x, _: unwrap(x), out, out)

    gm = make_fx(run, tracing_mode="fake")(*locs)
    _drop_unread(gm)
    return gm


def _drop_unread(gm: torch.fx.GraphModule) -> None:
    """Remove what the program never reads.  DTensor may work out an op's
    output layout by running the op on fake tensors of the global shapes
    the first time it meets the op; where it does, those runs are traced
    too: nodes whose results nothing reads, and in-place writes (an
    optimizer's ``copy_``) into a tensor made for the run that nothing else
    touches."""
    graph = gm.graph
    while True:
        dropped = graph.eliminate_dead_code()
        for n in reversed(list(graph.nodes)):
            schema = getattr(n.target, "_schema", None)
            dst = n.args[0] if n.op == "call_function" and n.args else None
            if (schema is not None and not n.users and isinstance(dst, torch.fx.Node)
                    and schema.arguments and schema.arguments[0].alias_info is not None
                    and schema.arguments[0].alias_info.is_write
                    and dst.op == "call_function" and set(dst.users) == {n}):
                graph.erase_node(n)
                dropped = True
        if not dropped:
            break
    gm.recompile()


def _sharded_bytes(cell: Cell, mesh) -> int:
    """Rank 0's bytes of every input's local shard."""
    locs, _ = local_shards(cell, mesh)
    return int(sum(t.numel() * t.element_size() for t in locs))


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------


def ensure_world(world_size: int) -> None:
    """A ``fake`` process group of ``world_size`` ranks on this process
    (rank 0), replacing an earlier ``fake`` group of another size."""
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group of "
                               f"{dist.get_world_size()} ranks is already set up")
        dist.destroy_process_group()
    # registers the "fake" backend (torch's own, for tracing at any world size)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


GROUPED_TEMP = ", extrapolated from whole pattern groups (graph_cost.group_peak)"


def _compose(shape: InputShape, opts: DryRunOptions, batch_shards: int = 1) -> dict:
    """``stack_cost``'s and ``group_peak``'s arguments for a cell whose
    batch is split ``batch_shards`` ways (rank 0's program: the MoE groups
    of a short trace must split as evenly)."""
    return dict(seq_len=shape.seq_len, batch=shape.global_batch, moe_group=opts.moe_group,
                group_multiple=batch_shards, loops=shape.kind != "decode",
                unroll=not opts.scan_layers)


def walker_cost(arch: str, shape, opts: DryRunOptions, *,
                dtype: torch.dtype = torch.bfloat16, peak: bool = True) -> dict:
    """The walker's global logical cost of a cell's unsharded step, traced
    on ``meta`` tensors and composed per block: ``{"cost": Cost, "flops_by_class":
    the FLOPs of each op class (``graph_cost.CLASSES``), "argument": bytes
    of the step's inputs, "temp": peak live bytes of everything else (None
    without ``peak``), "seconds": of the traces}``.  On one device the
    unsharded step is the program itself, and ``argument + temp`` the
    estimate of its peak memory."""
    cfg = get_arch(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    seconds = [0.0]
    memo: dict = {}

    def measure(cfg_v, L):
        if (cfg_v, L) not in memo:
            t0 = time.perf_counter()
            gm = trace_global(build_cell(arch, shape, None, opts, cfg=cfg_v, seq_len=L,
                                         sharded=False, dtype=dtype))
            seconds[0] += time.perf_counter() - t0
            m = {f"class:{k}": c.flops for k, c in graph_cost_by_class(gm).items()}
            m.update(graph_cost(gm).as_dict())
            m["temp"] = peak_live_bytes(gm)["temp"]
            memo[(cfg_v, L)] = m
        return memo[(cfg_v, L)]

    composed = stack_cost(measure, cfg, **_compose(shape, opts))
    temp = group_peak(measure, cfg, **_compose(shape, opts))["temp"] if peak else None
    cell = build_cell(arch, shape, None, opts, sharded=False, dtype=dtype)
    return {"cost": Cost(**{k: composed[k] for k in ("flops", "bytes", "transcendentals",
                                                     "bytes_fused")}),
            "flops_by_class": {k[6:]: v for k, v in composed.items() if k.startswith("class:")},
            "argument": sum(t.numel() * t.element_size() for t in _leaves(cell.args)),
            "temp": temp, "seconds": seconds[0]}


def rank0_cost(arch: str, shape, mesh, opts: DryRunOptions, *,
               cfg: ArchConfig | None = None) -> dict:
    """Rank 0's program of a cell, composed per block (``stack_cost``; whole
    under ``--no-scan``): ``{"coll:<kind>": bytes, "count:<kind>": number,
    "nodes", "flop_counter", "temp", "seconds": of the traces, "lengths":
    the two lengths recurrent blocks were traced at and extrapolated from,
    or None}``.  ``cfg`` replaces the arch's config."""
    cfg = cfg or get_arch(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    seconds = [0.0]
    memo: dict = {}

    def rank0(cfg_v, L):
        if (cfg_v, L) not in memo:
            t0 = time.perf_counter()
            gm = trace_rank0(build_cell(arch, shape, mesh, opts, cfg=cfg_v, seq_len=L), mesh)
            seconds[0] += time.perf_counter() - t0
            coll = collective_bytes(gm)
            m = {f"coll:{k}": float(v) for k, v in coll.items() if k != "counts"}
            m.update({f"count:{k}": float(v) for k, v in coll["counts"].items()})
            m["nodes"] = float(len(gm.graph.nodes))
            m["flop_counter"] = flop_counter_flops(gm)
            m["temp"] = peak_live_bytes(gm)["temp"]
            memo[(cfg_v, L)] = m
        return memo[(cfg_v, L)]

    batch_shards = 1
    for a in _names(build_rules(cfg, shape, mesh, opts).spec(("batch",))[0]):
        batch_shards *= _axis_size(mesh, a)
    r0 = stack_cost(rank0, cfg, **_compose(shape, opts, batch_shards))
    r0["temp"] = group_peak(rank0, cfg, **_compose(shape, opts, batch_shards))["temp"]
    r0["seconds"] = seconds[0]
    r0["lengths"] = None if opts.scan_layers is False else loop_lengths(
        cfg, **_compose(shape, opts, batch_shards))
    return r0


def run_cell(arch: str, shape_name: str, opts: DryRunOptions,
             *, verbose: bool = True) -> dict:
    ensure_world(512 if opts.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=opts.multi_pod, device="cpu")
    n_chips = mesh.size()
    record: dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape) + f" ({','.join(mesh.mesh_dim_names)})",
        "n_chips": int(n_chips),
        "options": opts.tag(),
    }
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    full = build_cell(arch, shape_name, mesh, opts)
    r0 = rank0_cost(arch, shape, mesh, opts)
    glob = walker_cost(arch, shape, opts, peak=False)
    jc = glob["cost"]
    record["lower_s"] = round(r0["seconds"], 2)
    record["memory_analysis"] = {
        "argument_size_in_bytes": _sharded_bytes(full, mesh),
        "temp_size_in_bytes": int(r0["temp"]),
        "temp_size_source": "liveness walk of the traced rank-0 graph (the port's estimate)"
                            + (GROUPED_TEMP if opts.scan_layers else ""),
    }
    record["hlo_bytes"] = int(r0["nodes"])
    coll = {k[5:]: int(v) for k, v in r0.items() if k.startswith("coll:")}
    record["collective_bytes"] = coll
    record["collective_counts"] = {k[6:]: int(v) for k, v in r0.items()
                                   if k.startswith("count:")}
    record["jaxpr_cost_s"] = round(glob["seconds"], 2)
    terms = roofline_from_traced(jc, n_chips=n_chips, coll=coll,
                                 model_flops=cfg.model_flops(shape))
    record["roofline"] = terms.as_dict()
    record["roofline"]["bytes_raw_per_chip"] = jc.bytes / n_chips
    record["roofline"]["memory_raw_s"] = jc.bytes / n_chips / HBM_BW
    record["roofline"]["collective_source"] = "rank-0 trace" + (
        "" if not opts.scan_layers else ", composed per block" + (
            "" if r0["lengths"] is None else
            "; recurrent blocks extrapolated from lengths %d and %d" % r0["lengths"]))
    record["xla_cost_analysis"] = {"flops": r0["flop_counter"]}
    if verbose:
        print(json.dumps(record, indent=1))
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fsdp-over-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--capacity-factor", type=float, default=1.25)
    ap.add_argument("--q-block", type=int, default=1024)
    ap.add_argument("--kv-block", type=int, default=1024)
    ap.add_argument("--moe-group", type=int, default=512)
    ap.add_argument("--no-scan", action="store_true")
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--dp-over-model", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    opts = DryRunOptions(
        multi_pod=args.multi_pod, remat=args.remat, fsdp=not args.no_fsdp,
        fsdp_over_pod=args.fsdp_over_pod, microbatches=args.microbatches,
        opt_dtype=args.opt_dtype, capacity_factor=args.capacity_factor,
        q_block=args.q_block, kv_block=args.kv_block,
        moe_group=args.moe_group, scan_layers=not args.no_scan,
        donate=not args.no_donate, dp_over_model=args.dp_over_model)

    record = run_cell(args.arch, args.shape, opts)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
