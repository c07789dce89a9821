"""Cost walker over an aten graph: logical FLOPs and memory traffic of a
step, the port's counterpart of the JAX package's ``roofline/jaxpr_cost.py``.

A step function is traced with ``make_fx`` on ``meta`` or fake tensors
(nothing is computed and nothing allocated) into an aten graph, and every
op node is costed by the JAX walker's conventions:

  flops: ``mm``/``bmm``/``addmm``/``baddbmm`` = 2*M*N*K*batch; convolution
  by ``_conv_flops``' rule; elementwise ops = their output size; reductions
  = their input size; ``sort``/``topk`` = n*log2(n) for each sorted row
  of n (JAX's n is the whole array's size); layout ops (views,
  ``permute``, ``cat``, slices, dtype casts, creation) free.
  bytes: every node but a view reads its inputs and writes its outputs
  once (logical traffic, the unfused upper bound).  ``bytes_fused`` keeps only what a
  fused program cannot keep in registers: the products' operands, gathers,
  scatters and indexing, in-place writes, sorts, and the kernels' inputs
  and outputs; elementwise, reduction and layout nodes move none.

The four hand-written kernels (``torch.ops.repro_torch.*``) are costed as
the JAX walker costs the same maths in the JAX model, so the roofline reads
the same work whatever implements it.  The JAX model's attention is a
blocked jnp flash attention that computes every block, masked ones too:
the forward costs 4*B*H*Sq_p*Sk_p*hd flops (Sq_p and Sk_p padded to
multiples of min(q_block, Sq) and min(kv_block, Sk)) and B*H*Sq_p*(Sk_p+nk)
transcendentals, the backward the gradient's four products,
8*B*H*Sq_p*Sk_p*hd (the kernel's recomputation of the scores is an
implementation choice, like remat).  RMSNorm costs what the JAX walker
counts for ``rmsnorm_apply``, 4n + 3r flops and r transcendentals for n
elements in r rows, and for its gradient 9n + 5r + d.  Each kernel node's
``bytes`` and ``bytes_fused`` are its inputs plus its outputs.

Loops: the JAX walker multiplies a ``scan`` body by its trip count; the
port's models loop in Python, so ``make_fx`` unrolls them, and a trace of a
whole step at a cell's length (xLSTM's time steps, mamba's chunks of
``SCAN_CHUNK``) would hold 4,096 to 32,768 step bodies a layer.
:func:`stack_cost` is the counterpart of ``scan_layers``: the stack is
composed from a few short stacks, one or two blocks deep, each block kind's
cost times its count; a block that loops over the sequence is traced at
two short lengths and extrapolated, its cost being exactly affine in its
trip count.  The JAX
walker's carry residency (a scan carry kept on chip across iterations) has
no counterpart: the port's loops carry plain tensors, and nothing is taken
off ``bytes_fused`` for them.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, Optional

import torch
from torch.fx.experimental.proxy_tensor import make_fx

# registers repro_torch::flash_attention, ... (the kernels' ops)
from repro_torch.kernels import ops as _ops  # noqa: F401


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0           # raw logical traffic (upper bound)
    transcendentals: float = 0.0
    bytes_fused: float = -1.0    # what a fused program still moves

    def __post_init__(self):
        if self.bytes_fused < 0:
            self.bytes_fused = self.bytes

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.transcendentals + o.transcendentals,
                    self.bytes_fused + o.bytes_fused)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k,
                    self.transcendentals * k, self.bytes_fused * k)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# op classes by the aten overload packet's name
_DOT = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"})
_CONV = frozenset({"convolution", "convolution_backward"})
_GATHER = frozenset({
    "index", "index_select", "gather", "scatter", "scatter_add", "scatter_reduce",
    "index_put", "index_add", "embedding", "embedding_dense_backward",
    "masked_scatter", "take", "copy_", "index_put_", "index_add_", "scatter_add_"})
_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand",
    "squeeze", "unsqueeze", "slice", "select", "cat", "stack", "split",
    "split_with_sizes", "chunk", "unbind", "clone", "contiguous", "_to_copy",
    "to", "alias", "detach", "lift_fresh_copy", "copy", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "new_zeros", "new_ones", "new_empty", "new_full", "arange",
    "scalar_tensor", "constant_pad_nd", "pad", "flip", "repeat", "as_strided",
    "slice_backward", "select_backward", "expand_copy", "view_copy",
    "permute_copy", "unsqueeze_copy", "squeeze_copy", "t_copy",
    "transpose_copy", "slice_scatter", "select_scatter", "fill", "fill_",
    "zero", "zero_", "_reshape_alias", "narrow", "diagonal", "unfold",
    "lift_fresh", "_assert_tensor_metadata", "sym_size", "sym_stride",
    "sym_numel", "_local_scalar_dense", "detach_", "resize_", "set_",
    "wait_tensor"})
_REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "cumprod", "logsumexp", "any", "all", "var", "std", "norm",
    "linalg_vector_norm", "_softmax", "_log_softmax"})
_SORT = frozenset({"sort", "topk", "argsort"})
# the aten names of the JAX walker's ``_TRANS`` primitives
_TRANS = frozenset({
    "exp", "log", "tanh", "sigmoid", "erf", "sin", "cos", "rsqrt", "sqrt",
    "pow", "erfinv", "expm1", "log1p", "exp2", "log2", "gelu", "silu",
    "softplus", "logit", "log_sigmoid_forward"})
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")

# "attention" and "norm": the kernels' registered ops
CLASSES = ("dot", "attention", "conv", "norm", "gather", "sort", "reduce", "elementwise",
           "layout", "collective")


def _numel(shape) -> float:
    return float(math.prod(int(s) for s in shape)) if len(shape) else 1.0


def _tensors(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _tensors(x)


def _vals(args):
    """The tensors that the nodes among ``args`` produce."""
    for a in args:
        if isinstance(a, torch.fx.Node):
            yield from _tensors(a.meta.get("val"))
        elif isinstance(a, (list, tuple)):
            yield from _vals(a)


def _nbytes(t: torch.Tensor) -> float:
    return _numel(t.shape) * t.element_size()


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _flash_sizes(q, k, q_block: int, kv_block: int):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qb, kb = max(min(q_block, Sq), 1), max(min(kv_block, Sk), 1)
    return B, H, hd, _ceil_to(Sq, qb), _ceil_to(Sk, kb), -(-Sk // kb)


def flash_attention_cost(q, k, q_block: int, kv_block: int, *, backward: bool) -> tuple:
    """(flops, transcendentals) of the JAX model's blocked attention, or of
    its gradient, for q (B,Sq,H,hd) against k (B,Sk,KV,hd)."""
    B, H, hd, Sq_p, Sk_p, nk = _flash_sizes(q, k, q_block, kv_block)
    if backward:
        return 8.0 * B * H * Sq_p * Sk_p * hd, 0.0
    return 4.0 * B * H * Sq_p * Sk_p * hd, float(B * H * Sq_p * (Sk_p + nk))


def rmsnorm_cost(x, *, backward: bool) -> tuple:
    """(flops, transcendentals) of the JAX ``rmsnorm_apply`` on x (..., d),
    or of its gradient, as the JAX walker counts them."""
    d = x.shape[-1]
    n = _numel(x.shape)
    r = n / d if d else 0.0
    if backward:
        return 9.0 * n + 5.0 * r + d, 0.0
    return 4.0 * n + 3.0 * r, r


def _dot_flops(name: str, args) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addmv") else (args[0], args[1])
    a, b = a.meta["val"].shape, b.meta["val"].shape
    if name in ("mm", "addmm"):
        return 2.0 * a[0] * a[1] * b[1]
    if name in ("bmm", "baddbmm"):
        return 2.0 * a[0] * a[1] * a[2] * b[2]
    if name in ("mv", "addmv"):
        return 2.0 * a[0] * a[1]
    return 2.0 * a[0]  # dot


def _conv_flops(node) -> float:
    """The JAX walker's rule: 2 * output elements * kernel elements / out
    channels (the feature groups cancel)."""
    out = node.meta["val"]
    out = out[0] if isinstance(out, (list, tuple)) else out
    w = node.args[1].meta["val"]
    return 2.0 * _numel(out.shape) * _numel(w.shape) / max(w.shape[0], 1)


def _name(target) -> tuple[str, str]:
    """(namespace, overload packet name) of a call_function target."""
    packet = getattr(target, "overloadpacket", None)
    if packet is None:
        return "", getattr(target, "__name__", str(target))
    return getattr(target, "namespace", ""), packet.__name__


def node_cost(node) -> tuple[str, Cost]:
    """(class, cost) of one ``call_function`` node."""
    if node.target is operator.getitem:  # one output of a multi-output node
        return "layout", Cost(0.0, 0.0, bytes_fused=0.0)
    ns, name = _name(node.target)
    ins = list(_vals(node.args)) + list(_vals(node.kwargs.values()))
    outs = list(_tensors(node.meta.get("val")))
    io = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
    if ns in _COLLECTIVE_NS:
        return "collective", Cost(0.0, 0.0, bytes_fused=0.0)
    if ns == "repro_torch":
        q_or_x = node.args[0].meta["val"]
        if name in ("flash_attention", "flash_attention_bwd"):
            k = node.args[1].meta["val"]
            qb, kb = node.args[-2], node.args[-1]
            fl, tr = flash_attention_cost(q_or_x, k, qb, kb,
                                          backward=name == "flash_attention_bwd")
            return "attention", Cost(fl, io, tr, bytes_fused=io)
        fl, tr = rmsnorm_cost(q_or_x, backward=name == "rmsnorm_bwd")
        return "norm", Cost(fl, io, tr, bytes_fused=io)
    if name in _DOT:
        return "dot", Cost(_dot_flops(name, node.args), io)
    if name in _CONV:
        return "conv", Cost(_conv_flops(node), io)
    if name in _GATHER:
        return "gather", Cost(0.0, io)
    if name in _SORT:
        # n log2 n for every sorted row of n (the last dim, or ``dim``)
        x = node.args[0].meta["val"]
        dim = node.args[1] if len(node.args) > 1 and isinstance(node.args[1], int) \
            else node.kwargs.get("dim", -1)
        n = float(x.shape[dim]) if x.ndim else 1.0
        return "sort", Cost(_numel(x.shape) * max(math.log2(max(n, 2.0)), 1.0), io)
    if name in _FREE or not outs:
        # a view moves nothing (a per-step slice of a sequence would
        # otherwise read the whole sequence at every step)
        return "layout", Cost(0.0, 0.0 if getattr(node.target, "is_view", False) else io,
                              bytes_fused=0.0)
    if name in _REDUCE:
        n = sum(_numel(t.shape) for t in ins)
        return "reduce", Cost(n, io, bytes_fused=0.0)
    n = max(_numel(t.shape) for t in outs)
    return "elementwise", Cost(n, io, n if name.rstrip("_") in _TRANS else 0.0,
                               bytes_fused=0.0)


def graph_cost_by_class(gm: torch.fx.GraphModule) -> dict[str, Cost]:
    """The graph's cost summed by op class (``CLASSES``)."""
    out = {c: Cost() for c in CLASSES}
    for node in gm.graph.nodes:
        if node.op == "call_function":
            cls, c = node_cost(node)
            out[cls] = out[cls] + c
    return out


def graph_cost(gm: torch.fx.GraphModule) -> Cost:
    total = Cost()
    for c in graph_cost_by_class(gm).values():
        total = total + c
    return total


def trace(fn: Callable, *args, **kwargs) -> torch.fx.GraphModule:
    """``make_fx`` of ``fn(*args, **kwargs)`` on fake tensors (``meta``
    inputs stay ``meta``): nothing is computed or allocated."""
    return make_fx(lambda *a: fn(*a, **kwargs), tracing_mode="fake")(*args)


def step_cost(fn: Callable, *args, **kwargs) -> Cost:
    """Cost of ``fn(*args)`` from one trace of the whole function, loops
    unrolled (the JAX ``step_cost``; :func:`stack_cost` composes a layer
    stack as its ``scan`` rule does)."""
    return graph_cost(trace(fn, *args, **kwargs))


# ---------------------------------------------------------------------------
# Composition: the counterpart of the scanned layer stack
# ---------------------------------------------------------------------------


def _combine(terms) -> dict:
    out: dict = {}
    for w, m in terms:
        for k, v in m.items():
            out[k] = out.get(k, 0.0) + w * v
    return out


def layer_kinds(cfg) -> list:
    """One kind per layer of ``cfg``'s stack: (block type, has an FFN, the
    FFN is MoE).  Layers of one kind cost alike."""
    from repro_torch.models.transformer import _has_ffn, _is_moe

    P = len(cfg.layer_pattern)
    return [(cfg.layer_pattern[l % P], _has_ffn(cfg, l % P), _is_moe(cfg, l % P))
            for l in range(cfg.num_layers)]


def variant(cfg, kinds: tuple):
    """``cfg`` with its stack replaced by one block of each of ``kinds``, in
    order (``()``: no block, the embedding, head and loss alone)."""
    moe = tuple(i for i, k in enumerate(kinds) if k[2]) or (len(kinds),)
    if cfg.moe is None or (kinds and all(k[2] for k in kinds) and not cfg.moe_layer_indices):
        moe = tuple(cfg.moe_layer_indices)  # the same layers: the same key for a trace memo
    return dataclasses.replace(cfg, num_layers=len(kinds),
                               layer_pattern=tuple(k[0] for k in kinds) or cfg.layer_pattern,
                               moe_layer_indices=moe)


def _looping(kind) -> bool:
    return kind[0] in ("mamba", "slstm", "mlstm")


def extrapolation_lengths(seq_len: int, batch: int, chunk: int, group: int,
                          moe: bool, group_multiple: int = 1) -> Optional[tuple[int, int]]:
    """Two short lengths L1 < L2 at which a block that loops over the
    sequence is traced: the two least multiples of ``chunk`` (the loop's
    step in positions) of at least two chunks and three positions that,
    for a block with an MoE FFN, make batch*L a multiple of the MoE group
    size and at least two groups on each of the ``group_multiple`` shards
    of the batch dim (over which the groups are split), as many on each.
    So every traced loop has the structure of the full length's: whole
    chunks, more than one (a single chunk is the whole sequence, whose
    slices are contiguous and copy nothing), a first, a middle and a last
    step (a loop of two steps has no middle one, and its liveness peaks
    elsewhere), and whole groups, more than one on each shard (one group
    is a dim of size 1, for which some ops take other paths).
    None where ``seq_len`` is not a whole number of chunks or L2 would
    exceed it."""
    if seq_len % chunk:
        return None
    found = []
    L = chunk * max(2, -(-3 // chunk))
    while L <= seq_len and len(found) < 2:
        groups, rest = divmod(batch * L, group)
        if not moe or (rest == 0 and groups >= 2 * group_multiple
                       and groups % group_multiple == 0):
            found.append(L)
        L += chunk
    return tuple(found) if len(found) == 2 else None


def loop_lengths(cfg, *, seq_len: int, batch: int, moe_group: int, group_multiple: int = 1,
                 loops: bool = True, **_) -> Optional[tuple[int, int]]:
    """The ``extrapolation_lengths`` at which :func:`stack_cost` and
    :func:`group_peak` trace ``cfg``'s blocks that loop over the sequence,
    or None where none is extrapolated (no such block, ``loops`` off, or
    ``seq_len`` too short)."""
    from repro_torch.models.mamba import SCAN_CHUNK

    kinds = {k for k in layer_kinds(cfg) if _looping(k)} if loops else set()
    if not kinds:
        return None
    chunk = SCAN_CHUNK if any(k[0] == "mamba" for k in kinds) else 1
    return extrapolation_lengths(seq_len, batch, chunk, moe_group,
                                 any(k[2] for k in kinds), group_multiple)


def _groups(cfg) -> int:
    """The stack's pattern groups (a training forward checkpoints each)."""
    return -(-cfg.num_layers // len(cfg.layer_pattern))


def stack_cost(measure: Callable[[object, int], dict], cfg, *, seq_len: int, batch: int,
               moe_group: int, group_multiple: int = 1, loops: bool = True,
               unroll: bool = False) -> dict:
    """A metric of a step over ``cfg``'s whole stack, composed from traces
    of its parts: the counterpart of the JAX walker's ``scan`` rule, for
    metrics that add up over the graph's nodes (costs, node and collective
    counts).

    ``measure(cfg_variant, L)`` traces the step for a config and a sequence
    length and returns a dict of numbers.  A reference kind r is taken from
    the stack (``layer_kinds``; one that does not loop where there is one),
    and the step is the trace of the stack [r] plus, for every other layer
    of kind k, k's marginal cost: the trace of [r, k] less that of [r].
    What every stack has once whatever its depth (the embedding, head, loss
    and optimizer, and the loss's sum of the MoE aux terms) is in [r] once.
    Each traced stack is one pattern group; the stack's other groups each
    add what a group adds beside its layers (a training forward's
    checkpoint of the group, its aux sum): two groups of [r] less one group
    of [r, r].  With ``loops`` (a prefill or training step, where the
    recurrent blocks loop over the sequence) a difference of stacks whose
    extra block is a mamba, sLSTM or mLSTM block is traced at the two
    ``extrapolation_lengths`` and extrapolated linearly to ``seq_len``,
    which is exact where every layout in the block is the same at every
    length, as the model makes it (the recurrences run on local tensors,
    ``AxisRules.local``, and the block takes and hands on its residual in
    one layout): the loop's cost is then affine in its trip count.
    ``unroll`` traces the whole step once (the dry-run's ``--no-scan``)."""
    if unroll:
        return measure(cfg, seq_len)
    kinds = layer_kinds(cfg)
    memo: dict = {}

    def m(c, L: int) -> dict:
        if (c, L) not in memo:
            memo[(c, L)] = measure(c, L)
        return memo[(c, L)]

    if not kinds:
        return m(variant(cfg, ()), seq_len)
    still = [k for k in kinds if not _looping(k)]
    r = still[0] if still else kinds[0]
    looping = {k for k in kinds if _looping(k)} if loops else set()
    lens = loop_lengths(cfg, seq_len=seq_len, batch=batch, moe_group=moe_group,
                        group_multiple=group_multiple, loops=loops)

    def delta(a, b, kind) -> dict:
        """m(b) - m(a) at seq_len, extrapolated where ``kind`` loops."""
        if kind in looping and lens is not None:
            l1, l2 = lens
            d1 = _combine([(1.0, m(b, l1)), (-1.0, m(a, l1))])
            d2 = _combine([(1.0, m(b, l2)), (-1.0, m(a, l2))])
            w = (seq_len - l1) / (l2 - l1)
            return _combine([(1.0 - w, d1), (w, d2)])
        return _combine([(1.0, m(b, seq_len)), (-1.0, m(a, seq_len))])

    one = variant(cfg, (r,))
    first = _combine([(1.0, m(variant(cfg, ()), seq_len)), (1.0, delta(variant(cfg, ()), one, r))])
    marginal = {k: delta(one, variant(cfg, (r, k)), k) for k in set(kinds)}
    terms = [(1.0, first), (-1.0, marginal[r])] + [(1.0, marginal[k]) for k in kinds]
    if _groups(cfg) > 1:
        two_groups = dataclasses.replace(one, num_layers=2)
        terms.append((_groups(cfg) - 1.0, delta(variant(cfg, (r, r)), two_groups, r)))
    return _combine(terms)


def group_peak(measure: Callable[[object, int], dict], cfg, *, seq_len: int, batch: int,
               moe_group: int, group_multiple: int = 1, loops: bool = True,
               unroll: bool = False) -> dict:
    """A metric that does not add up over the nodes (the peak live bytes),
    from traces of two and three whole pattern groups of ``cfg``,
    extrapolated linearly to its number of groups (a stack of one or two
    groups is traced whole): exact where the metric is affine in the number
    of identical groups from two on, as a step's peak is when it comes at
    the same point of the last group (the start of the backward, the head,
    a decode step's new caches).  Where the stack's blocks loop over the
    sequence, traces of one and two groups (the longest traces) at the
    ``loop_lengths`` are extrapolated linearly in the number of groups and
    in the length: exact where the peak comes at the same point of the
    loop (its first, a middle or its last step) at the traced lengths as
    at ``seq_len``.  ``unroll`` traces
    the whole step once."""
    if unroll:
        return measure(cfg, seq_len)
    P, G = len(cfg.layer_pattern), _groups(cfg)
    lens = loop_lengths(cfg, seq_len=seq_len, batch=batch, moe_group=moe_group,
                        group_multiple=group_multiple, loops=loops)
    g0 = 1 if lens is not None else 2
    lo = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, g0 * P))
    hi = dataclasses.replace(cfg, num_layers=(g0 + 1) * P)

    def at(L: int) -> dict:
        if G <= g0:
            return measure(lo, L)
        return _combine([(g0 + 1.0 - G, measure(lo, L)), (G - g0, measure(hi, L))])

    if lens is None:
        return at(seq_len)
    l1, l2 = lens
    w = (seq_len - l1) / (l2 - l1)
    return _combine([(1.0 - w, at(l1)), (w, at(l2))])


# ---------------------------------------------------------------------------
# FlopCounterMode's count and a liveness walk
# ---------------------------------------------------------------------------


def _flash_flops(q_shape, k_shape, v_shape, *args, out_shape=None, backward=False) -> float:
    """``FlopCounterMode``'s formula for the attention kernels' ops (their
    last two arguments are q_block and kv_block): the walker's products."""
    q, k = torch.empty(q_shape, device="meta"), torch.empty(k_shape, device="meta")
    return flash_attention_cost(q, k, args[-2], args[-1], backward=backward)[0]


def flop_counter_flops(gm: torch.fx.GraphModule) -> float:
    """``core/trace_cost``'s count of the graph: its nodes with products
    (the walker's dot, convolution and attention classes) are run on their
    inputs' fake values under ``FlopCounterMode`` (products only, with
    ``aten.mv``), the attention kernels' ops counted as the walker counts
    their products; every other node passes its traced value on."""
    from torch._guards import detect_fake_mode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.trace_cost import _mv_flops

    class Run(torch.fx.Interpreter):
        def run_node(self, n):
            if n.op == "call_function" and node_cost(n)[0] not in ("dot", "conv", "attention"):
                return n.meta["val"]
            return super().run_node(n)

    vals = [n.meta["val"] for n in gm.graph.nodes if n.op == "placeholder"]
    mapping = {torch.ops.aten.mv: _mv_flops,
               torch.ops.repro_torch.flash_attention: _flash_flops,
               torch.ops.repro_torch.flash_attention_bwd:
                   lambda q, k, v, *a, **kw: _flash_flops(q, k, v, *a, **kw, backward=True)}
    with detect_fake_mode(vals), FlopCounterMode(display=False,
                                                 custom_mapping=mapping) as counter:
        Run(gm).run(*vals)
    return float(counter.get_total_flops())


def peak_live_bytes(gm: torch.fx.GraphModule) -> dict:
    """A liveness walk of the graph in node order: each storage is live
    from the node that creates it to the last node that reads it or a view
    of it (the outputs' to the end).  Returns the bytes of the inputs
    (``argument``) and the peak bytes of all other storages live at once
    (``temp``): the port's estimate of ``memory_analysis``'s two sizes."""
    def storages(v):
        for t in _tensors(v):
            st = t.untyped_storage()
            yield st._cdata, float(st.nbytes())

    nodes = list(gm.graph.nodes)
    last: dict = {}
    size: dict = {}
    inputs: set = set()
    for i, node in enumerate(nodes):
        for sid, nb in storages(node.meta.get("val")):
            size.setdefault(sid, nb)
            last[sid] = i
            if node.op == "placeholder":
                inputs.add(sid)
        end = len(nodes) if node.op == "output" else i
        for a in node.all_input_nodes:
            for sid, _ in storages(a.meta.get("val")):
                last[sid] = end
    frees: dict = {}
    for sid, i in last.items():
        frees.setdefault(i, []).append(sid)
    live = peak = 0.0
    born: set = set()
    for i, node in enumerate(nodes):
        for sid, nb in storages(node.meta.get("val")):
            if sid not in born and sid not in inputs:
                born.add(sid)
                live += nb
        peak = max(peak, live)
        for sid in frees.get(i, ()):
            if sid in born:
                live -= size[sid]
    return {"argument": sum(size[s] for s in inputs), "temp": peak}
