"""The port's roofline (``repro_torch.roofline``) against the JAX package's
``tests/test_roofline.py`` and its walker.

Every case of ``tests/test_roofline.py`` has its counterpart: the walker's
dot, loop and gradient counts, ``RooflineTerms``, ``Cost`` arithmetic, and
the collective counter, which here reads a DTensor program traced under
torch's ``fake`` process group (a child process) where the JAX test parses
HLO text.  ``_loop_trip_count`` has no counterpart (the port's loops unroll
in the trace); in its place the composed cost of a stack (one trace per
block kind, recurrent blocks extrapolated from two short lengths) must equal
the fully unrolled trace exactly.  Then the walker on the same reduced
models as the JAX walker: the products' FLOPs equal to 1e-6 wherever the
JAX model's maths has the port's, and the totals within [0.5, 2.0], the
band of ``test_roofline.py``'s walker-against-XLA test.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.models.layers import rmsnorm_apply as jax_rmsnorm_apply
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.transformer import RunConfig as JaxRunConfig
from repro.roofline.jaxpr_cost import _dot_flops, _sub_jaxprs
from repro.roofline.jaxpr_cost import step_cost as jax_step_cost
from repro_torch import tree as tree_lib
from repro_torch.configs.base import list_archs
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import RunConfig
from repro_torch.roofline.analysis import PEAK_FLOPS_BY_DTYPE, RooflineTerms, roofline_from_traced
from repro_torch.roofline.graph_cost import (Cost, graph_cost, graph_cost_by_class,
                                             stack_cost, step_cost, trace)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# The cases of tests/test_roofline.py
# ---------------------------------------------------------------------------


def test_walker_dot_flops():
    c = step_cost(lambda a, b: a @ b, _meta(32, 64), _meta(64, 16))
    assert c.flops == 2 * 32 * 64 * 16
    assert c.bytes == (32 * 64 + 64 * 16 + 32 * 16) * 4


def test_walker_python_loop_multiplies():
    """The JAX test's 7-trip ``scan``: the port's loops are Python loops,
    which the trace unrolls."""
    def f(x):
        for _ in range(7):
            x = x @ x
        return x
    assert step_cost(f, _meta(16, 16)).flops == 7 * 2 * 16 ** 3


def test_walker_grad_includes_backward():
    def loss(w, x):
        return torch.sum((x @ w) ** 2)
    w = torch.empty(8, 4, device="meta", requires_grad=True)
    x = _meta(16, 8)
    fwd = step_cost(loss, w, x)
    both = step_cost(lambda w, x: torch.autograd.grad(loss(w, x), w)[0], w, x)
    assert both.flops >= 1.8 * fwd.flops


def test_roofline_terms_dominant():
    t = RooflineTerms(compute_s=1.0, memory_s=0.5, collective_s=2.0,
                      flops_per_chip=1, bytes_per_chip=1,
                      coll_bytes_per_chip=1, model_flops=197e12 * 256,
                      n_chips=256)
    assert t.dominant == "collective"
    assert t.bound_s == 2.0
    assert 0 < t.roofline_fraction <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roofline_fraction_reads_the_peak_the_terms_were_taken_at(dtype):
    """A compute-bound step whose FLOPs are all useful scores 1 at the peak
    its compute term was taken at, whatever that peak."""
    peak = PEAK_FLOPS_BY_DTYPE[dtype]
    t = roofline_from_traced(Cost(flops=2 * peak, bytes=1.0), n_chips=2,
                             model_flops=2 * peak, peak_flops=peak)
    assert t.compute_s == 1.0 and t.dominant == "compute"
    assert t.roofline_fraction == pytest.approx(1.0, rel=1e-12)


def test_cost_addition():
    a = Cost(1.0, 2.0, 0.0) + Cost(3.0, 4.0, 1.0) * 2
    assert a.flops == 7.0 and a.bytes == 10.0


# The counterpart of the JAX test's FAKE_HLO: an all-gather of an f32[32,4]
# operand once, and an all-reduce of an f32[16,8] operand inside a 12-trip
# loop, each a DTensor redistribute of rank 0's program under the fake group.
_COLLECTIVES = r"""
import json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.fx.experimental.proxy_tensor import make_fx
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline.analysis import collective_bytes

dist.init_process_group("fake", store=FakeStore(), world_size=4, rank=0)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))

def program(p0, p1):
    g = DTensor.from_local(p1, mesh, [Shard(0)], run_check=False)
    g = g.redistribute(mesh, [Replicate()])
    x = p0
    for _ in range(12):
        x = DTensor.from_local(x, mesh, [Partial()], run_check=False)
        x = x.redistribute(mesh, [Replicate()]).to_local() * 0.5
    return x, g.to_local()

gm = make_fx(program, tracing_mode="fake")(torch.empty(16, 8, device="meta"),
                                           torch.empty(32, 4, device="meta"))
print(json.dumps(collective_bytes(gm)))
dist.destroy_process_group()
"""


def test_collective_counter_on_a_dtensor_program():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    # all-reduce inside a 12-trip loop: 16*8*4 bytes * 12
    assert res["all-reduce"] == 16 * 8 * 4 * 12
    assert res["counts"]["all-reduce"] == 12
    # all-gather once: operand f32[32,4]
    assert res["all-gather"] == 32 * 4 * 4
    assert res["counts"]["all-gather"] == 1
    assert res["total"] == res["all-reduce"] + res["all-gather"]


# ---------------------------------------------------------------------------
# The composed cost equals the unrolled trace
# ---------------------------------------------------------------------------


def _port_inputs(arch, rcfg, batch, seq):
    m = build_model(arch, rcfg, reduced=True, device="meta")
    params, _ = m.abstract_params()
    b = {"tokens": _meta(batch, seq, dtype=torch.int32),
         "labels": _meta(batch, seq, dtype=torch.int32)}
    if m.cfg.frontend:
        b["embeds"] = _meta(batch, seq, m.cfg.frontend_dim)
    return m, params, b


def _port_fn(m, mode):
    if mode == "prefill":
        return lambda p, b: m.forward_logits(p, b)
    return lambda p, b: torch.autograd.grad(m.loss(p, b)[0], tree_lib.leaves(p))


def _port_trace(m, params, b, mode):
    if mode != "prefill":
        params = tree_lib.map(lambda t: t.requires_grad_(True), params)
    return trace(_port_fn(m, mode), params, b)


# (arch, mode, batch, sequence length): jamba's mamba blocks loop over
# chunks of 64 positions and its MoE groups are 512 tokens, so 8 x 256
# extrapolates from 8 x 128 and 8 x 192 (two chunks and two groups at
# least), and 8 x 192 interpolates between the same two; xlstm's cells loop
# over every position (2 and 3 to 32)
COMPOSED = [("yi-9b", "prefill", 2, 16), ("yi-9b", "loss+grad", 2, 16),
            ("grok-1-314b", "prefill", 2, 16), ("grok-1-314b", "loss+grad", 2, 16),
            ("jamba-1.5-large-398b", "prefill", 8, 256),
            ("jamba-1.5-large-398b", "loss+grad", 8, 192),
            ("xlstm-350m", "prefill", 2, 32), ("xlstm-350m", "loss+grad", 2, 32)]


@pytest.mark.parametrize("arch,mode,batch,seq", COMPOSED)
def test_composed_cost_equals_the_unrolled_trace(arch, mode, batch, seq):
    rcfg = RunConfig()
    m, params, b = _port_inputs(arch, rcfg, batch, seq)

    def measure(cfg_v, L):
        mv = build_model(arch, rcfg, reduced=True, device="meta")
        mv.cfg = cfg_v
        pv, _ = mv.abstract_params()
        bv = {k: _meta(*v.shape[:1], L, *v.shape[2:], dtype=v.dtype) for k, v in b.items()}
        return graph_cost(_port_trace(mv, pv, bv, mode)).as_dict()

    composed = stack_cost(measure, m.cfg, seq_len=seq, batch=batch,
                          moe_group=rcfg.moe_group_size)
    unrolled = graph_cost(_port_trace(m, params, b, mode)).as_dict()
    assert composed == unrolled


# ---------------------------------------------------------------------------
# Against the JAX walker on the same reduced models
# ---------------------------------------------------------------------------


def _jax_dot_flops(jaxpr) -> float:
    """The JAX walker's products alone: ``_dot_flops`` over every
    ``dot_general``, a ``scan`` body times its trip count."""
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            total += _dot_flops(eqn)
        elif prim == "scan":
            total += eqn.params["length"] * _jax_dot_flops(eqn.params["jaxpr"].jaxpr)
        else:
            for sub in _sub_jaxprs(eqn.params):
                total += _jax_dot_flops(sub)
    return total


@functools.lru_cache(maxsize=None)
def _both(arch, mode, seq=S):
    """(JAX jaxpr, JAX step cost, the port's graph) of ``mode`` for the
    reduced arch at B x seq; traced once for this module's tests."""
    jm = jax_build_model(arch, JaxRunConfig(), reduced=True)
    psds, _ = jm.abstract_params()
    batch = {"tokens": jax.ShapeDtypeStruct((B, seq), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, seq), jnp.int32)}
    if jm.cfg.frontend:
        batch["embeds"] = jax.ShapeDtypeStruct((B, seq, jm.cfg.frontend_dim), jnp.float32)
    if mode == "forward":
        jf = lambda p, b: jm.forward_logits(p, b)
    else:
        jf = jax.grad(lambda p, b: jm.loss(p, b)[0])
    m, params, b = _port_inputs(arch, RunConfig(), B, seq)
    gm = _port_trace(m, params, b, "prefill" if mode == "forward" else mode)
    return jax.make_jaxpr(jf)(psds, batch).jaxpr, jax_step_cost(jf, psds, batch), gm


@pytest.mark.parametrize("mode", ["forward", "loss+grad"])
@pytest.mark.parametrize("arch", [a for a in list_archs() if a != "xlstm-350m"])
def test_products_equal_the_jax_walkers(arch, mode):
    """Every arch but xLSTM (whose gradient has its own test below): the
    port's products (matrix products and the flash kernels, costed as the
    JAX model's blocked attention) are the JAX walker's ``dot_general``
    FLOPs; mamba's convolution is no product on either side."""
    jaxpr, _, gm = _both(arch, mode)
    by_class = graph_cost_by_class(gm)
    ours = by_class["dot"].flops + by_class["attention"].flops
    want = _jax_dot_flops(jaxpr)
    assert abs(ours - want) <= 1e-6 * want, (ours, want)


def test_xlstm_gradient_products_differ_from_jaxs_by_the_initial_state():
    """The one difference in products: JAX transposes its scan body at
    every step, the first included, so it also takes the cotangent of the
    zero initial state (at least sLSTM's dh0 = drh R^T, 2 B H dh 4dh
    FLOPs); the port's autograd differentiates no state that needs no
    gradient.  So the difference is one step's, whatever the length, and
    the forwards are equal."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch("xlstm-350m").reduced()
    dh = cfg.d_model // cfg.num_heads
    diffs = []
    for seq in (S, 2 * S):
        jaxpr, _, gm = _both("xlstm-350m", "loss+grad", seq)
        by_class = graph_cost_by_class(gm)
        diffs.append(_jax_dot_flops(jaxpr) - by_class["dot"].flops - by_class["attention"].flops)
    jaxpr, _, gm = _both("xlstm-350m", "forward")
    assert _jax_dot_flops(jaxpr) == graph_cost_by_class(gm)["dot"].flops
    assert diffs[0] == diffs[1] >= 2 * B * cfg.num_heads * dh * 4 * dh, diffs


@pytest.mark.parametrize("arch", list_archs())
def test_totals_within_the_band_of_the_jax_walker(arch):
    for mode in ("forward", "loss+grad"):
        _, jc, gm = _both(arch, mode)
        ours = graph_cost(gm)
        assert 0.5 < ours.flops / jc.flops < 2.0, (mode, ours.flops, jc.flops)


@pytest.mark.parametrize("rows,d", [(4, 64), (8, 64), (4, 128), (12, 96)])
def test_rmsnorm_kernel_costs_what_the_jax_walker_counts(rows, d):
    x = jax.ShapeDtypeStruct((rows, d), jnp.float32)
    p = {"scale": jax.ShapeDtypeStruct((d,), jnp.float32)}
    f = lambda p, x: jax_rmsnorm_apply(p, x)

    def vjp(p, x, dy):
        return jax.vjp(f, p, x)[1](dy)

    fwd = jax_step_cost(f, p, x)
    bwd_flops = jax_step_cost(vjp, p, x, x).flops - fwd.flops
    xt = torch.empty(rows, d, device="meta", requires_grad=True)
    st = torch.empty(d, device="meta", requires_grad=True)
    from repro_torch.kernels import ops

    gm = trace(lambda x, s: torch.autograd.grad(ops.rmsnorm(x, s).sum(), (x, s)), xt, st)
    norm = [n for n in gm.graph.nodes if "repro_torch" in str(n.target)]
    assert [str(n.target) for n in norm] == ["repro_torch.rmsnorm.default",
                                            "repro_torch.rmsnorm_bwd.default"]
    from repro_torch.roofline.graph_cost import node_cost

    (_, c_fwd), (_, c_bwd) = node_cost(norm[0]), node_cost(norm[1])
    assert (c_fwd.flops, c_fwd.transcendentals) == (fwd.flops, fwd.transcendentals)
    assert c_bwd.flops == bwd_flops
    # the kernel reads its inputs and writes its outputs once
    assert c_fwd.bytes_fused == (2 * rows * d + d) * 4
