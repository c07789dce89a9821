"""The port's sharding layer against the JAX package's: the logical axes,
shapes and dtypes of every parameter of the ten archs at full size (no
allocation on either side), the cache axes, the optimizer-state axes, the
input specs of every cell, ``AxisRules`` under every combination of its
options, ``tree_specs``, ``plan_remesh``, ``rank_by_roofline``, and the
production meshes under the ``fake`` process group (256 and 512 ranks, in a
child process)."""
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.core.autotuner import MeshCandidate as JaxMeshCandidate
from repro.core.autotuner import rank_by_roofline as jax_rank_by_roofline
from repro.launch.elastic import plan_remesh as jax_plan_remesh
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim import optimizer as jax_opt
from repro.parallel.sharding_rules import AxisRules as JaxAxisRules
from repro.parallel.sharding_rules import tree_specs as jax_tree_specs
from repro_torch.configs.base import SHAPES, list_archs
from repro_torch.core.autotuner import MeshCandidate, rank_by_roofline
from repro_torch.launch.elastic import plan_remesh
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import layers
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import optimizer as opt_lib
from repro_torch.parallel.sharding_rules import (AxisRules, PartitionSpec,
                                                 tree_specs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_archs()
POD_OPTIONS = ("multi_pod", "fsdp", "fsdp_over_pod", "shard_heads", "shard_kv_heads",
               "seq_shard_attn", "tp")
LOGICAL_NAMES = sorted(JaxAxisRules.pod().rules) + ["not-a-rule"]


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(a is None or isinstance(a, str) for a in v)


def _unstack(jtree: dict, n_layers: int, leaf) -> list:
    """The JAX package's blocks (``pos{i}`` stacked over repeats) as the
    port's list of layers, ``leaf`` applied to each stacked leaf."""
    P = len(jtree)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return leaf(t)

    return [walk(jtree[f"pos{l % P}"]) for l in range(n_layers)]


def _strip_layers(axes: tuple) -> tuple:
    assert axes[0] == "layers", axes
    return axes[1:]


def _jax_axes_as_port(jtree: dict, n_layers: int) -> dict:
    out = {k: v for k, v in jtree.items() if k != "blocks"}
    out["blocks"] = _unstack(jtree["blocks"], n_layers, _strip_layers)
    return out


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


@pytest.fixture(scope="module")
def jax_abstract():
    """``Model.abstract_params()`` of every arch on the JAX side (~3 s)."""
    return {arch: jax_build_model(arch).abstract_params() for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_shapes_and_dtypes_equal_the_jax_packages(arch, jax_abstract):
    model = build_model(arch, device="cpu")
    shapes, axes = model.abstract_params()
    jshapes, jaxes = jax_abstract[arch]
    L = model.cfg.num_layers
    assert axes == _jax_axes_as_port(jaxes, L)
    R = model.cfg.num_pattern_repeats
    want = {k: v for k, v in jshapes.items() if k != "blocks"}

    def unstacked(s):
        assert s.shape[0] == R
        return jax.ShapeDtypeStruct(s.shape[1:], s.dtype)

    want["blocks"] = _unstack(jshapes["blocks"], L, unstacked)
    got = list(_leaves_with_paths(shapes))
    exp = list(_leaves_with_paths(want))
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, t), (_, s) in zip(got, exp):
        assert t.device.type == "meta", path  # nothing allocated
        assert tuple(t.shape) == tuple(s.shape), path
        assert str(t.dtype).split(".")[1] == jnp.dtype(s.dtype).name, path
    # the axes tree has the parameter tree's structure, a name per dim
    assert [p for p, _ in _leaves_with_paths(axes)] == [p for p, _ in got]
    for (path, a), (_, t) in zip(_leaves_with_paths(axes), got):
        assert _is_axes(a) and len(a) == t.ndim, path


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_optimizer_state_axes_equal_the_jax_packages(arch, jax_abstract):
    model = build_model(arch, device="cpu")
    jmodel = jax_build_model(arch)
    L = model.cfg.num_layers
    assert model.cache_axes() == _unstack(jmodel.cache_axes(), L, _strip_layers)
    _, axes = model.abstract_params()
    _, jaxes = jax_abstract[arch]
    got = opt_lib.state_logical_axes(axes, opt_lib.AdamWConfig())
    want = jax_opt.state_logical_axes(jaxes, jax_opt.AdamWConfig())
    assert got["step"] == want["step"] == ()
    for k in ("m", "v"):
        assert got[k] == _jax_axes_as_port(want[k], L)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_jax_packages_for_every_cell(arch):
    model = build_model(arch, device="cpu")
    jmodel = jax_build_model(arch)
    cells = model.cfg.shapes()
    assert [s.name for s in cells] == [s.name for s in jmodel.cfg.shapes()]
    for shape in cells:
        got = model.input_specs(SHAPES[shape.name])
        want = jmodel.input_specs(JAX_SHAPES[shape.name])
        assert sorted(got) == sorted(want), shape.name
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape, (shape.name, k)
            assert str(got[k].dtype).split(".")[1] == jnp.dtype(want[k].dtype).name


def test_init_params_and_its_axes_come_from_the_same_init_sites():
    """Each initialiser checks its axes against its shape, so a site whose
    axes do not name every dim fails at once, with either generator."""
    with pytest.raises(ValueError, match="do not match"):
        layers.dense_init(layers.AXES, (4, 8), ("embed",))
    with pytest.raises(ValueError, match="do not match"):
        layers.zeros_init(torch.Generator(), (4,), ("embed", None))
    assert layers.dense_init(layers.AXES, (4, 8), ("embed", "ff")) == ("embed", "ff")
    model = build_model("jamba-1.5-large-398b", reduced=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, axes = model.abstract_params()
    for (path, a), (ppath, t) in zip(_leaves_with_paths(axes), _leaves_with_paths(params)):
        assert path == ppath and len(a) == t.ndim


# ---------------------------------------------------------------------------
# AxisRules, tree_specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", list(itertools.product((False, True), repeat=7)),
                         ids=lambda f: "".join("1" if b else "0" for b in f))
def test_pod_rules_spec_equals_jaxs_for_every_logical_name(flags):
    kw = dict(zip(POD_OPTIONS, flags))
    rules, jrules = AxisRules.pod(**kw), JaxAxisRules.pod(**kw)
    assert rules.enabled and jrules.enabled
    for name in LOGICAL_NAMES + [None]:
        assert rules.axes(name) == jrules.axes(name), name
        for axes in ((name,), (name, None), ("embed", name, "heads")):
            got, want = rules.spec(axes), jrules.spec(axes)
            assert isinstance(got, PartitionSpec)
            assert tuple(got) == tuple(want), (name, axes)


def test_null_rules_and_partition_spec_entries_match_jaxs():
    from jax.sharding import PartitionSpec as JaxP
    assert not AxisRules.null().enabled and AxisRules.null().rules == {}
    assert tuple(AxisRules.null().spec(("batch", "embed"))) == (None, None)
    for entries in [(), (None,), ("data",), (("data",),), ((),), (("pod", "data"), None),
                    ("model", ("pod", "data", "model"))]:
        assert tuple(PartitionSpec(*entries)) == tuple(JaxP(*entries)), entries


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_on_a_reduced_model_equal_jaxs(arch):
    model = build_model(arch, reduced=True, device="cpu")
    jmodel = jax_build_model(arch, reduced=True)
    _, axes = model.abstract_params()
    _, jaxes = jmodel.abstract_params()
    L = model.cfg.num_layers
    for kw in ({}, {"multi_pod": True, "fsdp_over_pod": True}, {"tp": False}):
        specs = tree_specs(axes, AxisRules.pod(**kw))
        jspecs = jax_tree_specs(jaxes, JaxAxisRules.pod(**kw))
        want = {k: v for k, v in jspecs.items() if k != "blocks"}
        want["blocks"] = _unstack(jspecs["blocks"], L, lambda s: tuple(s)[1:])
        assert _map(tuple, specs) == _map(tuple, want), kw
    nulls = tree_specs(axes, AxisRules.null())
    assert all(all(e is None for e in s) for _, s in _leaves_with_paths(nulls))


def test_constrain_leaves_plain_tensors_and_disabled_rules_alone():
    x = torch.ones(2, 3)
    assert AxisRules.null().constrain(x, "batch") is x  # disabled: no check at all
    assert AxisRules.pod().constrain(x, "batch", "embed_act") is x
    with pytest.raises(ValueError, match="logical axes"):
        AxisRules.pod().constrain(x, "batch")


# ---------------------------------------------------------------------------
# Elastic planning, candidate ranking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefer_model", [1, 2, 4, 8, 16])
def test_plan_remesh_equals_jaxs(prefer_model):
    for n in range(1, 65):
        got = plan_remesh(n, prefer_model=prefer_model)
        want = jax_plan_remesh(n, prefer_model=prefer_model)
        assert (got.data, got.model, got.size) == (want.data, want.model, want.size), n
        assert got.size == n


@pytest.mark.parametrize("seed", range(5))
def test_rank_by_roofline_equals_jaxs(seed):
    rng = np.random.default_rng(seed)
    shapes = [(d, 256 // d, mb) for d in (1, 2, 4, 8, 16, 32, 64, 128, 256) for mb in (1, 2, 4)]
    cands = [MeshCandidate(*s) for s in shapes]
    jcands = [JaxMeshCandidate(*s) for s in shapes]
    vals = rng.exponential(1.0, (len(shapes), 3))
    terms = {c: dict(zip(("compute", "memory", "collective"), map(float, v)))
             for c, v in zip(cands, vals)}
    jterms = {c: dict(zip(("compute", "memory", "collective"), map(float, v)))
              for c, v in zip(jcands, vals)}
    got = [(c.data, c.model, c.microbatches) for c in rank_by_roofline(cands, terms)]
    want = [(c.data, c.model, c.microbatches) for c in jax_rank_by_roofline(jcands, jterms)]
    assert got == want
    for c, jc in zip(cands, jcands):
        assert c.stream_config.as_tuple() == jc.stream_config.as_tuple()


# ---------------------------------------------------------------------------
# Meshes under the fake process group
# ---------------------------------------------------------------------------

_FAKE_MESH = r"""
import sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import dp_axes_of, make_production_mesh
from repro_torch.parallel.sharding_rules import AxisRules, NamedSharding, distribute
import torch
world, rank, multi_pod = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "1"
dist.init_process_group("fake", store=FakeStore(), world_size=world, rank=rank)
mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
print("shape", tuple(mesh.shape), "names", mesh.mesh_dim_names,
      "dp", dp_axes_of(mesh), "coord", tuple(mesh.get_coordinate()))
# a (64, 32) tensor laid out by ("batch", "ff") under the pod rules: the
# first row and the first column this rank holds, and how many of each
rules = AxisRules.pod(multi_pod=multi_pod)
x = torch.arange(64 * 32).reshape(64, 32)
d = distribute(x, NamedSharding(mesh, rules.spec(("batch", "ff"))))
loc = d.to_local()
print("placements", [str(p) for p in d.placements])
print("block", int(loc[0, 0]) // 32, int(loc[0, 0]) % 32, tuple(loc.shape))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("world,multi_pod,rank", [(256, False, 37), (512, True, 300)])
def test_production_mesh_under_the_fake_process_group(world, multi_pod, rank):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _FAKE_MESH, str(world), str(rank),
                        "1" if multi_pod else "0"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    if multi_pod:
        coord = (rank // 256, rank // 16 % 16, rank % 16)
        assert f"shape (2, 16, 16) names ('pod', 'data', 'model') dp ('pod', 'data') " \
               f"coord {coord}" in out
        assert "placements ['S(0)', 'S(0)', 'S(1)']" in out
        # the batch over (pod, data), pod major: 32 blocks of 2 rows
        row = (coord[0] * 16 + coord[1]) * 2
        assert f"block {row} {coord[2] * 2} (2, 2)" in out
    else:
        coord = (rank // 16, rank % 16)
        assert f"shape (16, 16) names ('data', 'model') dp ('data',) coord {coord}" in out
        assert "placements ['S(0)', 'S(1)']" in out
        assert f"block {coord[0] * 4} {coord[1] * 2} (4, 2)" in out


def test_meshes_default_to_the_card():
    """Without CUDA a mesh on the default device raises rather than
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_test_mesh(1, 1)
