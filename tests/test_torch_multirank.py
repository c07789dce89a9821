"""The sharding layer on spawned ``gloo`` CPU ranks: the JAX package's
multi-device cases (``tests/test_multidevice.py``: sharded decode against
local decode, the elastic remesh after a failure) and the checkpoint
restored onto a mesh.

One job of 8 ranks runs the decode, layout and elastic scenarios and the
model's loss and gradients on DTensor parameters, and one of 4 ranks the
restore; each test reads its part of a job's results.  Ranks
meet through a ``FileStore`` in a fresh temporary directory, so
concurrent runs share no port.
"""
import multiprocessing as mp
import os
import tempfile
import traceback

import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

B, S, H, KV, HD = 4, 32, 4, 2, 16   # the JAX test's sharded-decode inputs
MESH = (2, 4)                        # (data, model)
DECODE_TS = (0, 7, 8, 17, 31)        # 17 as in the JAX test; the rest at slab edges
SERVE = dict(arch="yi-9b", batch=4, prompt_len=6, gen_len=10)  # decodes t = 6..15
# the JAX small-mesh dry-run's batch; yi-9b and one arch of each other block
# kind (MoE, mamba, xLSTM)
LOSS = dict(archs=("yi-9b", "grok-1-314b", "jamba-1.5-large-398b", "xlstm-350m"),
            batch=8, seq=16)
JOB_TIMEOUT = 120


def _decode_inputs():
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    return f(B, 1, H, HD), f(B, 1, KV, HD), f(B, 1, KV, HD), f(B, S, KV, HD), f(B, S, KV, HD)


def _init(rank, world, store_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, world_size=world, rank=rank)


def _run(target, world, timeout=JOB_TIMEOUT) -> dict:
    """Spawn ``world`` gloo ranks, each running ``target(rank, world)``,
    and return {rank: what it returned}; raise on any rank's failure."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    with tempfile.TemporaryDirectory() as store_dir:
        procs = [ctx.Process(target=_rank_main, args=(target, r, world, store_dir, out_q))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            results = {}
            for _ in range(world):
                rank, ok, payload = out_q.get(timeout=timeout)
                assert ok, f"rank {rank}:\n{payload}"
                results[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results


def _rank_main(target, rank, world, store_dir, out_q):
    import torch.distributed as dist

    try:
        _init(rank, world, store_dir)
        payload = target(rank, world)
        dist.barrier()
        out_q.put((rank, True, payload))
    except BaseException:  # report any failure of this rank to the parent, then exit
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The 8-rank job
# ---------------------------------------------------------------------------


def _job8(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.elastic import (build_mesh, plan_remesh,
                                            simulate_failure_and_remesh)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.attention import decode_attention_sharded
    from repro_torch.parallel.sharding_rules import (AxisRules, NamedSharding,
                                                     PartitionSpec, distribute)

    out = {}
    # -- sharded decode on a (2, 4) mesh: each rank's rows and slab ----------
    mesh = make_test_mesh(*MESH, device="cpu")
    rules = AxisRules.pod()
    act = NamedSharding(mesh, rules.spec(("batch", None, None, None)))
    cache = NamedSharding(mesh, rules.spec(("cache_batch", "cache_seq", "cache_heads", None)))
    q, kn, vn, kc, vc = _decode_inputs()
    out["coord"] = tuple(mesh.get_coordinate())
    out["decode"] = {}
    for t in DECODE_TS:
        ql, knl, vnl = (distribute(a, act).to_local() for a in (q, kn, vn))
        kcl, vcl = (distribute(a, cache).to_local().clone() for a in (kc, vc))
        o, kcl, vcl = decode_attention_sharded(ql, knl, vnl, kcl, vcl, t, mesh=mesh,
                                               dp_axes=("data",))
        out["decode"][t] = (o.numpy(), kcl.numpy(), vcl.numpy())

    # -- constrain: a replicated DTensor laid out by its logical axes --------
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    y = rules.constrain(distribute_tensor(x, mesh, [Replicate(), Replicate()]), "batch", "ff")
    out["constrained"] = ([str(p) for p in y.placements], tuple(y.to_local().shape),
                          bool(torch.equal(y.full_tensor(), x)))

    # -- a reduced model served with decode_attn="sharded" and "local" -------
    out["serve"] = _serve_both(mesh)

    # -- a reduced model's loss and gradients on DTensor parameters ----------
    out["dtensor_loss"] = _dtensor_loss_and_grads(mesh)

    # -- a dim split over two mesh dims, major to minor ----------------------
    pd = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    x = torch.arange(16 * 3).reshape(16, 3)
    out["pod_data_rows"] = distribute(
        x, NamedSharding(pd, PartitionSpec(("pod", "data"), None))).to_local()[:, 0].tolist()
    out["pod_data_coord"] = tuple(pd.get_coordinate())
    try:
        distribute(x, NamedSharding(pd, PartitionSpec(("data", "pod"), None)))
        out["transposed_raises"] = False
    except ValueError:
        out["transposed_raises"] = True

    # -- elastic: 8 ranks, lose 2 -------------------------------------------
    old = build_mesh(plan_remesh(8, prefer_model=4), device="cpu")
    host = {"w": np.arange(32.0, dtype=np.float32).reshape(8, 4),
            "blocks": [{"b": np.arange(6.0, dtype=np.float32)}]}
    axes = {"w": ("batch", "ff"), "blocks": [{"b": ("inner",)}]}
    new_mesh, tree = simulate_failure_and_remesh(host, axes, old_mesh=old, lost_devices=2,
                                                 prefer_model=4)
    out["old_shape"] = tuple(old.shape)
    out["member"] = new_mesh.get_coordinate() is not None
    out["new_shape"] = dict(zip(new_mesh.mesh_dim_names, new_mesh.shape))
    if out["member"]:
        out["w_placements"] = [str(p) for p in tree["w"].placements]
        out["w_local"] = tree["w"].to_local().numpy()
        out["w_full"] = tree["w"].full_tensor().numpy()
        out["b_full"] = tree["blocks"][0]["b"].full_tensor().numpy()
    return out


def _serve_both(mesh):
    """Greedy decode of reduced yi-9b, once sharded (this rank's batch rows
    against its model rank's cache slabs) and once local (every row against
    the whole cache): this rank's rows of the tokens and logits of each
    step."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import RunConfig
    from repro_torch.parallel.sharding_rules import AxisRules, NamedSharding, distribute

    arch, b, p_len, g_len = (SERVE[k] for k in ("arch", "batch", "prompt_len", "gen_len"))
    runs = {}
    for mode in ("local", "sharded"):
        model = build_model(arch, RunConfig(decode_attn=mode, mesh=mesh), reduced=True,
                            device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(1)
        prompts = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (b, p_len)))
        with torch.inference_mode():
            logits, filled = model.prefill(params, {"tokens": prompts})
            cache = model.decode_cache(filled, p_len + g_len)
        mine = distribute(torch.arange(b),
                          NamedSharding(mesh, AxisRules.pod().spec(("batch",)))).to_local()
        toks = logits.argmax(-1)
        if mode == "sharded":
            spec = AxisRules.pod().spec(("cache_batch", "cache_seq", "cache_heads", None))
            cache = [{k: distribute(v, NamedSharding(mesh, spec)).to_local().clone()
                      for k, v in layer.items()} for layer in cache]
            toks = toks[mine]
        steps = []
        with torch.inference_mode():
            for i in range(g_len - 1):
                step_logits, cache = model.decode_step(
                    params, {"tokens": toks[:, None]}, cache, p_len + i)
                toks = step_logits.argmax(-1)
                rows = slice(None) if mode == "sharded" else mine
                steps.append((toks[rows].numpy(), step_logits[rows].numpy()))
        runs[mode] = steps
    return runs


def _loss_inputs(arch, rcfg):
    """The reduced arch's parameters (seed 0) and a batch of LOSS's size."""
    from repro_torch.models.model_zoo import build_model

    model = build_model(arch, rcfg, reduced=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                              (LOSS["batch"], LOSS["seq"]), dtype=np.int32))
             for k in ("tokens", "labels")}
    return model, params, batch


def _dtensor_loss_and_grads(mesh):
    """{arch: (loss, every parameter's gradient as a full tensor, the
    parameters' placements)} of each of LOSS's reduced archs whose
    parameters are DTensors laid out by their logical axes under
    ``AxisRules.pod()`` (the pod path: ``attn_expand_kv``), the batch split
    over ``data``; the models' ``rules.constrain`` sites lay out the
    activations."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree as tree_lib
    from repro_torch.models.transformer import RunConfig
    from repro_torch.parallel.sharding_rules import (AxisRules, NamedSharding, distribute,
                                                     tree_shardings)

    rules = AxisRules.pod()
    rows = NamedSharding(mesh, rules.spec(("batch", None)))
    out = {}
    for arch in LOSS["archs"]:
        model, params, batch = _loss_inputs(arch, RunConfig(rules=rules, attn_expand_kv=True,
                                                            mesh=mesh))
        _, axes = model.abstract_params()
        dparams = tree_lib.map(lambda t, sh: distribute(t, sh).requires_grad_(True), params,
                               tree_shardings(axes, rules, mesh))
        dbatch = {k: distribute(v, rows) for k, v in batch.items()}
        with implicit_replication():
            loss, _ = model.loss(dparams, dbatch)
            grads = torch.autograd.grad(loss, tree_lib.leaves(dparams))
        out[arch] = (loss.full_tensor().item(), [g.full_tensor().numpy() for g in grads],
                     [str(p.placements) for p in tree_lib.leaves(dparams)])
    return out


@pytest.fixture(scope="module")
def job8():
    return _run(_job8, 8)


@pytest.mark.parametrize("t", DECODE_TS)
def test_sharded_decode_on_8_gloo_ranks_matches_jax_local_decode(job8, t):
    """``tests/test_multidevice.py:27`` on spawned ranks: each rank's rows
    of the output within 2e-5 and its cache slabs within 1e-6 of the JAX
    package's ``decode_attention_local``."""
    from repro.models.attention import decode_attention_local

    q, kn, vn, kc, vc = _decode_inputs()
    ref, kr, vr = (np.asarray(a) for a in decode_attention_local(q, kn, vn, kc, vc, t))
    b_loc, s_loc = B // MESH[0], S // MESH[1]
    for rank, res in job8.items():
        d, m = res["coord"]
        o, kg, vg = res["decode"][t]
        rows, slab = slice(d * b_loc, (d + 1) * b_loc), slice(m * s_loc, (m + 1) * s_loc)
        np.testing.assert_allclose(o, ref[rows], atol=2e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(kg, kr[rows, slab], atol=1e-6, err_msg=f"rank {rank}")
        np.testing.assert_allclose(vg, vr[rows, slab], atol=1e-6, err_msg=f"rank {rank}")


def test_model_decodes_the_same_tokens_sharded_and_local(job8):
    """``RunConfig(decode_attn="sharded")`` through ``Model.decode_step``
    on each rank's rows and cache slabs, across the slab edges (t = 6..14
    over slabs of 4), gives the local path's tokens and logits."""
    for rank, res in job8.items():
        local, sharded = res["serve"]["local"], res["serve"]["sharded"]
        assert len(local) == len(sharded) == SERVE["gen_len"] - 1
        for (tl, ll), (ts, ls) in zip(local, sharded):
            np.testing.assert_array_equal(ts, tl, err_msg=f"rank {rank}")
            np.testing.assert_allclose(ls, ll, atol=1e-5, err_msg=f"rank {rank}")


def test_constrain_redistributes_a_dtensor_by_its_logical_axes(job8):
    for rank, res in job8.items():
        assert res["constrained"] == (["S(0)", "S(1)"], (4, 3), True), rank


def test_a_dim_over_two_mesh_dims_is_split_major_to_minor(job8):
    for rank, res in job8.items():
        p, d = res["pod_data_coord"]
        first = (p * 4 + d) * 2  # ("pod", "data"): pod major, as JAX splits it
        assert res["pod_data_rows"] == [first * 3, (first + 1) * 3], rank
        assert res["transposed_raises"], rank


@pytest.mark.parametrize("arch", LOSS["archs"])
def test_dtensor_loss_and_grads_on_8_gloo_ranks_equal_the_plain_ones(job8, arch):
    """The reduced arch's loss and gradients with DTensor parameters under
    ``AxisRules.pod()`` on the (2, 4) mesh, on every rank, equal the plain
    tensors' in one process within 1e-5; the parameters really were split
    over ``model``."""
    from repro_torch import tree as tree_lib
    from repro_torch.models.transformer import RunConfig

    model, params, batch = _loss_inputs(arch, RunConfig())
    leaves = [p.requires_grad_(True) for p in tree_lib.leaves(params)]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for rank, res in job8.items():
        got_loss, got_grads, placements = res["dtensor_loss"][arch]
        assert abs(got_loss - loss.item()) <= 1e-5, rank
        assert len(got_grads) == len(grads)
        for g, w in zip(got_grads, grads):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-5, err_msg=f"rank {rank}")
        assert any("Shard" in p for p in placements), placements


def test_elastic_remesh_after_failure_on_8_gloo_ranks(job8):
    """``tests/test_multidevice.py:81`` on spawned ranks: lose 2 of 8, end
    with 6 and model in {2, 3}, the tree equal to the host tree; the ff dim
    (4) no longer divides over model 3 and is replicated."""
    host_w = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    members = sorted(r for r, res in job8.items() if res["member"])
    assert members == list(range(6))
    for rank, res in job8.items():
        assert res["old_shape"] == (2, 4)
        assert res["new_shape"]["data"] * res["new_shape"]["model"] == 6
        assert res["new_shape"]["model"] in (2, 3)
    for rank in members:
        res = job8[rank]
        np.testing.assert_array_equal(res["w_full"], host_w)
        np.testing.assert_array_equal(res["b_full"], np.arange(6.0, dtype=np.float32))
        assert res["w_placements"] == ["S(0)", "R"]
        d = rank // 3
        np.testing.assert_array_equal(res["w_local"], host_w[d * 4:(d + 1) * 4])


# ---------------------------------------------------------------------------
# The 4-rank job: a checkpoint restored onto a mesh
# ---------------------------------------------------------------------------


def _job4(rank, world):
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.parallel.sharding_rules import AxisRules, tree_shardings

    model = build_model("stablelm-3b", reduced=True, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ckpt_dir = os.path.join(os.environ["REPRO_TEST_CKPT"], "ckpt")
    if rank == 0:
        Checkpointer(ckpt_dir, async_save=False).save(3, params)
    dist.barrier()
    mesh = make_test_mesh(2, 2, device="cpu")
    _, axes = model.abstract_params()
    shardings = tree_shardings(axes, AxisRules.pod(), mesh)
    step, tree = Checkpointer(ckpt_dir).restore(shardings=shardings)
    want, got = tree_lib.leaves(params), tree_lib.leaves(tree)
    return {"step": step, "n": len(got),
            "equal": all(torch.equal(g.full_tensor(), w) for g, w in zip(got, want)),
            "wq": (str(tree["blocks"][0]["attn"]["wq"].placements),
                   tuple(tree["blocks"][0]["attn"]["wq"].to_local().shape)),
            "n_leaves": len(want)}


def test_checkpoint_restores_onto_a_mesh_across_4_gloo_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TEST_CKPT", str(tmp_path))
    results = _run(_job4, 4)
    for rank, res in results.items():
        assert res["step"] == 3 and res["n"] == res["n_leaves"] > 0, rank
        assert res["equal"], rank
        # wq (d 64, H 4, hd 16): embed over data (2), heads over model (2)
        assert res["wq"] == ("(Shard(dim=0), Shard(dim=1))", (32, 2, 16)), rank
