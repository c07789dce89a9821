"""Port optimizer, data pipeline and gradient compression against the JAX
package's: every case of ``tests/test_optim.py`` run on both packages and
compared, AdamW over several steps on a random tree, the schedules, the
synthetic batches, and the int8 all-reduce on two ``gloo`` CPU ranks."""
import multiprocessing as mp
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.optim import optimizer as jax_opt
from repro.optim.grad_compression import dequantize_int8 as jax_dequantize_int8
from repro.optim.grad_compression import quantize_int8 as jax_quantize_int8
from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import DataConfig, PrefetchFeeder, SyntheticLM
from repro_torch.optim import optimizer as opt_lib
from repro_torch.optim.grad_compression import (compressed_psum_tree,
                                                dequantize_int8, quantize_int8)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# The cases of tests/test_optim.py, on both packages
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    kw = dict(lr=0.1, warmup_steps=1, total_steps=200, weight_decay=0.0, clip_norm=0.0)
    jcfg, cfg = jax_opt.AdamWConfig(**kw), opt_lib.AdamWConfig(**kw)
    jparams = {"x": jnp.array([5.0, -3.0])}
    jstate = jax_opt.init_state(jparams, jcfg)
    params = {"x": _t([5.0, -3.0])}
    state = opt_lib.init_state(params, cfg)
    jloss = lambda p: jnp.sum(p["x"] ** 2)
    for _ in range(100):
        jparams, jstate, _ = jax_opt.apply_updates(jparams, jax.grad(jloss)(jparams),
                                                   jstate, jcfg)
        params, state, _ = opt_lib.apply_updates(params, {"x": 2 * params["x"]}, state, cfg)
    assert float(torch.sum(params["x"] ** 2)) < 1e-2
    np.testing.assert_allclose(params["x"].numpy(), np.asarray(jparams["x"]), atol=1e-6)


def test_lr_schedule_shapes():
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, schedule="cosine")
    jcfg, cfg = jax_opt.AdamWConfig(**kw), opt_lib.AdamWConfig(**kw)
    lrs = [float(opt_lib.lr_at(cfg, s)) for s in range(0, 101, 10)]
    jlrs = [float(jax_opt.lr_at(jcfg, jnp.int32(s))) for s in range(0, 101, 10)]
    np.testing.assert_allclose(lrs, jlrs, rtol=1e-6, atol=1e-9)
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6          # end of warmup
    assert lrs[-1] < 1e-3                     # decayed to ~0
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:-1], lrs[2:]))


def test_grad_clipping():
    kw = dict(lr=1e-3, clip_norm=1.0, warmup_steps=1, total_steps=10)
    jcfg, cfg = jax_opt.AdamWConfig(**kw), opt_lib.AdamWConfig(**kw)
    jp = {"x": jnp.zeros(3)}
    jp2, _, jom = jax_opt.apply_updates(jp, {"x": jnp.full(3, 1e6)},
                                        jax_opt.init_state(jp, jcfg), jcfg)
    p = {"x": torch.zeros(3)}
    _, _, om = opt_lib.apply_updates(p, {"x": torch.full((3,), 1e6)},
                                     opt_lib.init_state(p, cfg), cfg)
    assert float(om["grad_norm"]) > 1e5  # reported pre-clip
    np.testing.assert_allclose(float(om["grad_norm"]), float(jom["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(p["x"].numpy(), np.asarray(jp2["x"]), atol=1e-9)


def test_bf16_optimizer_state():
    kw = dict(warmup_steps=1, total_steps=10)
    jcfg = jax_opt.AdamWConfig(state_dtype=jnp.bfloat16, **kw)
    cfg = opt_lib.AdamWConfig(state_dtype=torch.bfloat16, **kw)
    jp = {"x": jnp.ones(4)}
    jp2, js2, _ = jax_opt.apply_updates(jp, {"x": jnp.ones(4)},
                                        jax_opt.init_state(jp, jcfg), jcfg)
    params = {"x": torch.ones(4)}
    state = opt_lib.init_state(params, cfg)
    assert state["m"]["x"].dtype == torch.bfloat16
    p2, s2, _ = opt_lib.apply_updates(params, {"x": torch.ones(4)}, state, cfg)
    assert s2["v"]["x"].dtype == torch.bfloat16
    assert bool(torch.isfinite(p2["x"]).all())
    np.testing.assert_array_equal(_np(s2["v"]["x"]), _np(js2["v"]["x"]))
    np.testing.assert_allclose(p2["x"].numpy(), np.asarray(jp2["x"]), atol=1e-6)


def test_synthetic_data_restart_determinism():
    """Batch k is identical after a simulated restart (exactly-once feed),
    and byte-identical to the JAX package's."""
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=4, seed=3)
    src = SyntheticLM(cfg)
    b5 = src.batch_at(5)
    b5_again = SyntheticLM(cfg).batch_at(5)
    np.testing.assert_array_equal(b5["tokens"], b5_again["tokens"])
    assert not np.array_equal(b5["tokens"], src.batch_at(6)["tokens"])
    jb5 = JaxSyntheticLM(JaxDataConfig(vocab_size=100, seq_len=8, global_batch=4,
                                       seed=3)).batch_at(5)
    assert b5["tokens"].tobytes() == jb5["tokens"].tobytes()


def test_prefetch_feeder_order():
    cfg = DataConfig(vocab_size=50, seq_len=4, global_batch=2, seed=0)
    feeder = PrefetchFeeder(SyntheticLM(cfg), "cpu", depth=2, start_step=10)
    try:
        for expect in (10, 11, 12):
            step, batch = feeder.next()
            assert step == expect
            assert batch["tokens"].shape == (2, 4)
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          SyntheticLM(cfg).batch_at(expect)["tokens"])
    finally:
        feeder.stop()
    assert not feeder._thread.is_alive()


def test_quantize_roundtrip_zero():
    q, s = quantize_int8(torch.zeros(8))
    assert float(torch.abs(dequantize_int8(q, s)).max()) == 0.0
    jq, js = jax_quantize_int8(jnp.zeros(8))
    assert float(jnp.abs(jax_dequantize_int8(jq, js)).max()) == 0.0


# ---------------------------------------------------------------------------
# Beyond the JAX cases
# ---------------------------------------------------------------------------


def test_prefetch_feeder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefetchFeeder(SyntheticLM(DataConfig(vocab_size=5, seq_len=2, global_batch=1)))


@pytest.mark.parametrize("frontend_dim", [0, 6])
def test_synthetic_batches_are_byte_identical_to_jax(frontend_dim):
    kw = dict(vocab_size=50304, seq_len=16, global_batch=3, seed=7,
              frontend_dim=frontend_dim)
    ours, theirs = SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(JaxDataConfig(**kw))
    for step in (0, 1, 99):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=50, schedule=schedule)
    jcfg, cfg = jax_opt.AdamWConfig(**kw), opt_lib.AdamWConfig(**kw)
    for s in range(0, 56):
        got = opt_lib.lr_at(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jax_opt.lr_at(jcfg, jnp.int32(s))),
                                   rtol=1e-6, atol=1e-12, err_msg=f"step {s}")


def _random_tree(rng):
    return {"embed": {"table": rng.standard_normal((11, 6), dtype=np.float32)},
            "blocks": {"w": rng.standard_normal((3, 6, 5), dtype=np.float32),
                       "scale": 1.0 + 0.1 * rng.standard_normal(5, dtype=np.float32)},
            "bias": rng.standard_normal(4, dtype=np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax_over_5_steps(state_dtype):
    """Params, m and v equal after 5 steps on a random tree: fp32 state
    within 1e-6; bf16 state within one bf16 rounding (2^-8 relative), the
    parameters within 1e-6."""
    rng = np.random.default_rng(0)
    tree = _random_tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0)
    jcfg = jax_opt.AdamWConfig(state_dtype=getattr(jnp, state_dtype), **kw)
    cfg = opt_lib.AdamWConfig(state_dtype=getattr(torch, state_dtype), **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jax_opt.init_state(jparams, jcfg)
    params = tree_lib.map(lambda a: torch.from_numpy(a.copy()), tree)
    state = opt_lib.init_state(params, cfg)
    for _ in range(5):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), tree)
        jparams, jstate, jom = jax_opt.apply_updates(
            jparams, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        out = opt_lib.apply_updates(params, tree_lib.map(torch.from_numpy, grads), state, cfg)
        assert out[0] is params and out[1] is state  # updated in place
        np.testing.assert_allclose(float(out[2]["grad_norm"]), float(jom["grad_norm"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 5
    rtol = 2.0 ** -8 if state_dtype == "bfloat16" else 0
    for name, got, want in (("params", params, jparams), ("m", state["m"], jstate["m"]),
                            ("v", state["v"], jstate["v"])):
        for a, b in zip(tree_lib.leaves(got), jax.tree.leaves(want)):
            if name != "params":
                assert a.dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-6,
                                       rtol=0 if name == "params" else rtol, err_msg=name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _psum_rank(rank, world, port, out_q):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        grads, error = _rank_inputs(rank)
        red, err = compressed_psum_tree(tree_lib.map(torch.from_numpy, grads),
                                        tree_lib.map(torch.from_numpy, error))
        out_q.put((rank, tree_lib.map(lambda t: t.numpy(), red),
                   tree_lib.map(lambda t: t.numpy(), err)))
    finally:
        dist.destroy_process_group()


def _rank_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    grads = {"a": rng.standard_normal((5, 3), dtype=np.float32) * (rank + 1),
             "b": [rng.standard_normal(7, dtype=np.float32)]}
    error = {"a": 0.01 * rng.standard_normal((5, 3), dtype=np.float32),
             "b": [np.zeros(7, np.float32)]}
    return grads, error


def test_compressed_psum_tree_on_two_gloo_ranks():
    """Against numpy: one shared scale (the max over ranks), the int8
    shards summed, the mean dequantized, each rank's residual kept."""
    world, port = 2, _free_port()
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_psum_rank, args=(r, world, port, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = {}
        for _ in range(world):
            rank, red, err = out_q.get(timeout=60)
            results[rank] = (red, err)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    inputs = [_rank_inputs(r) for r in range(world)]
    for path in (("a",), ("b", 0)):
        def pick(tree):
            for k in path:
                tree = tree[k]
            return tree
        g = [pick(inputs[r][0]) + pick(inputs[r][1]) for r in range(world)]
        scale = np.float32(max(np.abs(x).max() / np.float32(127.0) + np.float32(1e-12)
                               for x in g))
        q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in g]
        want = (q[0].astype(np.int32) + q[1].astype(np.int32)).astype(np.float32) * scale / world
        for r in range(world):
            red, err = results[r]
            np.testing.assert_allclose(pick(red), want, atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(pick(err), g[r] - q[r].astype(np.float32) * scale,
                                       atol=1e-6, rtol=0)


def test_quantize_matches_jax():
    x = np.random.default_rng(2).standard_normal(300).astype(np.float32) * 3
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jax_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(jax_dequantize_int8(jq, js)), rtol=1e-6)
