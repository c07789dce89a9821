"""Gradients of the port (plain versions on the CPU) against the JAX package.

The plain backward versions of both kernels (``kernels.ref``, written from
the formulas) are held against ``jax.vjp`` of the JAX package's oracles;
the autograd Functions of ``kernels.ops`` against ``torch.autograd`` of
the plain forwards; and the gradient of ``Model.loss`` against JAX's
``value_and_grad`` with the JAX parameters carried over by
``params_from_jax``.  Inputs are made with numpy from a seed.  The CUDA
backward kernels are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances.  A kernel gradient passes when its max abs error is at most
``tol * max(1, max |reference|)``: the forward tolerances of
``tests/test_kernels.py`` (2e-5 / 1e-5 fp32, 2e-2 bf16), scaled by the
gradient's size, since a gradient sums over a sequence or a row.  Model
gradients: every leaf within atol 1e-5 and the loss within 1e-5, the
tolerance of ``tests/test_models_smoke.py:106`` for remat.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core.stream_config import StreamConfig as JaxStreamConfig
from repro.core.streams import streamify_train_step as jax_streamify_train_step
from repro.kernels import ref as jax_ref
from repro.models.model_zoo import Model as JaxModel
from repro.models.transformer import RunConfig as JaxRunConfig
from repro_torch import tree as tree_lib
from repro_torch.configs.base import get_arch
from repro_torch.core.stream_config import StreamConfig
from repro_torch.core.streams import streamify_train_step
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import RunConfig
from repro_torch.weights import params_from_jax

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_ATOL = 1e-5
B, S = 2, 16


def _both(a: np.ndarray, dtype: str):
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# The plain backward versions against jax.vjp of the JAX oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,d", [(5 * 7, 64), (3, 2560), (4, 100), (2, 8192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_ref_matches_jax_vjp(rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = rng.standard_normal((rows, d), dtype=np.float32)
    s = rng.standard_normal((d,), dtype=np.float32)
    dy = rng.standard_normal((rows, d), dtype=np.float32)
    (xt, xj), (st, sj), (dyt, dyj) = _both(x, dtype), _both(s, dtype), _both(dy, dtype)
    _, vjp = jax.vjp(lambda a, b: jax_ref.rmsnorm_ref(a, b), xj, sj)
    want_dx, want_ds = vjp(dyj)
    dx, ds = ref.rmsnorm_bwd_ref(xt, st, dyt)
    assert dx.dtype == xt.dtype and ds.dtype == st.dtype
    _assert_close(dx, want_dx, NORM_TOL[dtype], "dx")
    _assert_close(ds, want_ds, NORM_TOL[dtype], "dscale")


# every head dim of a kernel instance; GQA with G = 4 at an odd Sq, and MHA
ATTN_CASES = [(2, 17, 8, 2, hd) for hd in HEAD_DIMS] + [(1, 33, 4, 4, 80)]


@pytest.mark.parametrize("shape", ATTN_CASES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_ref_matches_jax_vjp(shape, dtype):
    Bq, Sq, H, KV, hd = shape
    rng = np.random.default_rng(hd)
    arrs = [rng.standard_normal(sh, dtype=np.float32) for sh in
            ((Bq, Sq, H, hd), (Bq, Sq, KV, hd), (Bq, Sq, KV, hd), (Bq, Sq, H, hd))]
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (_both(a, dtype) for a in arrs)
    oj, vjp = jax.vjp(lambda a, b, c: jax_ref.flash_attention_ref(a, b, c, causal=True),
                      qj, kj, vj)
    want = vjp(doj)
    o = ref.flash_attention_ref(qt, kt, vt)
    lse = ref.flash_attention_lse_ref(qt, kt)
    _assert_close(o, oj, ATTN_TOL[dtype], "o")
    got = ref.flash_attention_bwd_ref(qt, kt, vt, o, lse, dot)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (qt, kt, vt)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _assert_close(g, w, ATTN_TOL[dtype], name)


def test_flash_attention_lse_ref_is_the_logsumexp_of_the_masked_scores():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 9, 4, 16), dtype=np.float32)
    k = rng.standard_normal((1, 9, 2, 16), dtype=np.float32)
    s = np.einsum("bqkgh,bskh->bkgqs", q.reshape(1, 9, 2, 2, 16), k) / 4.0
    s = np.where(np.tril(np.ones((9, 9), bool)), s, -np.inf)
    want = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1)).reshape(1, 4, 9)
    got = ref.flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The autograd Functions on the CPU against autograd of the plain forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_matches_autograd_of_the_plain_forward(dtype, causal):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(sh, generator=g).to(dtype) for sh in
               ((2, 13, 8, 32), (2, 13, 2, 32), (2, 13, 2, 32)))
    do = torch.randn(2, 13, 8, 32, generator=g).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    out.backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*plain, causal=causal).backward(do)
    tol = ATTN_TOL[str(dtype).split(".")[1]]
    for a, b in zip(leaves, plain):
        assert a.grad.dtype == dtype
        _assert_close(a.grad, b.grad, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_matches_autograd_of_the_plain_forward(dtype):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 48, generator=g).to(dtype).requires_grad_()
    s = torch.randn(48, generator=g).requires_grad_()  # fp32 scale, as the models keep it
    dy = torch.randn(3, 5, 48, generator=g).to(dtype)
    ops.rmsnorm(x, s).backward(dy)
    x2, s2 = x.detach().clone().requires_grad_(), s.detach().clone().requires_grad_()
    ref.rmsnorm_ref(x2, s2).backward(dy)
    tol = NORM_TOL[str(dtype).split(".")[1]]
    assert x.grad.dtype == dtype and s.grad.dtype == torch.float32
    _assert_close(x.grad, x2.grad, tol)
    _assert_close(s.grad, s2.grad, tol)


def test_functions_are_used_only_where_a_gradient_is_wanted():
    x, s = torch.randn(2, 8), torch.ones(8, requires_grad=True)
    assert ops.rmsnorm(x, s).grad_fn is not None
    with torch.no_grad():
        assert ops.rmsnorm(x, s).grad_fn is None
    assert ops.rmsnorm(x, s.detach()).grad_fn is None
    q = torch.randn(1, 4, 2, 16)
    assert ops.flash_attention(q, q[:, :, :1], q[:, :, :1]).grad_fn is None
    assert ops.flash_attention(q.requires_grad_(), q[:, :, :1], q[:, :, :1]).grad_fn \
        is not None


# ---------------------------------------------------------------------------
# Gradients of Model.loss against JAX's value_and_grad
# ---------------------------------------------------------------------------

# (arch, MoE capacity factor, KV heads): the attention archs, jamba (mamba,
# MoE and attention), xlstm (sLSTM, mLSTM), grok (MoE at the default
# capacity, which drops tokens) and pixtral (the frontend).  Every reduced
# config has as many KV heads as query heads, so yi-9b also runs over 2 KV
# heads (G = 2): the GQA folding of the attention gradient.
GRAD_ARCHS = [("yi-9b", None, None), ("yi-9b", None, 2), ("stablelm-3b", None, None),
              ("jamba-1.5-large-398b", 1.25, None), ("xlstm-350m", None, None),
              ("grok-1-314b", 1.25, None), ("pixtral-12b", None, None)]


def _reduced(get, arch, kv):
    cfg = get(arch).reduced()
    return cfg if kv is None else dataclasses.replace(cfg, num_kv_heads=kv)


@functools.lru_cache(maxsize=None)
def _jax_setup(arch, cf, kv=None):
    cfg = _reduced(jax_get_arch, arch, kv)
    jm = JaxModel(cfg, JaxRunConfig() if cf is None else JaxRunConfig(capacity_factor=cf))
    jparams, _ = jm.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jax.device_get(jparams))
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend:
        batch["embeds"] = rng.standard_normal((B, S, cfg.frontend_dim), dtype=np.float32)
    return jm, jparams, np_params, batch


def _port_model(arch, cf, kv=None, **kw):
    rcfg = RunConfig(**kw) if cf is None else RunConfig(capacity_factor=cf, **kw)
    return Model(_reduced(get_arch, arch, kv), rcfg, device="cpu")


def _port_grads(model, np_params, batch):
    params = params_from_jax(np_params)
    for p in tree_lib.leaves(params):
        p.requires_grad_(True)
    loss, aux = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.detach(), aux, tree_lib.map(lambda p: p.grad, params)


@pytest.mark.parametrize("arch,cf,kv", GRAD_ARCHS,
                         ids=[a + (f"-kv{kv}" if kv else "") for a, _, kv in GRAD_ARCHS])
def test_loss_gradients_match_jax(arch, cf, kv):
    jm, jparams, np_params, batch = _jax_setup(arch, cf, kv)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True))(jparams)
    loss, aux, grads = _port_grads(_port_model(arch, cf, kv), np_params, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5, (float(loss), float(jloss))
    assert abs(float(aux["moe_aux"].detach()) - float(jaux["moe_aux"])) <= 1e-5
    want = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jgrads)))
    got_leaves, want_leaves = tree_lib.leaves(grads), tree_lib.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        assert g is not None, i
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(arch, remat):
    _, _, np_params, batch = _jax_setup(arch, 1.25 if arch.startswith("jamba") else None)
    cf = 1.25 if arch.startswith("jamba") else None
    l0, _, g0 = _port_grads(_port_model(arch, cf), np_params, batch)
    l1, _, g1 = _port_grads(_port_model(arch, cf, remat=remat), np_params, batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree_lib.leaves(g0), tree_lib.leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("remat,forwards", [("none", 1), ("full", 2), ("dots", 2)])
def test_remat_runs_the_kernels_again_in_the_backward(monkeypatch, remat, forwards):
    """Under remat each layer's forward kernels run twice per step (forward
    and recompute): what the card's launch counts follow."""
    calls = {"flash_attention": 0, "rmsnorm": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "flash_attention_ref",
                        counting("flash_attention", ops.flash_attention_ref))
    monkeypatch.setattr(ops, "rmsnorm_ref", counting("rmsnorm", ops.rmsnorm_ref))
    _, _, np_params, batch = _jax_setup("yi-9b", None)
    model = _port_model("yi-9b", None, remat=remat)
    _port_grads(model, np_params, batch)
    L = model.cfg.num_layers
    assert calls == {"flash_attention": forwards * L, "rmsnorm": forwards * 2 * L + 1}


def test_streamify_train_step_with_4_microbatches_matches_the_full_batch():
    jm, jparams, np_params, _ = _jax_setup("yi-9b", None)
    rng = np.random.default_rng(11)
    vocab = jm.cfg.vocab_size
    batch = {"tokens": rng.integers(0, vocab, (8, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (8, S)).astype(np.int32)}
    model = _port_model("yi-9b", None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    results = []
    for tasks in (1, 4):
        params = params_from_jax(np_params)
        step = streamify_train_step(lambda p, b: model.loss(p, b), StreamConfig(1, tasks))
        loss, metrics, grads = step(params, tb)
        assert set(metrics) == {"ce", "moe_aux"}
        assert all(p.grad is None for p in tree_lib.leaves(params))  # handed back
        results.append((loss, grads))
    (l1, g1), (l4, g4) = results
    assert abs(float(l1) - float(l4)) <= 1e-5
    for a, b in zip(tree_lib.leaves(g1), tree_lib.leaves(g4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL, rtol=0)
    # and the JAX package's microbatched step gives the same
    jstep = jax.jit(jax_streamify_train_step(lambda p, b: jm.loss(p, b),
                                             JaxStreamConfig(1, 4)))
    jloss, _, jgrads = jstep(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(l4) - float(jloss)) <= 1e-5
    want = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jgrads)))
    for a, b in zip(tree_lib.leaves(g4), tree_lib.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL, rtol=0)
