"""Property-based cases (hypothesis) of ``tests/test_property.py`` on the
port, against the JAX package, on the CPU.

Every case keeps the JAX case's strategies and ``SETTINGS`` and its name.
For each draw, both packages take the same inputs, made with numpy from
the drawn seed (where the JAX case draws from ``jax.random``, this file
draws the same shapes from ``np.random.default_rng(seed)``): the JAX
case's invariant holds for each package, and the two outputs agree.

The port's flash attention runs here through its plain version at every
head dim the strategy draws (4, 8 and 16); the card's kernel takes only
``kernels.flash_attention.HEAD_DIMS``, which cover every served model
(``test_torch_kernels.test_every_served_head_dim_has_a_kernel``), and
``chip_smoke.py`` phase 2 runs this case's shapes through the kernel at
head dim 16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.checkpoint.checkpointer as jckpt  # noqa: E402
import repro.core.features as jfeatures  # noqa: E402
import repro.core.perf_model as jperf_model  # noqa: E402
import repro.core.stream_config as jstream_config  # noqa: E402
import repro.models.attention as jattention  # noqa: E402
import repro.models.layers as jlayers  # noqa: E402
import repro.optim.grad_compression as jcompression  # noqa: E402
import repro_torch.checkpoint.checkpointer as tckpt  # noqa: E402
import repro_torch.core.features as tfeatures  # noqa: E402
import repro_torch.core.perf_model as tperf_model  # noqa: E402
import repro_torch.core.stream_config as tstream_config  # noqa: E402
import repro_torch.models.attention as tattention  # noqa: E402
import repro_torch.models.layers as tlayers  # noqa: E402
import repro_torch.optim.grad_compression as tcompression  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SETTINGS = dict(max_examples=20, deadline=None)
ATTN_TOL = 3e-5   # the JAX case's: blocked against naive attention, fp32
NORM_TOL = 1e-6   # the two packages' RMSNorm on the same fp32 rows


@settings(**SETTINGS)
@given(
    B=st.integers(1, 2),
    S=st.integers(1, 48),
    KV=st.sampled_from([1, 2, 4]),
    G=st.sampled_from([1, 2, 3]),
    hd=st.sampled_from([4, 8, 16]),
    qb=st.sampled_from([8, 16, 64]),
    seed=st.integers(0, 2**31 - 1),
)
def test_flash_attention_invariant(B, S, KV, G, hd, qb, seed):
    """Blocked online-softmax == naive attention for ALL shapes/blocks, in
    both packages, and the two packages' outputs agree."""
    H = KV * G
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    jout = jattention.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      q_block=qb, kv_block=qb)
    assert jnp.allclose(jout, jattention.reference_attention(q, k, v), atol=ATTN_TOL)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tout = tattention.flash_attention(tq, tk, tv, q_block=qb, kv_block=qb)
    torch.testing.assert_close(tout, ref.flash_attention_ref(tq, tk, tv), atol=ATTN_TOL,
                               rtol=0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATTN_TOL, rtol=0)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1),
       scale=st.floats(1e-3, 1e3),
       n=st.integers(1, 512))
def test_int8_quantization_error_bound(seed, scale, n):
    """|dequant(quant(g)) - g| <= scale_step/2 elementwise, in both
    packages, with the same codes, steps and values."""
    g = np.random.default_rng(seed).normal(0, scale, n).astype(np.float32)
    jq, js = jcompression.quantize_int8(jnp.asarray(g))
    jback = jcompression.dequantize_int8(jq, js)
    assert float(jnp.max(jnp.abs(jback - g))) <= float(js) * 0.5 + 1e-6
    tq, ts = tcompression.quantize_int8(torch.from_numpy(g))
    tback = tcompression.dequantize_int8(tq, ts)
    assert float(torch.max(torch.abs(tback - torch.from_numpy(g)))) <= float(ts) * 0.5 + 1e-6
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tback.numpy(), np.asarray(jback))


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1),
       rows=st.integers(30, 200),
       cols=st.integers(3, 12),
       ncomp=st.integers(1, 9))
def test_feature_pipeline_invariants(seed, rows, cols, ncomp):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, cols))
    y = rng.normal(size=rows)
    out = []
    for pm in (jperf_model, tperf_model):
        pipe = pm.FeaturePipeline.fit(X, y, n_components=ncomp)
        Z = pipe.transform(X)
        assert Z.shape[0] == rows and Z.shape[1] <= ncomp
        assert np.isfinite(Z).all()
        np.testing.assert_allclose(pipe.inverse_y(pipe.transform_y(y)), y,
                                   rtol=1e-6, atol=1e-8)
        out.append((pipe.keep_idx.tolist(), Z))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])


@settings(**SETTINGS)
@given(p=st.sampled_from([1, 2, 4, 8, 16, 32]),
       t=st.sampled_from([1, 2, 4, 8, 16, 32, 64]))
def test_config_features_finite(p, t):
    out = []
    for features, sc in ((jfeatures, jstream_config), (tfeatures, tstream_config)):
        f = features.config_features(p, t)
        assert np.isfinite(f).all()
        assert sc.StreamConfig(p, t).as_tuple() == (p, t)
        out.append(f)
    np.testing.assert_array_equal(out[1], out[0])


@settings(**SETTINGS)
@given(st.recursive(
    st.integers(0, 5).map(lambda n: np.arange(n, dtype=np.float32)),
    lambda children: st.dictionaries(
        st.text(alphabet="abcdef", min_size=1, max_size=4), children,
        min_size=1, max_size=3),
    max_leaves=8).filter(lambda t: isinstance(t, dict)))
def test_checkpoint_flatten_roundtrip(tree):
    """Both packages flatten the tree to the same keys and arrays, and
    unflatten it back to the same leaves; the port flattens the tree's
    leaves as tensors."""
    jflat = jckpt._flatten(tree)
    tflat = tckpt._flatten(tree_lib.map(torch.from_numpy, tree))
    assert list(tflat) == list(jflat)
    for key in jflat:
        np.testing.assert_array_equal(tflat[key], np.asarray(jflat[key]))
    la = tree_lib.leaves(tree)
    for back in (jckpt._unflatten(jflat), tckpt._unflatten(tflat)):
        lb = tree_lib.leaves(back)
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, np.asarray(b))


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rows=st.integers(8, 64),
       eps=st.floats(1e-6, 1e-3))
def test_rmsnorm_output_scale(seed, rows, eps):
    """RMSNorm output has unit RMS when scale=1, in both packages, and the
    two outputs agree."""
    x = np.random.default_rng(seed).normal(2.0, 3.0, (rows, 32)).astype(np.float32)
    jy = jlayers.rmsnorm_apply({"scale": jnp.ones(32)}, jnp.asarray(x), eps=eps)
    assert jnp.allclose(jnp.sqrt(jnp.mean(jnp.square(jy), axis=-1)), 1.0, atol=1e-2)
    ty = tlayers.rmsnorm_apply({"scale": torch.ones(32)}, torch.from_numpy(x), eps=eps)
    assert torch.allclose(torch.sqrt(torch.mean(ty * ty, dim=-1)), torch.ones(rows), atol=1e-2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=NORM_TOL, rtol=0)
