"""Port kernels against the JAX Pallas kernels.

On the CPU the port's ``kernels.ops`` computes the plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Inputs are made with numpy from a seed and
handed to both.  The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.kernels.ops import rmsnorm as jax_rmsnorm
from repro.models.attention import reference_attention as jax_reference_attention
from repro_torch.kernels import _build, ops

SHAPES = [
    # B, S, H, KV, hd
    (1, 128, 4, 4, 32),
    (2, 256, 8, 2, 64),   # GQA
    (2, 128, 4, 1, 64),   # MQA
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _both(a: np.ndarray, dtype: str):
    """The same fp32 numpy values as a torch tensor and a jax array, both
    rounded to ``dtype`` the same way (round to nearest even)."""
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(seed, B, Sq, Sk, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    return _both(q, dtype), _both(k, dtype), _both(v, dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(shape, dtype):
    B, S, H, KV, hd = shape
    (qt, qj), (kt, kj), (vt, vj) = _qkv(0, B, S, S, H, KV, hd, dtype)
    want = jax_flash_attention(qj, kj, vj, q_block=128, kv_block=128)
    got = ops.flash_attention(qt, kt, vt, q_block=128, kv_block=128)
    assert got.dtype == getattr(torch, dtype) and got.shape == qt.shape
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= ATTN_TOL[dtype], err


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128)])
def test_flash_attention_block_sizes_do_not_change_result(blocks):
    (qt, qj), (kt, kj), (vt, vj) = _qkv(1, 1, 256, 256, 4, 2, 32, "float32")
    want = jax_flash_attention(qj, kj, vj, q_block=blocks[0], kv_block=blocks[1])
    got = ops.flash_attention(qt, kt, vt, q_block=blocks[0], kv_block=blocks[1])
    assert np.abs(_np(got) - _np(want)).max() <= 2e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 90)])
def test_flash_attention_ragged_matches_reference(causal, sq, sk):
    # The Pallas kernel asserts block multiples; the port takes any length.
    (qt, qj), (kt, kj), (vt, vj) = _qkv(2, 2, sq, sk, 4, 2, 32, "float32")
    want = jax_reference_attention(qj, kj, vj, causal=causal)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert np.abs(_np(got) - _np(want)).max() <= 2e-5


@pytest.mark.parametrize("rows,d", [(4, 64), (37, 96), (256, 128), (1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(rows, d, dtype):
    rng = np.random.default_rng(3)
    xt, xj = _both(rng.standard_normal((rows, d), dtype=np.float32), dtype)
    st, sj = _both(rng.standard_normal((d,), dtype=np.float32), dtype)
    want = jax_rmsnorm(xj, sj, row_block=64)
    got = ops.rmsnorm(xt, st, row_block=64)
    assert got.dtype == getattr(torch, dtype) and got.shape == xt.shape
    assert np.abs(_np(got) - _np(want)).max() <= NORM_TOL[dtype]


def test_rmsnorm_3d_matches_pallas():
    rng = np.random.default_rng(4)
    xt, xj = _both(rng.standard_normal((2, 17, 64), dtype=np.float32), "float32")
    got = ops.rmsnorm(xt, torch.ones(64))
    want = jax_rmsnorm(xj, jnp.ones((64,)))
    assert np.abs(_np(got) - _np(want)).max() <= 1e-5


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.randn(3, 8)
    ops.rmsnorm(x, torch.ones(8))
    q = torch.randn(1, 16, 2, 16)
    ops.flash_attention(q, q[:, :, :1].contiguous(), q[:, :, :1].contiguous())
    assert ops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0}


def test_other_devices_and_bad_blocks_raise():
    x = torch.empty(3, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.rmsnorm(x, torch.empty(8, device="meta"))
    q = torch.empty(1, 16, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros(1, 4, 1, 16), torch.zeros(1, 4, 1, 16),
                            torch.zeros(1, 4, 1, 16), q_block=0)
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros(2, 4), torch.ones(4), row_block=0)


def test_build_names_libraries_by_source_and_honours_build_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(p.parent == tmp_path and p.suffix == ".so" for p in paths.values())
    assert len(set(paths.values())) == len(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    entry = {"flash_attention": "flash_attention_fwd", "rmsnorm": "rmsnorm_fwd"}
    for name, src in _build.SOURCES.items():
        text = src.read_text()
        assert f"src/repro/kernels/{name}.py" in text  # names the TPU kernel
        assert f'extern "C" int {entry[name]}(' in text


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())
