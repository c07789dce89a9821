"""Port kernels against the JAX Pallas kernels.

On the CPU the port's ``kernels.ops`` computes the plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Inputs are made with numpy from a seed and
handed to both.  The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``.
"""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.kernels.ops import rmsnorm as jax_rmsnorm
from repro.models.attention import reference_attention as jax_reference_attention
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.kernels import (_build, decode_attention, decode_proj, flash_attention, ops,
                                 rmsnorm)
from repro_torch.kernels.flash_attention import HEAD_DIMS

# every C entry point the wrappers declare, and the one launch entry of
# each library
ENTRIES = [e for m in (flash_attention, rmsnorm, decode_attention, decode_proj)
           for e in vars(m).values() if isinstance(e, _build.Entry)]
LAUNCH_ENTRIES = {e.library: e for e in ENTRIES if e.restype is _build.INT}

SHAPES = [
    # B, S, H, KV, hd
    (1, 128, 4, 4, 32),
    (2, 256, 8, 2, 64),   # GQA
    (2, 128, 4, 1, 64),   # MQA
    (1, 128, 4, 4, 80),   # stablelm-3b's head dim, MHA
    (1, 128, 8, 2, 160),  # pixtral-12b's head dim, GQA
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


@pytest.mark.parametrize("arch", list_archs())
def test_every_served_head_dim_has_a_kernel(arch):
    cfg = get_arch(arch)
    if "attn" not in cfg.layer_pattern:
        assert arch == "xlstm-350m"  # recurrent blocks only: no attention kernel
        return
    assert cfg.head_dim in HEAD_DIMS, (arch, cfg.head_dim)
    assert cfg.reduced().head_dim in HEAD_DIMS, (arch, cfg.reduced().head_dim)


@pytest.mark.parametrize("arch", list_archs())
def test_every_trained_head_dim_has_a_backward_kernel(arch):
    """The backward kernel is instantiated for every head dim a config
    reaches, reduced or full, and the wrapper's HEAD_DIMS are exactly the
    instances of both sources."""
    cases = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        text = _build.SOURCES[name].read_text()
        cases[name] = tuple(int(c) for c in re.findall(r"case (\d+): return launch<T, \1>", text))
    assert cases["flash_attention"] == cases["flash_attention_bwd"] == HEAD_DIMS
    cfg = get_arch(arch)
    if "attn" not in cfg.layer_pattern:
        return  # xlstm-350m: no attention
    for hd in (cfg.head_dim, cfg.reduced().head_dim):
        assert hd in cases["flash_attention_bwd"], (arch, hd)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, by adding half of the dropped 13 bits' range to the
    bit pattern and masking them off."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, products: int, *,
             b_exact: bool = False) -> torch.Tensor:
    """a @ b on TF32 tensor cores as the kernel issues it: 3 products
    lo.hi + hi.lo + hi.hi (small terms first), or hi.hi alone.  With
    ``b_exact`` (a bf16 operand, exact in TF32) b has no lo part and the
    3-product form is the kernel's two, lo.hi + hi.hi.  Products of TF32
    values are exact in fp32, so an fp32 matmul of them stands in for the
    tensor core up to the order of its fp32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al = _tf32(a - ah)
    if b_exact:
        assert torch.equal(bh, b)
        return al @ bh + ah @ bh
    bl = _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("group,S,hd", [(8, 512, 128), (1, 512, 80), (4, 512, 160)],
                         ids=["yi-9b", "stablelm-3b", "pixtral-12b"])
def test_3xtf32_meets_the_fp32_tolerance_and_1xtf32_does_not(group, S, hd, products):
    # One KV group of the model's prefill, causal: q (G*S, hd) folded as
    # the kernel folds it, k and v (S, hd), N(0, 1) inputs.
    rng = np.random.default_rng(7)
    q = rng.standard_normal((S, group, hd), dtype=np.float32)
    k = rng.standard_normal((S, hd), dtype=np.float32)
    v = rng.standard_normal((S, hd), dtype=np.float32)
    mask = np.arange(S)[:, None, None] >= np.arange(S)[None, None, :]
    scale = 1.0 / hd ** 0.5
    # fp64 reference
    s64 = np.einsum("qgd,kd->qgk", q.astype(np.float64), k.astype(np.float64)) * scale
    s64 = np.where(mask, s64, -np.inf)
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    want = np.einsum("qgk,kd->qgd", p64 / p64.sum(-1, keepdims=True), v.astype(np.float64))
    # the kernel's arithmetic: fp32 scores, fp32 p, both products in TF32
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    s = _mm_tf32(qt.reshape(S * group, hd), kt.T, products).reshape(S, group, S) * scale
    s = torch.where(torch.from_numpy(mask), s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _mm_tf32(p.reshape(S * group, S), vt, products).reshape(S, group, hd)
    got = (o / p.sum(-1, keepdim=True)).numpy()
    err = np.abs(got - want).max()
    if products == 3:
        assert err <= ATTN_TOL["float32"], err
    else:
        assert err > 10 * ATTN_TOL["float32"], err


@pytest.mark.parametrize("form", ["3xTF32", "1xTF32", "bf16 operands"])
@pytest.mark.parametrize("group,S,hd", [(1, 512, 80), (8, 512, 128)],
                         ids=["stablelm-3b", "yi-9b"])
def test_backward_3xtf32_meets_the_fp32_tolerance_and_1xtf32_does_not(group, S, hd, form):
    """The backward kernel's five products on the tensor cores, emulated as
    it issues them, for one causal KV group (G query heads folded over
    one K/V head, N(0, 1) inputs): S = Q K^T, dP = dO V^T, dV = P^T dO,
    dK = dS^T Q and dQ = dS K, with P and dS (fp32 values the kernel
    computes) always split.  dK and dV sum over all G * S folded rows.
    Each gradient within 2e-5 * max(1, max |fp64 reference|) in 3xTF32,
    and in the bf16 kernel's form (operands rounded to bf16, exact in TF32,
    so only P and dS have lo parts); not in 1xTF32."""
    rng = np.random.default_rng(11)
    q, do = (rng.standard_normal((S * group, hd), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((S, hd), dtype=np.float32) for _ in range(2))
    if form == "bf16 operands":
        q, do, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (q, do, k, v))
    # folded row f is query position f // G
    mask = (np.arange(S * group)[:, None] // group) >= np.arange(S)[None, :]
    scale = 1.0 / hd ** 0.5
    # fp64 reference
    q64, k64, v64, do64 = (a.astype(np.float64) for a in (q, k, v, do))
    s64 = np.where(mask, q64 @ k64.T * scale, -np.inf)
    lse64 = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) + s64.max(-1)
    p64 = np.exp(s64 - lse64[:, None])
    o64 = p64 @ v64
    ds64 = p64 * (do64 @ v64.T - (do64 * o64).sum(-1, keepdims=True))
    want = {"dq": ds64 @ k64 * scale, "dk": ds64.T @ q64 * scale, "dv": p64.T @ do64}
    # the kernel's arithmetic: lse and O from the forward in fp32, D in fp32
    products = 1 if form == "1xTF32" else 3
    exact = form == "bf16 operands"
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = torch.from_numpy(lse64.astype(np.float32))
    D = (dot * torch.from_numpy(o64.astype(np.float32))).sum(-1)
    mt = torch.from_numpy(mask)
    s = _mm_tf32(qt, kt.T, 1 if exact else products)
    p = torch.where(mt, torch.exp(s * scale - lse[:, None]), torch.zeros_like(s))
    dp = _mm_tf32(dot, vt.T, 1 if exact else products)
    ds = p * (dp - D[:, None])
    got = {"dq": _mm_tf32(ds, kt, products, b_exact=exact) * scale,
           "dk": _mm_tf32(ds.T.contiguous(), qt, products, b_exact=exact) * scale,
           "dv": _mm_tf32(p.T.contiguous(), dot, products, b_exact=exact)}
    errs = {n: np.abs(got[n].numpy() - want[n]).max() / max(1.0, np.abs(want[n]).max())
            for n in want}
    if form == "1xTF32":
        assert all(e > 10 * ATTN_TOL["float32"] for e in errs.values()), errs
    else:
        assert all(e <= ATTN_TOL["float32"] for e in errs.values()), errs


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


@pytest.mark.parametrize("rows,d", [(4, 64), (37, 96), (256, 128), (1, 32),
                                    (4, 2560)])  # stablelm-3b's decode width
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
    kc = torch.randn(1, 16, 1, 16)
    ops.decode_attention(q[:, :1].contiguous(), kc[:, :1], kc[:, :1], kc, kc.clone(), 4)
    w = torch.randn(8, 12)
    (y,) = ops.decode_proj(x, w)
    torch.testing.assert_close(y, x @ w, rtol=0, atol=0)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "rmsnorm": 0, "rmsnorm_bwd": 0, "decode_attention": 0,
                                   "decode_proj": 0}


def test_other_devices_and_bad_blocks_raise():
    """A ``meta`` tensor has no kernel of its own: it reaches the registered
    op, whose fake implementation gives shapes and dtypes (what a trace on
    ``meta`` tensors needs); bad block sizes raise on every device."""
    x = torch.empty(3, 8, device="meta")
    y = ops.rmsnorm(x, torch.empty(8, device="meta"))
    assert (y.device.type, y.shape, y.dtype) == ("meta", x.shape, x.dtype)
    q = torch.empty(1, 16, 2, 16, device="meta")
    o = ops.flash_attention(q, q, q)
    assert (o.device.type, o.shape, o.dtype) == ("meta", q.shape, q.dtype)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, kv_block=0)
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros(1, 4, 1, 16), torch.zeros(1, 4, 1, 16),
                            torch.zeros(1, 4, 1, 16), q_block=0)
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros(2, 4), torch.ones(4), row_block=0)


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Every op that reaches the dispatcher's Python mode, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _registered(names):
    return sorted({n for n in names if n.startswith("repro_torch.")})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [(2, 16, 16, 4, 2, 32), (1, 8, 24, 4, 4, 80)])
def test_registered_ops_fake_shapes_are_the_cuda_wrappers(B, Sq, Sk, H, KV, hd, dtype):
    """The fake implementations of the four registered ops give the shapes
    and dtypes that the CUDA wrappers allocate (``flash_attention_cuda``:
    o like q, lse (B, H, Sq) fp32; its backward dq, dk, dv like q, k, v;
    ``rmsnorm_cuda`` y like x; its backward dx like x, dscale like scale),
    and the CPU implementations (the plain versions) give the same."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rop = torch.ops.repro_torch
    qs, ks = (B, Sq, H, hd), (B, Sk, KV, hd)
    want_fa = [(qs, dtype), ((B, H, Sq), torch.float32)]
    want_bwd = [(qs, dtype), (ks, dtype), (ks, dtype)]
    want_norm = [((B, Sq, 64), dtype)]
    want_norm_bwd = [((B, Sq, 64), dtype), ((64,), torch.float32)]

    def calls(device):
        q, k, v = (torch.randn(s, device=device).to(dtype) for s in (qs, ks, ks))
        o, lse = rop.flash_attention(q, k, v, True, 16, 16)
        bwd = rop.flash_attention_bwd(q, k, v, o, lse, torch.randn_like(o), True, 16, 16)
        x, scale = torch.randn(B, Sq, 64, device=device).to(dtype), torch.ones(64, device=device)
        y = rop.rmsnorm(x, scale, 1e-5)
        return ((o, lse), bwd, (y,), rop.rmsnorm_bwd(x, scale, torch.randn_like(y), 1e-5))

    def meta(ts):
        return [(tuple(t.shape), t.dtype) for t in ts]

    with FakeTensorMode():
        fake = calls("cpu")
    for got in (calls("meta"), fake, calls("cpu")):
        assert [meta(g) for g in got] == [want_fa, want_bwd, want_norm, want_norm_bwd]


def test_plain_tensors_do_not_go_through_the_registered_ops():
    """A plain CPU tensor takes the direct path (no dispatcher op of the
    port's), forward and backward; a ``meta`` tensor takes the registered
    op, and its gradient the registered backward op."""
    q = torch.randn(1, 16, 2, 16, requires_grad=True)
    x = torch.randn(3, 8, requires_grad=True)
    for t in (q, x):
        with _OpLog() as log:
            y = ops.flash_attention(q, q, q) if t is q else ops.rmsnorm(x, torch.ones(8))
            y.sum().backward()
        assert _registered(log.names) == [], log.names
    qm = torch.empty(1, 16, 2, 16, device="meta", requires_grad=True)
    xm = torch.empty(3, 8, device="meta", requires_grad=True)
    with _OpLog() as log:
        torch.autograd.grad(ops.flash_attention(qm, qm, qm).sum(), qm)
        torch.autograd.grad(ops.rmsnorm(xm, torch.ones(8, device="meta")).sum(), xm)
    assert _registered(log.names) == [
        "repro_torch.flash_attention.default", "repro_torch.flash_attention_bwd.default",
        "repro_torch.rmsnorm.default", "repro_torch.rmsnorm_bwd.default"]


@pytest.mark.parametrize("x,scale,err,match", [
    (torch.zeros(2, 8), torch.ones(8), ValueError, "one CUDA device"),
    (torch.zeros(2, 8), torch.ones(4), ValueError, "scale"),
    (torch.zeros(()), torch.ones(1), ValueError, "want x"),
    (torch.zeros(2, 8193), torch.ones(8193), ValueError, "8192"),
    (torch.zeros(2, 8, dtype=torch.float16), torch.ones(8), TypeError, "fp32 or bf16"),
], ids=["cpu", "scale-shape", "0-d", "too-wide", "fp16"])
def test_rmsnorm_wrapper_refuses_what_the_kernel_cannot_take(x, scale, err, match):
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda

    with pytest.raises(err, match=match):
        rmsnorm_cuda(x, scale)


@pytest.mark.parametrize("q,kv,err,match", [
    ((1, 4, 2, 32), (1, 4, 1, 32), ValueError, "one CUDA device"),
    ((1, 4, 2, 96), (1, 4, 1, 96), ValueError, "head_dim 96"),
    ((1, 4, 3, 32), (1, 4, 2, 32), ValueError, "does not fit"),
    ((1, 4, 2, 32), (1, 4, 1, 16), ValueError, "does not fit"),
], ids=["cpu", "head-dim", "groups", "widths"])
def test_flash_wrapper_refuses_what_the_kernel_cannot_take(q, kv, err, match):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    with pytest.raises(err, match=match):
        flash_attention_cuda(torch.zeros(q), torch.zeros(kv), torch.zeros(kv))


def test_backward_wrappers_refuse_tensors_off_the_card():
    """A CPU tensor never reaches a backward kernel: the wrappers raise,
    and only ``kernels.ops``'s Functions take the plain backward."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    q, kv = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_bwd_cuda(q, kv, kv, q, torch.zeros(1, 2, 4), q)
    with pytest.raises(ValueError, match="one CUDA device"):
        rmsnorm_bwd_cuda(torch.zeros(2, 8), torch.ones(8), torch.zeros(2, 8))


def test_build_names_libraries_by_source_and_honours_build_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(p.parent == tmp_path and p.suffix == ".so" for p in paths.values())
    assert len(set(paths.values())) == len(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    launches = sorted(e.library for e in ENTRIES if e.restype is _build.INT)
    assert launches == sorted(_build.SOURCES)  # one launch entry a library
    c_type = {_build.INT: "int", _build.I64: "long long"}
    for name, src in _build.SOURCES.items():
        text = src.read_text()
        # names the TPU kernel it replaces, or whose gradient it computes, or
        # says that it replaces none and names the plain jnp it stands for
        if name == "decode_attention":
            assert "Replaces no Pallas kernel" in text
            assert "src/repro/models/attention.py, decode_attention_local" in text
        elif name == "decode_proj":
            assert "Replaces no Pallas kernel" in text
            assert "src/repro/models/layers.py, mlp_apply" in text
            assert "src/repro/models/layers.py, lm_head_apply" in text
        else:
            assert f"src/repro/kernels/{name.removesuffix('_bwd')}.py" in text
        assert f'extern "C" int {LAUNCH_ENTRIES[name].symbol}(' in text
        assert f'extern "C" const char* {name}_error_string(int err)' in text
    for e in ENTRIES:
        text = _build.SOURCES[e.library].read_text()
        assert f'extern "C" {c_type[e.restype]} {e.symbol}(' in text, e.symbol


@pytest.fixture
def fake_library(monkeypatch):
    """Replace the C library of ``library`` with one whose entries return
    ``ret`` (recording their arguments) and whose error string names the
    code, and the stream lookup with a fixed handle on a current device 0.
    Returns the calls made."""
    calls = []

    def install(library: str, ret: int):
        entries = [e for e in ENTRIES if e.library == library]

        def fn(*args):
            calls.append(args)
            return ret

        lib = types.SimpleNamespace(**{e.symbol: fn for e in entries})
        setattr(lib, f"{library}_error_string", lambda err: f"fake failure {err}".encode())
        monkeypatch.setattr(_build, "load",
                            lambda name: lib if name == library else pytest.fail(name))
        for e in entries:
            monkeypatch.setattr(e, "_fn", None)
            monkeypatch.setattr(e, "_message", None)
        return calls

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 4321,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    return install


@pytest.mark.parametrize("library", list(_build.SOURCES))
def test_a_launch_that_returns_0_counts_once_under_its_library(library, fake_library):
    calls = fake_library(library, 0)
    entry = LAUNCH_ENTRIES[library]
    ops.reset_launch_counts()
    entry.launch(0, 11, 12)
    entry.launch(0, 13)
    assert calls == [(11, 12, 4321), (13, 4321)]  # the stream handle last
    assert ops.launch_counts() == {**dict.fromkeys(_build.SOURCES, 0), library: 2}
    fn = getattr(_build.load(library), entry.symbol)
    assert fn.argtypes is entry.argtypes and fn.restype is _build.INT


@pytest.mark.parametrize("library", list(_build.SOURCES))
def test_a_failed_launch_raises_in_the_librarys_words_and_counts_nothing(library,
                                                                          fake_library):
    calls = fake_library(library, 700)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError,
                       match=rf"^{library} kernel launch failed: fake failure 700 \(700\)$"):
        LAUNCH_ENTRIES[library].launch(0, 11)
    assert calls == [(11, 4321)]
    assert ops.launch_counts() == dict.fromkeys(_build.SOURCES, 0)


def test_a_query_reads_no_stream_and_counts_nothing(fake_library, monkeypatch):
    """``flash_attention_bwd_scratch`` is asked for a size, not launched."""
    calls = fake_library("flash_attention_bwd", 4096)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: pytest.fail("a query read the stream"), raising=False)
    ops.reset_launch_counts()
    assert flash_attention._BWD_SCRATCH(1, 2, 3, 4, 5, 6) == 4096
    assert calls == [(1, 2, 3, 4, 5, 6)]
    assert ops.launch_counts() == dict.fromkeys(_build.SOURCES, 0)


def test_reset_launch_counts_zeroes_all_five():
    """Every library's count, the weight-streaming product's the sixth."""
    for i, name in enumerate(_build.SOURCES):
        _build.LAUNCHES[name] = i + 1
    counts = ops.launch_counts()
    assert counts == {name: i + 1 for i, name in enumerate(_build.SOURCES)}
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(_build.SOURCES, 0) != counts
    assert len(counts) == 6 and list(counts)[-1] == "decode_proj"


def test_library_names_follow_the_shared_header(monkeypatch, tmp_path):
    """A source that includes ``csrc/mma_tf32.cuh`` is rebuilt when the
    header changes: every library's name hashes the shared headers."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in [*_build.SOURCES.values(), *_build.headers()]:
        (csrc / path.name).write_bytes(path.read_bytes())
    assert [h.name for h in _build.headers()] == ["mma_tf32.cuh"]
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "SOURCES", {n: csrc / p.name for n, p in _build.SOURCES.items()})
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "mma_tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in before)
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "mma_tf32.cuh"' in _build.SOURCES[name].read_text()


@pytest.mark.parametrize("name", ["flash_attention_bwd", "rmsnorm_bwd"])
def test_backward_kernels_sum_in_a_fixed_order(name):
    """No atomics in either backward source: a second call on the same
    inputs is bitwise equal to the first (``chip_smoke.py`` phase 3c (b)
    checks it on the card), which the resume drill's equality rests on."""
    text = _build.SOURCES[name].read_text()
    assert not re.search(r"\batomic\w*\s*\(", text)
    if name == "flash_attention_bwd":
        # every product on the tensor cores, through the shared helper
        assert "mma(" in text and "fmaf(a[i], b[i], acc)" in text
        assert text.count("dot_rows<T, HD, kRT>(") == 4  # S^T, dP^T; S, dP
        assert text.count("acc_tile<T, HD, kRT>(") == 3  # dV, dK; dQ


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())
