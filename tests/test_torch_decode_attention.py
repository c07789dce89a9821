"""The port's decode attention against the JAX package's.

On the CPU ``kernels.ops.decode_attention`` computes the plain version
(``kernels.ref.decode_attention_ref``); the JAX side is
``models/attention.py``'s ``decode_attention_local``.  Inputs are made with
numpy from a seed and handed to both.  The hand-written flash-decode kernel
(``csrc/decode_attention.cu``) is held against the same plain version on the
card by ``chip_smoke.py``; here its wrapper's refusals and its split planner
run, which are plain Python.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.models import attention as jax_attention
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
H100_SMS = 132
B, KV, S = 2, 2, 200
# t at 0, at a split edge (at this batch and k/v head count the planner
# cuts 0..127 into 4 splits of one 32-position tile, and 0..126 into 3),
# and at S - 1
T_CASES = {"zero": 0, "split-edge": 127, "last": S - 1}


def split_bounds(split, n_splits, t):
    """``[start, end)`` of split ``split`` of positions ``0..t``: the
    kernel's rule (``csrc/decode_attention.cu``), runs whose lengths differ
    by at most one position."""
    return split * (t + 1) // n_splits, (split + 1) * (t + 1) // n_splits


def _inputs(seed, hd, G):
    rng = np.random.default_rng(seed)
    H = G * KV
    q = rng.standard_normal((B, 1, H, hd), dtype=np.float32)
    kn, vn = (rng.standard_normal((B, 1, KV, hd), dtype=np.float32) for _ in range(2))
    # noise at every position, so a read past t would show
    kc, vc = (rng.standard_normal((B, S, KV, hd), dtype=np.float32) for _ in range(2))
    return q, kn, vn, kc, vc


@pytest.mark.parametrize("t_case", list(T_CASES))
@pytest.mark.parametrize("G", [1, 6, 7, 8, 12])
@pytest.mark.parametrize("hd", [16, 64, 80, 128])
def test_decode_attention_matches_jax(hd, G, t_case):
    t = T_CASES[t_case]
    if t_case == "split-edge":
        n = da.plan_splits(t, B, KV, H100_SMS)
        assert n == 4 == da.plan_splits(t - 1, B, KV, H100_SMS) + 1
        assert [split_bounds(s, n, t) for s in range(n)] == [(0, 32), (32, 64), (64, 96),
                                                                 (96, 128)]
    q, kn, vn, kc, vc = _inputs(hd * 100 + G, hd, G)
    jo, jk, jv = jax_attention.decode_attention_local(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(t))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ops.reset_launch_counts()
    to, rk, rv = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kn),
                                      torch.from_numpy(vn), tk, tv, t)
    assert rk is tk and rv is tv  # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert to.shape == q.shape and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert ops.launch_counts()["decode_attention"] == 0  # the CPU launches nothing


def test_decode_attention_local_goes_through_ops(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "decode_attention",
                        lambda *a, **kw: calls.append((a, kw)) or ("o", a[3], a[4]))
    q = torch.zeros(1, 1, 4, 16).transpose(2, 3).contiguous().transpose(2, 3)
    kc, vc = torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16)
    out = attention.decode_attention_local(q, torch.zeros(1, 1, 2, 16),
                                           torch.zeros(1, 1, 2, 16), kc, vc, 3)
    assert out == ("o", kc, vc) and len(calls) == 1
    (args, kw), = calls
    assert args[0].is_contiguous() and args[5] == 3 and kw == {"t_device": None}


def test_meta_tensors_take_the_plain_version():
    """A ``meta`` tensor (the dry-run's traces) computes the plain ops, as
    XLA costs the JAX package's jnp decode: shapes out, no launch."""
    ops.reset_launch_counts()
    q = torch.empty(2, 1, 8, 64, device="meta")
    kc, vc = (torch.empty(2, 32, 2, 64, device="meta") for _ in range(2))
    kn = torch.empty(2, 1, 2, 64, device="meta")
    o, k_out, v_out = ops.decode_attention(q, kn, kn, kc, vc, 5)
    assert (o.device.type, o.shape, o.dtype) == ("meta", q.shape, q.dtype)
    assert k_out is kc and v_out is vc
    assert ops.launch_counts()["decode_attention"] == 0


class _OnCard(torch.Tensor):
    """A tensor that reports a CUDA device on a machine without one and
    refuses every op run on it."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=torch.float32,
                                                   device="cuda")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a tensor on the card")


def _dtensor_on_card(shape):
    """A DTensor whose local shard reports a CUDA device (a one-rank mesh,
    no process group)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    local = _OnCard(shape)
    mesh = DeviceMesh("cpu", [0], _init_backend=False, _rank=0)
    spec = DTensorSpec(mesh, (Replicate(),),
                       tensor_meta=TensorMeta(local.shape, local.stride(), local.dtype))
    return DTensor(local, spec, requires_grad=False)


@pytest.mark.parametrize("which", ["q", "k_cache"])
def test_a_dtensor_on_the_card_raises_and_never_takes_the_plain_version(which, monkeypatch):
    """A DTensor whose shards sit on the card has no kernel route here: it
    must raise, not run the plain ops on the card."""
    monkeypatch.setattr(ops, "decode_attention_ref",
                        lambda *a: pytest.fail("took the plain version"))
    shapes = dict(q=(2, 1, 8, 64), k_new=(2, 1, 2, 64), v_new=(2, 1, 2, 64),
                  k_cache=(2, 32, 2, 64), v_cache=(2, 32, 2, 64))
    args = {k: torch.zeros(v) for k, v in shapes.items()}
    args[which] = _dtensor_on_card(shapes[which])
    assert type(args[which]).__name__ == "DTensor" and args[which].device.type == "cuda"
    before = ops.launch_counts()["decode_attention"]
    with pytest.raises(ValueError, match="no kernel for a DTensor on cuda"):
        ops.decode_attention(*args.values(), 5)
    assert ops.launch_counts()["decode_attention"] == before


def test_fake_tensors_on_the_card_take_the_plain_version(monkeypatch):
    """A fake CUDA tensor of a trace does no work on the card: it goes to
    the plain version, as a ``meta`` tensor does, with no launch (the plain
    ops are stubbed: a CPU build of torch has no fake CUDA ``index_put``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    monkeypatch.setattr(ops, "decode_attention_ref",
                        lambda *a: calls.append(a) or (a[0], a[3], a[4]))
    ops.reset_launch_counts()
    with FakeTensorMode():
        q = torch.empty(2, 1, 8, 64, device="cuda")
        kn = torch.empty(2, 1, 2, 64, device="cuda")
        kc, vc = (torch.empty(2, 32, 2, 64, device="cuda") for _ in range(2))
        out = ops.decode_attention(q, kn, kn, kc, vc, 5)
    assert out == (q, kc, vc) and len(calls) == 1 and calls[0][5] == 5
    assert ops.launch_counts()["decode_attention"] == 0


@pytest.mark.parametrize("batch,kv_heads", [(4, 4), (32, 4), (1, 1), (32, 32)])
def test_split_planner_covers_every_position_once_in_two_waves(batch, kv_heads):
    """B x KV = 16 (yi-9b.prefill's decode steps) and 128 (yi-9b.decode),
    and the extremes: the splits cover 0..t once each, in runs that differ
    by at most one position and hold ``MIN_SPLIT`` positions at least (one
    run where t has fewer); the grid never passes one block an SM of an
    H100's 132 (the kernel could hold two an SM), and comes
    within one split of it wherever t has enough positions."""
    bkv = batch * kv_heads
    fit = max(1, H100_SMS // bkv)  # splits that one block an SM holds
    for t in range(0, 4096):
        n = da.plan_splits(t, batch, kv_heads, H100_SMS)
        bounds = [split_bounds(s, n, t) for s in range(n)]
        covered = np.zeros(t + 1, dtype=int)
        for a, b in bounds:
            covered[a:b] += 1
        assert (covered == 1).all(), (t, n)
        lengths = {b - a for a, b in bounds}
        assert max(lengths) - min(lengths) <= 1 and (n == 1 or min(lengths) >= da.MIN_SPLIT)
        assert bounds[-1][1] == t + 1  # the last split holds t, which it writes
        assert 1 <= n * bkv <= max(H100_SMS, bkv)
        if (t + 1) // da.MIN_SPLIT >= fit:
            assert n == fit, (t, n)
    # the benchmark's decode positions: 8 splits at batch 4, one (no merge) at 32
    if bkv in (16, 128):
        for t in range(1024, 4096):
            assert da.plan_splits(t, batch, kv_heads, H100_SMS) == {16: 8, 128: 1}[bkv]


def _cpu(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case,err,match", [
    ("cpu", ValueError, "one CUDA device"),
    ("dtype", TypeError, "all fp32"),
    ("bf16-cache", TypeError, "all fp32"),
    ("non-contiguous-cache", ValueError, "contiguous"),
    ("groups", ValueError, "does not fit"),
    ("t-past-the-end", ValueError, "outside"),
    ("t-negative", ValueError, "outside"),
    ("head-dim", ValueError, "head_dim 96"),
    ("group-too-large", ValueError, "at most 16"),
    ("new-kv-shape", ValueError, "k_new"),
])
def test_decode_wrapper_refuses_what_the_kernel_cannot_take(case, err, match):
    """Each refusal comes before any launch (these are CPU tensors: the
    device is checked last, so every other refusal shows here)."""
    hd, H, kv, Sc, t = 64, 8, 2, 16, 3
    if case == "head-dim":
        hd = 96
    if case == "groups":
        H = 7
    if case == "group-too-large":
        H, kv = 34, 2
    q = _cpu((1, 1, H, hd), torch.float64 if case == "dtype" else torch.float32)
    kn, vn = _cpu((1, 1, kv, hd)), _cpu((1, 1, kv, hd))
    if case == "new-kv-shape":
        kn = _cpu((1, 2, kv, hd))
    kc = _cpu((1, Sc, kv, hd), torch.bfloat16 if case == "bf16-cache" else torch.float32)
    vc = _cpu((1, Sc, kv, hd))
    if case == "non-contiguous-cache":
        vc = _cpu((1, kv, Sc, hd)).transpose(1, 2)
    t = {"t-past-the-end": Sc, "t-negative": -1}.get(case, t)
    before = ops.launch_counts()["decode_attention"]
    with pytest.raises(err, match=match):
        da.decode_attention_cuda(q, kn, vn, kc, vc, t)
    assert ops.launch_counts()["decode_attention"] == before


def test_the_kernel_source_is_fp32_on_the_cuda_cores():
    """No tensor-core or TF32 path in the flash-decode source, no atomics,
    and nothing in the port calls a library attention or torch.compile."""
    text = _build.SOURCES["decode_attention"].read_text()
    assert not re.search(r"\b(mma|wgmma|tf32|atomic\w*)\b", text)
    assert 'extern "C" int decode_attention_fwd(' in text
    assert "fmaf(" in text and "cp.async" in text
    for path in SRC.rglob("*.py"):
        body = path.read_text()
        assert "scaled_dot_product_attention" not in body, path
        assert "torch.compile" not in body, path
