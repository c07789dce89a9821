"""Which products the decode step's weight-streaming kernel takes, and what
its wrapper refuses.

The kernel (``csrc/decode_proj.cu``) runs only on the card, where
``chip_smoke.py`` holds it against an fp64 product and cuBLAS.  Here the
routing runs on CPU tensors made to look like plain CUDA tensors to the
dispatcher (``ops._route`` answers ``"cuda"`` for ``decode_proj``), and
``ops.decode_proj`` is replaced by a recorder that computes the plain
version, so every product the kernel would take is seen and the step's
result is the plain one.
"""
import re

import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_proj as dp
from repro_torch.models import layers
from repro_torch.models.model_zoo import build_model

# the clusters an H100 held at once for split 1-8 (chip_smoke.py's
# decode_proj phase): 264 blocks of one, 132 pairs, ...
H100_FIT = (264, 132, 79, 62, 47, 39, 32, 30)
REAL_ROUTE = ops._route


def send_to_recorder(monkeypatch) -> list:
    """From here on, plain CPU tensors look like plain CUDA tensors to
    ``decode_proj``'s routing; returns the products that reach
    ``ops.decode_proj`` (rows, weight shapes, transposed, gated)."""
    real = ops._route
    monkeypatch.setattr(ops, "_route", lambda t, what: (
        "cuda" if what == "decode_proj" and type(t) is torch.Tensor and t.device.type == "cpu"
        else real(t, what)))
    calls = []

    def record(x, *ws, transposed=False, gated=False):
        calls.append((x.numel() // x.shape[-1], tuple(tuple(w.shape) for w in ws),
                      transposed, gated))
        return ref.decode_proj_ref(x, *ws, transposed=transposed, gated=gated)

    monkeypatch.setattr(ops, "decode_proj", record)
    return calls


@pytest.fixture
def on_card(monkeypatch):
    return send_to_recorder(monkeypatch)


def _model():
    m = build_model("yi-9b", reduced=True, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("rows", [4, 16, 32])
def test_a_decode_step_sends_every_dense_product_to_the_kernel(rows, monkeypatch):
    """Each layer's q/k/v in one launch, its output projection, its gated
    MLP's first two in one launch and its last, then the head; the logits
    are the plain step's, bit for bit."""
    m, params = _model()
    cfg = m.cfg
    tokens = torch.randint(0, cfg.vocab_size, (rows, 6), generator=torch.Generator().manual_seed(1))
    step = {"tokens": tokens[:, 5:]}
    with torch.inference_mode():
        _, filled = m.prefill(params, {"tokens": tokens[:, :5]})
        cache = m.decode_cache(filled, 8)
        want, _ = m.decode_step(params, step,
                                [dict(c, k=c["k"].clone(), v=c["v"].clone()) for c in cache], 5)
        on_card = send_to_recorder(monkeypatch)
        got, _ = m.decode_step(params, step, cache, 5)
    d, H, KV, hd, ff = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    layer = [(rows, ((d, H, hd), (d, KV, hd), (d, KV, hd)), False, False),
             (rows, ((H, hd, d),), False, False),
             (rows, ((d, ff), (d, ff)), False, True),
             (rows, ((ff, d),), False, False)]
    assert on_card == layer * cfg.num_layers + [(rows, ((cfg.vocab_size, d),), True, False)]
    assert torch.equal(got, want)


def test_the_prefill_sends_only_its_head(on_card):
    m, params = _model()
    tokens = torch.randint(0, m.cfg.vocab_size, (4, 40), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        m.prefill(params, {"tokens": tokens})
    assert on_card == [(4, ((m.cfg.vocab_size, m.cfg.d_model),), True, False)]


def _mlp(d=64, ff=128, dtype=torch.float32, grad=False):
    g = torch.Generator().manual_seed(3)
    return {k: torch.randn(shape, generator=g, dtype=dtype).requires_grad_(grad)
            for k, shape in (("w_in", (d, ff)), ("w_gate", (d, ff)), ("w_out", (ff, d)))}


def _plain_mlp(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]


@pytest.mark.parametrize("case", ["prefill-rows", "grad", "bf16", "cpu"])
def test_other_products_keep_the_plain_product(case, on_card, monkeypatch):
    """Rows above the cap (a prefill), a product that wants a gradient,
    bf16, and a tensor on the CPU (the real route) take ``@``."""
    p = _mlp(dtype=torch.bfloat16 if case == "bf16" else torch.float32, grad=case == "grad")
    rows = dp.MAX_ROWS + 1 if case == "prefill-rows" else 4
    x = torch.randn(1, rows, 64, dtype=p["w_in"].dtype)
    if case == "cpu":
        monkeypatch.setattr(ops, "_route", REAL_ROUTE)
    y = layers.mlp_apply(p, x)
    head = layers.lm_head_apply(p["w_out"], x)  # (ff, d) as a (vocab, d) table
    assert on_card == []
    torch.testing.assert_close(y, _plain_mlp(p, x), rtol=0, atol=0)
    torch.testing.assert_close(head, x @ p["w_out"].T, rtol=0, atol=0)
    if case == "grad":
        y.sum().backward()
        assert p["w_in"].grad is not None


def test_meta_fake_and_dtensor_tensors_take_the_plain_product(on_card):
    """A ``meta`` tensor (the dry-run's traces), a fake tensor of a trace
    and a DTensor are not plain CUDA tensors: the kernel takes none."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    w = torch.randn(64, 128)
    xm, wm = torch.empty(4, 64, device="meta"), torch.empty(64, 128, device="meta")
    assert not ops.takes_decode_proj(xm, wm)
    assert layers.mlp_apply({"w_in": wm, "w_out": wm.T.contiguous()}, xm).device.type == "meta"
    with FakeTensorMode():
        xf, wf = torch.empty(4, 64), torch.empty(64, 128)
        assert not ops.takes_decode_proj(xf, wf)
    mesh = DeviceMesh("cpu", [0], _init_backend=False, _rank=0)
    local = torch.randn(4, 64)
    spec = DTensorSpec(mesh, (Replicate(),),
                       tensor_meta=TensorMeta(local.shape, local.stride(), local.dtype))
    xd = DTensor(local, spec, requires_grad=False)
    assert not ops.takes_decode_proj(xd, w) and not ops.takes_decode_proj(local, xd)
    assert ops.takes_decode_proj(local, w)  # the same plain tensors do go
    assert on_card == []


def test_the_mixtures_batched_experts_keep_their_product(on_card):
    """The dropless MoE's decode runs its E experts as one batched product
    over a broadcast x and (E, d, F) weights: not a product of the kernel."""
    g = torch.Generator().manual_seed(4)
    p = {k: torch.randn(shape, generator=g) for k, shape in
         (("w_in", (4, 64, 128)), ("w_gate", (4, 64, 128)), ("w_out", (4, 128, 64)))}
    x = torch.randn(3, 64, generator=g).expand(4, 3, 64)
    y = layers.mlp_apply(p, x)
    assert on_card == [] and y.shape == (4, 3, 64)


@pytest.mark.parametrize("case,err,match", [
    ("cpu", ValueError, "one CUDA device"),
    ("dtype", TypeError, "fp32"),
    ("strides", ValueError, "contiguous"),
    ("k-alignment", ValueError, "multiple of 4"),
    ("n-alignment", ValueError, "multiple of 4"),
    ("rows-above-the-cap", ValueError, "1 to 32"),
    ("weight-shape", ValueError, r"\(K, N\)"),
    ("four-weights", ValueError, "1-3 weights"),
    ("gated-shapes", ValueError, "one shape"),
    ("gated-transposed", ValueError, "1-3 weights"),
])
def test_decode_proj_wrapper_refuses_what_the_kernel_cannot_take(case, err, match):
    """Each refusal comes before any launch (CPU tensors: the device is
    checked last, so every other refusal shows here)."""
    K, N, rows = {"k-alignment": 66}.get(case, 64), {"n-alignment": 130}.get(case, 128), 4
    rows = dp.MAX_ROWS + 1 if case == "rows-above-the-cap" else rows
    x = torch.zeros(rows, K, dtype=torch.float64 if case == "dtype" else torch.float32)
    w = torch.zeros(N, K).T if case == "strides" else torch.zeros(K, N)
    ws = (w,)
    kw = {}
    if case == "weight-shape":
        ws = (torch.zeros(K + 4, N),)
    if case == "four-weights":
        ws = (w,) * 4
    if case == "gated-shapes":
        ws, kw = (w, torch.zeros(K, N + 4)), {"gated": True}
    if case == "gated-transposed":
        ws, kw = (w, w), {"gated": True, "transposed": True}
    before = ops.launch_counts()["decode_proj"]
    with pytest.raises(err, match=match):
        dp.decode_proj_cuda(x, *ws, **kw)
    assert ops.launch_counts()["decode_proj"] == before


def test_the_kernel_source_splits_every_operand_and_sums_without_atomics():
    """3xTF32: both operands of every product split into TF32 hi and lo and
    three products taken (no plain TF32 product); the split-k sum goes
    through the cluster's shared memory in rank order, not atomics; and the
    port calls no library GEMM kernel in its place."""
    text = _build.SOURCES["decode_proj"].read_text()
    assert not re.search(r"\batomic\w*\s*\(|\bred\.global", text)
    assert "to_tf32<4, true>(a[i], ah, al)" in text and "to_tf32<2, true>(b, bh[j], bl[j])" in text
    assert not re.search(r"to_tf32<\d+, false>", text)
    assert [m.group(1) for m in re.finditer(r"mma\((\w+)\[i\]\[j\], (\w+, \w+)", text)] == [
        "small", "small", "big"]
    for pair in ("al, bh[j]", "ah, bl[j]", "ah, bh[j]"):
        assert f"{pair});" in text
    assert "map_shared_rank" in text and "cp_async16(" in text
    assert 'extern "C" int decode_proj_fwd(' in text
    assert 'extern "C" long long decode_proj_clusters(' in text
    assert "Replaces no Pallas kernel" in text


@pytest.mark.parametrize("tiles,k_tiles,want", [
    (40, 128, 5), (32, 128, 7), (32, 344, 7), (60, 80, 4), (20, 80, 8), (20, 6, 6),
    (172, 128, 4), (108, 80, 2), (500, 128, 1), (393, 80, 2), (1, 1, 1)])
def test_the_split_plan_takes_the_fewest_rounds_of_stages(tiles, k_tiles, want):
    """Waves of clusters the card holds at once, times stages a block: the
    fewest, the smaller split on a tie, at most 8 and the k-tiles there
    are.  yi-9b's q/k/v (40 column tiles) split 5, its gate and in (172)
    4, stablelm-3b's head (393) 2, yi-9b's head (500) 1."""
    fit = lambda s: H100_FIT[s - 1]
    rounds = lambda s: -(-tiles // fit(s)) * -(-k_tiles // s)
    split = dp.plan_split(tiles, k_tiles, fit)
    assert split == want and 1 <= split <= min(dp.MAX_SPLIT, k_tiles)
    assert all(rounds(split) < rounds(s) or (rounds(split) == rounds(s) and split <= s)
               for s in range(1, min(dp.MAX_SPLIT, k_tiles) + 1))
    # a device that holds no cluster of a size never gets it
    assert dp.plan_split(tiles, k_tiles, lambda s: fit(s) if s < 3 else 0) <= 2


def test_a_weight_is_read_as_the_matrix_its_storage_holds():
    assert dp.matrix_cols(torch.empty(64, 4, 16), 64) == 64        # wq (d, h, k)
    assert dp.matrix_cols(torch.empty(4, 16, 64), 64) == 64        # wo (h, k, d)
    assert dp.matrix_cols(torch.empty(512, 64), 64, transposed=True) == 512
    assert dp.matrix_cols(torch.empty(64, 512), 64, transposed=True) is None
    assert dp.matrix_cols(torch.empty(32, 128), 64) is None
    assert dp.matrix_cols(torch.empty(64), 64) is None


def test_the_plain_version_is_the_models_products():
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 3, 64, generator=g)
    wq, wo = torch.randn(64, 4, 16, generator=g), torch.randn(4, 16, 64, generator=g)
    (q,) = ref.decode_proj_ref(x, wq)
    assert torch.equal(q, x @ wq.reshape(64, 64))
    (o,) = ref.decode_proj_ref(x, wo)
    assert torch.equal(o, x @ wo.reshape(64, 64))
    p = _mlp()
    (h,) = ref.decode_proj_ref(x, p["w_in"], p["w_gate"], gated=True)
    assert torch.equal(h, F.silu(x @ p["w_gate"]) * (x @ p["w_in"]))
    (y,) = ref.decode_proj_ref(x, p["w_out"], transposed=True)
    assert torch.equal(y, x @ p["w_out"].T)
