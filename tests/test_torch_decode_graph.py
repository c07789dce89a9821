"""The dense decode step's CUDA graphs (``models/decode_graph.py``), on the
CPU: which models take them, and the decode that a graph replays, with
``t`` read from a device tensor and the attention calls cut out, against
the eager step, bit for bit.  The graphs themselves run only on the card
(``chip_smoke.py``'s decode phase holds them against the eager step)."""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models import decode_graph, transformer  # noqa: E402
from repro_torch.models.model_zoo import Model  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402


def _jamba2(reduced: bool = False):
    """Jamba's pattern with the Jamba2-Mini fields on: dropless top-2, the
    mixer's inner norms, no rotary (the benchmark's ``jamba`` family)."""
    cfg = get_arch("jamba-1.5-large-398b")
    cfg = cfg.reduced() if reduced else cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dropless=True, renormalize=False),
        ssm=dataclasses.replace(cfg.ssm, inner_norms=True), rope=False)


RULE_CASES = {
    "yi-9b on the card": (lambda: get_arch("yi-9b"), RunConfig(), "cuda", True),
    "stablelm-3b on the card": (lambda: get_arch("stablelm-3b"), RunConfig(), "cuda", True),
    "reduced yi-9b on the card": (lambda: get_arch("yi-9b").reduced(), RunConfig(), "cuda",
                                  True),
    "yi-9b on the CPU": (lambda: get_arch("yi-9b"), RunConfig(), "cpu", False),
    "stablelm-3b on the CPU": (lambda: get_arch("stablelm-3b"), RunConfig(), "cpu", False),
    "jamba2-mini": (_jamba2, RunConfig(), "cuda", False),
    "MoE (grok-1)": (lambda: get_arch("grok-1-314b"), RunConfig(), "cuda", False),
    "MoE (arctic)": (lambda: get_arch("arctic-480b"), RunConfig(), "cuda", False),
    "xLSTM": (lambda: get_arch("xlstm-350m"), RunConfig(), "cuda", False),
    "frontend (pixtral)": (lambda: get_arch("pixtral-12b"), RunConfig(), "cuda", False),
    "a mesh": (lambda: get_arch("yi-9b"), RunConfig(decode_attn="sharded", mesh=object()),
               "cuda", False),
    "bf16 compute": (lambda: get_arch("yi-9b"), RunConfig(compute_dtype=torch.bfloat16),
                     "cuda", False),
    "bf16 cache": (lambda: get_arch("yi-9b"), RunConfig(cache_dtype=torch.bfloat16), "cuda",
                   False),
}


@pytest.mark.parametrize("case", RULE_CASES)
def test_the_graphs_engage_by_what_the_model_shows(case):
    cfg, rcfg, device_type, want = RULE_CASES[case]
    assert decode_graph.applies(cfg(), rcfg, device_type) is want


def test_a_model_on_the_cpu_holds_no_graphs():
    m = Model(get_arch("yi-9b").reduced(), device="cpu")
    assert m._graphs is None and m.captures == 0 and m.replays == 0


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _prefilled(cfg, seed: int):
    """Parameters, a decode cache filled over 8 tokens and two copies of
    it, and the next tokens."""
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(seed + 1))
    with torch.inference_mode():
        logits, filled = m.prefill(params, {"tokens": tokens})
        cache = m.decode_cache(filled, 12)
    copy = [{k: v.clone() for k, v in c.items()} for c in cache]
    return params, cache, copy, logits.argmax(-1)


ARCHS = {"reduced yi-9b": lambda: get_arch("yi-9b").reduced(),
         "reduced RoPE-free jamba": lambda: _jamba2(reduced=True)}


@pytest.mark.parametrize("arch", ARCHS)
def test_t_from_a_device_tensor_decodes_bit_equal_to_t_by_value(arch, one_thread):
    """What a replay computes: RoPE's positions and the decode attention's
    t from a one-element int64 tensor, and every decode attention call run
    through ``attn_call``, give the logits and caches of the int path."""
    cfg = ARCHS[arch]()
    params, eager, graphed, tok = _prefilled(cfg, 5)
    rcfg = RunConfig()
    n_attn = sum(cfg.layer_pattern[l % len(cfg.layer_pattern)] == "attn"
                 for l in range(cfg.num_layers))
    calls = []

    def attn_call(call):
        calls.append(1)
        return call()

    with torch.inference_mode():
        tok_e = tok_g = tok
        for t in range(8, 11):
            le, _, eager = transformer.forward(params, {"tokens": tok_e[:, None]}, cfg, rcfg,
                                               cache=eager, t=t)
            lg, _, graphed = transformer.forward(
                params, {"tokens": tok_g[:, None]}, cfg, rcfg, cache=graphed, t=t,
                t_device=torch.tensor([t]), attn_call=attn_call)
            assert torch.equal(le, lg)
            tok_e, tok_g = le[:, 0].argmax(-1), lg[:, 0].argmax(-1)
    assert len(calls) == 3 * n_attn
    for a, b in zip(eager, graphed):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("t_device", [torch.tensor([3], dtype=torch.int32),
                                      torch.tensor(3), torch.tensor([3, 4]), 3],
                         ids=["int32", "zero-dim", "two-elements", "an-int"])
def test_the_wrapper_refuses_a_t_it_cannot_read(t_device):
    """Refused before any launch; the refusal comes before the device
    check, so CPU tensors show it."""
    q = torch.zeros(1, 1, 8, 64)
    kn = torch.zeros(1, 1, 2, 64)
    kc = torch.zeros(1, 16, 2, 64)
    before = ops.launch_counts()["decode_attention"]
    with pytest.raises(ValueError, match="t_device"):
        da.decode_attention_cuda(q, kn, kn, kc, kc.clone(), 3, t_device=t_device)
    assert ops.launch_counts()["decode_attention"] == before


@pytest.mark.parametrize("sms", [132, 16, 4])
def test_the_graph_key_and_the_launch_take_one_split_count(sms, monkeypatch):
    """A graph's key and the wrapper's launch take the flash-decode split
    count from ``kernels.decode_attention.splits``: with the device's SM
    count patched, both follow it (the launch is caught before the card)."""
    B, S, H, KV, hd, t = 2, 512, 8, 2, 64, 300
    monkeypatch.setattr(_build, "sm_count", lambda index: sms)
    monkeypatch.setattr(da, "_check", lambda *args: None)
    launched = []
    # the launch's arguments after the device: 7 pointers, B, S, H, KV, hd,
    # t, then the split count
    monkeypatch.setattr(da._FWD, "launch", lambda index, *args: launched.append(args[13]))
    q, kn = torch.zeros(B, 1, H, hd), torch.zeros(B, 1, KV, hd)
    cache = [{"k": torch.zeros(B, S, KV, hd), "v": torch.zeros(B, S, KV, hd)}]
    da.decode_attention_cuda(q, kn, kn, cache[0]["k"], cache[0]["v"], t)
    key = decode_graph._key({"w": torch.zeros(1)}, {"tokens": torch.zeros(B, 1)}, cache, t)
    want = da.plan_splits(t, B, KV, sms)
    assert launched == [want] and key[3] == want
    assert want == {132: 9, 16: 4, 4: 1}[sms]
    assert not hasattr(decode_graph, "_build")  # the model layer plans nothing itself
