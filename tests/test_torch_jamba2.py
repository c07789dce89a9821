"""The port's opt-in Jamba fields (``ArchConfig.rope``, ``MoEConfig.dropless``
and ``renormalize``, ``SSMConfig.inner_norms``), its ``moe.ffn`` and
``mamba.mixer`` spans and its routing record, on the CPU.

At their defaults the fields change nothing: every registered
architecture's outputs are bit-equal to those of the port before the fields
existed (the hashes below were taken from that tree).  The dropless MoE's
decode and prefill paths each equal a per-token loop over the chosen
experts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import pytest

torch = pytest.importorskip("torch")

import torch._C._profiler as c_profiler  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs.base import MoEConfig, get_arch, list_archs  # noqa: E402
from repro_torch.models import mamba, moe  # noqa: E402
from repro_torch.models.model_zoo import Model, build_model  # noqa: E402

# sha256 of the prefill logits, three decode steps' logits and the full
# forward's logits of each reduced architecture (``_outputs``), one thread,
# from the port before the opt-in fields were added
BEFORE = {
    "arctic-480b": "c9a36bc481633b468b98affe4678e63f299488af2b2316bcdce552a592966ffd",
    "codeqwen1.5-7b": "4c6a131f4d8bd825006d424c64f0d91e8722686e4dd693db6e9c5472b3286426",
    "grok-1-314b": "3cc8e21c7c5684e236d6dc48f3bad691d17aa81a44b69fd6e046c699f3cead3e",
    "jamba-1.5-large-398b": "b4d5bfe9dc60bc6c7e439465738e93a4355c48288ef9d878fa85dd6c31483965",
    "musicgen-medium": "4c6664314e6547e1f0d4cf230de4c9b7cb1d05068c4eef29f2430485c29892d0",
    "pixtral-12b": "d51da70c55bd35bc040a9001fbe6ada91d8ac5de472a8db25ba0936c84582862",
    "stablelm-3b": "e99cae19f080911f112b9a8816f96025ba027366f8550e16691c3db22f9112fe",
    "starcoder2-15b": "362700a453ba958f7c10f24437ae7823aeb0d79906d481a9d80c609c341fe695",
    "xlstm-350m": "7645dce3231a2488195f83a929e4113b952941e0416c736e8bba093e0a37a4d3",
    "yi-9b": "e99cae19f080911f112b9a8816f96025ba027366f8550e16691c3db22f9112fe",
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _outputs(m: Model) -> torch.Tensor:
    params = m.init(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, m.cfg.vocab_size, (2, 8), generator=g)
    batch = {"tokens": tokens}
    if m.cfg.frontend:
        batch["embeds"] = torch.randn(2, 8, m.cfg.frontend_dim, generator=g)
    with torch.inference_mode():
        logits, filled = m.prefill(params, batch)
        cache = m.decode_cache(filled, 12)
        steps = [logits]
        for t in range(8, 11):
            b = {"tokens": tokens[:, :1]}
            if m.cfg.frontend:
                b["embeds"] = batch["embeds"][:, :1]
            lg, cache = m.decode_step(params, b, cache, t)
            steps.append(lg)
        full = m.forward_logits(params, batch)
    return torch.cat([torch.cat(steps).reshape(-1), full.reshape(-1)])


def test_every_architecture_is_bit_equal_to_before(one_thread):
    assert sorted(BEFORE) == list_archs()
    for name, want in BEFORE.items():
        out = _outputs(build_model(name, reduced=True, device="cpu"))
        assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == want, name


def test_the_defaults_are_the_jax_packages_forms():
    for name in list_archs():
        cfg = get_arch(name)
        assert cfg.rope
        assert cfg.moe is None or (not cfg.moe.dropless and cfg.moe.renormalize)
        assert cfg.ssm is None or not cfg.ssm.inner_norms


def _jamba(**moe_kw):
    """Reduced jamba-1.5-large with the Jamba fields on: its MoE dropless
    (gates as ``moe_kw`` says), the mixer's inner norms, no rotary."""
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    mc = dataclasses.replace(cfg.moe, **dict(dict(dropless=True, renormalize=False), **moe_kw))
    return dataclasses.replace(cfg, moe=mc, ssm=dataclasses.replace(cfg.ssm, inner_norms=True),
                               rope=False)


def test_inner_norms_add_three_leaves_and_count_them():
    cfg = _jamba()
    m = Model(cfg, device="cpu")
    params, axes = m.abstract_params()
    mix = next(b["mamba"] for b in params["blocks"] if "mamba" in b)
    R, N = mamba._dt_rank(cfg.d_model, cfg.ssm), cfg.ssm.state_dim
    assert {k: tuple(mix[k]["scale"].shape) for k in ("dt_norm", "B_norm", "C_norm")} == {
        "dt_norm": (R,), "B_norm": (N,), "C_norm": (N,)}
    off = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, inner_norms=False))
    n_mamba = cfg.block_counts()["mamba"]
    assert (cfg.param_counts()["total"] - off.param_counts()["total"]
            == n_mamba * (R + 2 * N))


def test_the_inner_norms_and_rope_change_the_output():
    """Each Jamba field is used: turning it off changes the logits."""
    cfg = _jamba()
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    # scales off one so that a norm that is skipped shows in the output
    for b in params["blocks"]:
        for k in ("dt_norm", "B_norm", "C_norm"):
            if "mamba" in b:
                b["mamba"][k]["scale"].mul_(1.7)
    base = Model(cfg, device="cpu").forward_logits(params, {"tokens": tokens})
    for other in (dataclasses.replace(cfg, rope=True),
                  dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, renormalize=True))):
        got = Model(other, device="cpu").forward_logits(params, {"tokens": tokens})
        assert not torch.allclose(got, base, atol=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mamba, "_inner_norms", lambda p, dt, B, C, eps: (dt, B, C))
        got = Model(cfg, device="cpu").forward_logits(params, {"tokens": tokens})
    assert not torch.allclose(got, base, atol=1e-4)


def _loop(params, x, mc: MoEConfig, idx):
    """The MoE output, one token and one chosen expert at a time."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ params["router"], dim=-1)
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        gates = probs[t, idx[t]]
        if mc.renormalize:
            gates = gates / gates.sum()
        for e, g in zip(idx[t].tolist(), gates):
            h = F.silu(xt[t] @ params["w_gate"][e]) * (xt[t] @ params["w_in"][e])
            out[t] += g * (h @ params["w_out"][e])
    return out.reshape(x.shape)


@pytest.mark.parametrize("seq", [1, 7], ids=["decode", "prefill"])
@pytest.mark.parametrize("renormalize", [False, True])
def test_the_dropless_paths_equal_a_per_token_loop(seq, renormalize):
    mc = MoEConfig(num_experts=4, top_k=2, expert_d_ff=24, dropless=True,
                   renormalize=renormalize)
    p = moe.moe_init(torch.Generator().manual_seed(5), 16, mc, gated=True)
    # 6 sequences: at decode some expert sees more tokens than the 3 slots
    # a capacity of 1.25 * 6 * 2 / 4 would give it; experts 1 and 3 have
    # one router column, so their probabilities tie exactly (the lower
    # index first)
    p["router"][:, 3] = p["router"][:, 1]
    x = torch.randn(6, seq, 16, generator=torch.Generator().manual_seed(6))
    with moe.record_routes() as got:
        y, aux = moe.moe_apply(p, x, mc)
    assert len(got) == 1 and got[0].shape == (6 * seq, 2) and got[0].dtype == torch.long
    probs = torch.softmax(x.reshape(-1, 16) @ p["router"], -1)
    want_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :2]
    assert torch.equal(got[0], want_idx)
    counts = torch.bincount(got[0].reshape(-1), minlength=4)
    assert counts.max() > 3  # more than the capacity path's slots
    torch.testing.assert_close(y, _loop(p, x, mc, got[0]), rtol=1e-5, atol=1e-6)
    assert aux.ndim == 0 and torch.isfinite(aux)


def test_the_routing_record_is_closed_by_default_and_adds_no_op():
    cfg = _jamba()
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (3, 5), generator=torch.Generator().manual_seed(1))

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def step():
        with torch.inference_mode():
            _, filled = m.prefill(params, {"tokens": tokens})
            cache = m.decode_cache(filled, 8)
            with Ops() as ops:
                m.decode_step(params, {"tokens": tokens[:, :1]}, cache, 5)
        return ops.ops

    assert moe._routes is None
    plain = step()
    with moe.record_routes() as got:
        recorded = step()
    assert moe._routes is None
    assert recorded == plain  # no launch, no copy
    n_moe = sum(1 for b in params["blocks"] if "router" in b["ffn"])
    # the prefill's calls (15 tokens), then the decode step's (3 tokens)
    assert [tuple(r.shape) for r in got] == [(15, 2)] * n_moe + [(3, 2)] * n_moe


def test_the_capacity_path_records_its_routes_too():
    cfg = get_arch("grok-1-314b").reduced()
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    with moe.record_routes() as got:
        m.forward_logits(params, {"tokens": tokens})
    assert len(got) == cfg.num_layers and all(r.shape == (12, cfg.moe.top_k) for r in got)


def test_the_moe_and_mamba_spans_under_a_profiler(tmp_path, monkeypatch):
    cfg = _jamba()
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        _, filled = m.prefill(params, {"tokens": tokens})
        cache = m.decode_cache(filled, 8)
    step = lambda: m.decode_step(params, {"tokens": tokens[:, :1]}, cache, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.inference_mode():
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "cpu_op"]
    names = [e["name"] for e in ev]
    counts = cfg.block_counts()
    n_moe = sum(1 for b in params["blocks"] if "router" in b["ffn"])
    assert names.count("mamba.mixer") == counts["mamba"] and names.count("moe.ffn") == n_moe
    assert names.count("model.decode_step") == 1
    step_ev = next(e for e in ev if e["name"] == "model.decode_step")
    for e in ev:
        if e["name"] in ("mamba.mixer", "moe.ffn"):
            assert step_ev["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step_ev["ts"] + step_ev["dur"]

    def refuse(*a, **k):
        raise AssertionError("a span reached the profiler")

    monkeypatch.setattr(c_profiler, "_RecordFunctionFast", refuse)
    with torch.inference_mode():
        step()  # no profiler: no range opened
