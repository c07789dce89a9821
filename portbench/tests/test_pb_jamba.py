"""The Jamba family (``families/jamba.py``), its reference
(``reference/jamba.py``), the routed serving driver and the span readers of
``jamba2-mini.decode``, on the CPU at a small size: one 8-layer period, d
64, 4 experts top-2, ``d_state`` 16, ``dt_rank`` 8.

The port's prefill and decode through its cache equal the reference's
full forward up to summation order; a sound run of the cell is correct and
the control is not; and a run driven whole, with the Jamba form broken
underneath in any of the ways the cell guards against, comes out not
correct with the cell's committed limits."""
from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch

from portbench.tests import tiny
from portbench.drivers import port
from portbench.lib import cell, cost, family, judge, named_spans, trace, weights
from portbench.tests.test_pb_spans import _launch, _op, _range, _record, _span

CELL = "jamba2-mini.decode"
FULL = cell.config(cell.load_benchmark(), "jamba2-mini")


def config(**over) -> dict:
    """The committed configuration at a size the CPU runs in seconds."""
    cfg = dict(FULL, name="tiny-jamba", hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=512, num_experts=4,
               mamba_dt_rank=8)
    cfg.update(over)
    return cfg


def _setup(seed: int = 2**33 + 3):
    fam = family.of(config())
    dm = fam.dims(config())
    m = port.model(fam, dm, config(), torch.device("cpu"))
    params = weights.make(fam, dm, seed, "cpu")
    port.check_layout(m, params)
    return fam, dm, m, params


def test_the_full_configuration_is_one_period_of_the_published_model():
    dm = family.of(FULL).dims(FULL)
    assert dm.kinds == ("mamba",) * 4 + ("attn",) + ("mamba",) * 3
    assert dm.moe == (False, True) * 4
    assert (dm.head_dim, dm.group, dm.inner, dm.attn_layers) == (128, 4, 8192, 1)
    assert FULL["reduced"] == ["num_hidden_layers"] and FULL["published"] == {
        "num_hidden_layers": 32}
    n = sum(math.prod(s) for _, s, _, _ in family.of(FULL).leaf_specs(dm))
    assert round(n / 1e9, 2) == 13.30 and round(4 * n / 1e9, 2) == 53.18
    # the port's own count of the same tree
    m = port.model(family.of(FULL), dm, FULL, torch.device("cpu"))
    params, _ = m.abstract_params()
    from repro_torch import tree as tree_lib

    assert sum(x.numel() for x in tree_lib.leaves(params)) == n
    arch = family.of(FULL).arch(dm, FULL)
    assert (arch.rope, arch.moe.dropless, arch.moe.renormalize, arch.ssm.inner_norms) == (
        False, True, False, True)


def test_the_leaves_mambas_initialisation_fixes():
    fam, dm, _, params = _setup()
    for b, kind in zip(params["blocks"], dm.kinds):
        if kind != "mamba":
            continue
        m = b["mamba"]
        assert torch.equal(m["A_log"], torch.log(torch.arange(1.0, 17.0)).expand(dm.inner, 16))
        assert torch.equal(m["D"], torch.ones(dm.inner))
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
        assert dt.log().std() > 0.5  # log-uniform over two decades
    assert fam.leaves(params)[0] is params["embed"]["table"]


def _decode(m, params, tokens, steps):
    """The port's prefill of ``tokens`` (B, T), then ``steps`` decode steps
    feeding the argmax: (logits (B, steps + 1, V), the tokens fed, the
    routes recorded: one (B, T + steps, K) tensor a MoE layer)."""
    from repro_torch.models.moe import record_routes

    B, T = tokens.shape
    with torch.inference_mode(), record_routes() as got:
        lg, filled = m.prefill(params, {"tokens": tokens})
        cache = m.decode_cache(filled, T + steps + 1)
        out, fed = [lg], [tokens]
        for i in range(steps):
            nxt = out[-1].argmax(-1, keepdim=True)
            fed.append(nxt)
            lg, cache = m.decode_step(params, {"tokens": nxt}, cache, T + i)
            out.append(lg)
    n = len(got) // (steps + 1)
    routes = [torch.cat([got[j].view(B, T, -1)] + [got[(i + 1) * n + j].view(B, 1, -1)
                                                   for i in range(steps)], dim=1)
              for j in range(n)]
    return torch.stack(out, dim=1), torch.cat(fed, dim=1), routes


def test_prefill_and_decode_match_the_reference():
    """Prefill, then 14 decode steps through the cache, against the
    reference's one full forward: summation order only."""
    fam, dm, m, params = _setup()
    tokens = torch.randint(0, dm.vocab, (3, 11), generator=torch.Generator().manual_seed(8))
    logits, fed, routes = _decode(m, params, tokens, 14)
    assert len(routes) == dm.moe_layers and routes[0].shape == (3, 25, 2)
    ref, gap, taken = fam.run(params, fed, dm, logits_from=10, routes=routes)
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-5)
    assert gap == 0.0  # the program chose the reference's own experts
    free, gap, own = fam.run(params, fed, dm, logits_from=10)
    torch.testing.assert_close(free, ref, rtol=0, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(own, routes))
    torch.testing.assert_close(fam.forward(params, fed, dm, logits_from=10), free)


def test_a_route_off_the_top_set_reads_its_gap():
    fam, dm, _, params = _setup()
    tokens = torch.randint(0, dm.vocab, (2, 9), generator=torch.Generator().manual_seed(9))
    probs: list = []
    _, gap, own = fam.run(params, tokens, dm, probs=probs)
    assert gap == 0.0 and len(probs) == dm.moe_layers
    moved = [r.clone() for r in own]
    least = probs[2][1, 4].argmin()
    moved[2][1, 4, 1] = least
    _, gap, _ = fam.run(params, tokens, dm, routes=moved)
    kth = probs[2][1, 4].sort(descending=True).values[1]
    assert gap == pytest.approx(float(kth - probs[2][1, 4, least]), rel=1e-6) and gap > 0.05


def _run(controls=False, trace_on=False):
    wl = tiny.workload(CELL, check=dict(tiny.workload(CELL)["check"], requests=10**6))
    return tiny.run(CELL, wl, config(), controls=controls, trace=trace_on)


def test_a_sound_run_is_correct_and_its_control_is_not():
    res, out = _run(controls=True)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"max_gap", "logit_err", "route_gap"}
    ok, checks = judge.verdict(out["readings"]["control_tf32"], tiny.workload(CELL)["check"]["limits"])
    assert not ok, checks


def _arch_patch(monkeypatch, **over):
    """The family's ``ArchConfig`` with fields changed (the weights' layout
    kept)."""
    fam = family.of(config())
    orig = fam.arch

    def arch(dm, cfg):
        a = orig(dm, cfg)
        moe_over = {k: over.pop(k) for k in ("dropless", "renormalize") if k in over}
        if moe_over:
            a = dataclasses.replace(a, moe=dataclasses.replace(a.moe, **moe_over))
        return dataclasses.replace(a, **over)

    monkeypatch.setattr(fam, "arch", arch)


def _capacity(monkeypatch):
    """The GShard capacity path (1.25), which drops tokens at decode."""
    _arch_patch(monkeypatch, dropless=False)


def _renormalised(monkeypatch):
    _arch_patch(monkeypatch, renormalize=True)


def _rope(monkeypatch):
    _arch_patch(monkeypatch, rope=True)


def _norms_skipped(monkeypatch):
    from repro_torch.models import mamba

    monkeypatch.setattr(mamba, "_inner_norms", lambda p, dt, B, C, eps: (dt, B, C))


def _state_unchanged(monkeypatch):
    """A Mamba decode step that hands back the SSM state it was given."""
    from repro_torch.models import mamba

    orig = mamba.mamba_apply

    def broken(params, x, cfg, rules=None, **kw):
        out = orig(params, x, cfg, **kw) if rules is None else orig(params, x, cfg, rules, **kw)
        if kw.get("ssm_state") is not None:
            return out[0], kw["ssm_state"], out[2]
        return out

    monkeypatch.setattr(mamba, "mamba_apply", broken)


def _route_moved(monkeypatch):
    """One recorded route moved to the reference's least likely expert."""
    fam = family.of(config())
    orig = fam.run

    def run(params, tokens, dm, *, routes=None, **kw):
        if routes is not None:
            probs: list = []
            orig(params, tokens, dm, probs=probs, **kw)
            routes = [r.clone() for r in routes]
            routes[0][0, 3, 0] = probs[0][0, 3].argmin()
        return orig(params, tokens, dm, routes=routes, **kw)

    monkeypatch.setattr(fam, "run", run)


@pytest.mark.parametrize("fault", [_capacity, _renormalised, _rope, _norms_skipped,
                                   _state_unchanged, _route_moved],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_jamba_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res, _ = _run()
    assert not res["correct"], res["checks"]


def test_the_capacity_fault_drops_tokens_at_the_cells_size():
    """The capacity path's fault is a real one at the CPU size: some decode
    step gives an expert more tokens than its int(1.25 * 4 * 2 / 4) = 2
    slots."""
    fam, dm, m, params = _setup()
    wl = tiny.workload(CELL)
    tokens = torch.randint(0, dm.vocab, (wl["batch"], 16), generator=torch.Generator().manual_seed(4))
    _, _, routes = _decode(m, params, tokens, 20)
    slots = int(1.25 * wl["batch"] * dm.top_k / dm.experts)
    most = max(int(torch.bincount(r[:, t].reshape(-1), minlength=dm.experts).max())
               for r in routes for t in range(16, 36))
    assert most > slots == 2


def test_a_family_without_experts_runs_with_route_gap_zero():
    res, out = tiny.run(CELL, tiny.workload(CELL), tiny.config())
    assert res["correct"] and out["numbers"]["route_gap"] == 0.0


# -- the readers, on synthetic host-ops traces --------------------------------


def _steps(moe_us=30, mamba_us=20, prefill=False):
    """Two decode steps, each with an attention span, a MoE span and a
    mamba span holding one launch each, and one launch in the step outside
    them; optionally a prefill with a MoE span before them."""
    ev = [_range(trace.TRACE_RANGE, 0, 3000)]
    if prefill:
        ev += [_span("model.prefill", 10, 400), _span("moe.ffn", 20, 100), _launch(90, 30),
               _op(90, 40, 500)]
    for i, t in enumerate((1000, 1800)):
        c = 10 * i
        ev += [_span("model.decode_step", t, 500), _span("mamba.mixer", t + 10, 50),
               _launch(c + 1, t + 20), _op(c + 1, t + 30, mamba_us),
               _span("attn.decode", t + 100, 50), _launch(c + 2, t + 110), _op(c + 2, t + 120, 9),
               _span("moe.ffn", t + 200, 100), _launch(c + 3, t + 210),
               _op(c + 3, t + 220, moe_us), _launch(c + 4, t + 400), _op(c + 4, t + 410, 4)]
    return ev


def test_named_spans_attribute_within_the_decode_steps():
    a = named_spans.attribute(_steps(prefill=True), named_spans.DECODE_SPANS,
                              within="model.decode_step")
    assert a["count"]["model.decode_step"] == 2 and a["count"]["moe.ffn"] == 3
    assert a["device_s"] == pytest.approx({"mamba.mixer": 40e-6, "attn.decode": 18e-6,
                                           "moe.ffn": 60e-6, "model.decode_step": 8e-6},
                                          abs=1e-15)
    whole = named_spans.attribute(_steps(prefill=True), named_spans.DECODE_SPANS)
    assert whole["device_s"]["moe.ffn"] == pytest.approx(560e-6, abs=1e-15)


def _jamba_record(tmp_path, monkeypatch, events, experts=(2, 3, 2, 2)):
    rec = _record(tmp_path, monkeypatch, CELL, events)
    dm = family.of(FULL).dims(FULL)
    units = [{"kind": "decode", "rows": 32, "position": 1500 + i, "experts": list(experts)}
             for i in range(2)]
    return dict(rec, family="jamba", dims=dm, span_units=units), dm


def test_the_jamba_readers_divide_exactly(tmp_path, monkeypatch):
    read = {m: cell.reader(m) for m in ("moe_ms.decode", "mamba_ms.decode",
                                         "moe_roofline.decode", "mamba_roofline.decode")}
    rec, dm = _jamba_record(tmp_path, monkeypatch, _steps(prefill=True))
    fam = family.load("jamba")
    assert read["moe_ms.decode"](rec) == pytest.approx(0.03, rel=1e-12)
    assert read["mamba_ms.decode"](rec) == pytest.approx(0.02, rel=1e-12)
    want = 100.0 * 2 * fam.moe_bytes(dm, 32, [2, 3, 2, 2]) / cost.HBM_BW / 60e-6
    assert read["moe_roofline.decode"](rec) == pytest.approx(want, rel=1e-12)
    want = 100.0 * 2 * fam.mamba_bytes(dm, 32) / cost.HBM_BW / 40e-6
    assert read["mamba_roofline.decode"](rec) == pytest.approx(want, rel=1e-12)
    # the least bytes count the experts routed to: 9 of 64 here
    assert fam.moe_bytes(dm, 32, [2, 3, 2, 2]) == 4 * (
        (9 / 4) * 3 * 4096 * 14336 + 4096 * 16 + 2 * 32 * 4096) * 4


@pytest.mark.parametrize("metric", ["moe_ms.decode", "mamba_ms.decode", "moe_roofline.decode",
                                    "mamba_roofline.decode"])
def test_each_jamba_reader_finds_nothing_without_its_spans(metric, tmp_path, monkeypatch):
    read = cell.reader(metric)
    rec, _ = _jamba_record(tmp_path, monkeypatch, None)
    assert read(rec) is None                        # traced, no file
    assert read(dict(rec, trace=None)) is None      # not traced
    # a program that opens only the step spans (a parent without them)
    ev = [e for e in _steps() if e["name"] not in ("moe.ffn", "mamba.mixer")]
    rec, _ = _jamba_record(tmp_path, monkeypatch, ev)
    assert read(rec) is None
    # a record whose steps are not the trace's
    if "roofline" in metric:
        rec, _ = _jamba_record(tmp_path, monkeypatch, _steps())
        assert read(rec) is not None
        assert read(dict(rec, span_units=rec["span_units"][:1])) is None


def test_the_decode_step_costs_at_the_full_size():
    fam = family.of(FULL)
    dm = fam.dims(FULL)
    # every weight once, all 64 experts: 53.18 GB, plus 32 rows' states and k/v
    nbytes = fam.decode_bytes(dm, 32, 2047)
    weights_b = 4 * sum(math.prod(s) for _, s, _, _ in fam.leaf_specs(dm)) - 4 * 65536 * 4096
    kv = 32 * 2049 * 2 * 8 * 128 * 4
    states = 2 * 7 * 32 * (8192 * 16 + 3 * 8192) * 4
    assert nbytes == weights_b + 32 * 4096 * 4 + kv + states
    assert 52e9 < nbytes < 54e9
    # a token's products: 7 mixers, attention, 4 dense MLPs, 4 x (router, 2 experts)
    active = (7 * (4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096)
              + 4096 * (4096 + 2 * 1024) + 4096 * 4096 + 4 * 3 * 4096 * 14336
              + 4 * (4096 * 16 + 2 * 3 * 4096 * 14336))
    assert fam.decode_flops(dm, 32, 99) == 2.0 * 32 * (active + 65536 * 4096) + (
        4.0 * 32 * 32 * 128 * 100)
    with pytest.raises(NotImplementedError):
        fam.train_flops(dm, 2, 16)


def test_the_family_refuses_what_the_port_lacks():
    fam = family.of(FULL)
    for over in ({"tie_word_embeddings": True}, {"mamba_proj_bias": True},
                 {"mamba_conv_bias": False}, {"sliding_window": 4096}, {"tf32": True},
                 {"num_hidden_layers": 12}):
        with pytest.raises(ValueError):
            fam.dims(dict(FULL, **over))


def test_the_workload_is_the_cells_traffic():
    wl = cell.workload(CELL)
    assert (wl["batch"], wl["prompt_lengths"], wl["output_tokens"], wl["cache_positions"]) == (
        32, [1024], 3072, 4096)
    assert (wl["close_at"], wl["setup_boundaries"], wl["trace_boundaries"],
            wl["driver"]) == ("step", 3, 16, "serve_routed")
    assert wl["check"]["requests"] == 8
    assert set(wl["check"]["limits"]) == {"max_gap", "logit_err", "route_gap"}
    assert json.loads(json.dumps(wl)) == wl
