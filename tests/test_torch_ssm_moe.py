"""The port's mamba, MoE and xLSTM modules and the LM loss against the JAX
package's, on the CPU.

Each module gets the JAX initialiser's parameters (copied) and the same
inputs, made with numpy from a seed, and must give the JAX outputs and
states: the full-sequence pass, the state it leaves, and a decode step from
that state.  MoE is held at a capacity factor that drops tokens, on a batch
that overflows one expert, and on router probabilities that tie exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.configs.base import XLSTMConfig as JaxXLSTMConfig
from repro.configs.base import get_arch as jax_get_arch
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.models.model_zoo import Model as JaxModel
from repro.models.transformer import RunConfig as JaxRunConfig
from repro.parallel.sharding_rules import AxisRules
from repro_torch.configs.base import MoEConfig, SSMConfig, XLSTMConfig, get_arch
from repro_torch.models import layers, mamba, moe, transformer, xlstm
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import RunConfig
from repro_torch.weights import params_from_jax

RULES = AxisRules.null()
D, H = 32, 4


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(tree):
    """numpy / JAX tree -> torch tree (copies)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, atol, msg=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), msg
        for k in want:
            _close(got[k], want[k], atol, f"{msg}/{k}")
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0,
                               err_msg=msg)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# -- mamba ----------------------------------------------------------------------


def test_conv_causal_is_an_unflipped_causal_cross_correlation():
    x = _x(0, 2, 7, 6)
    w = _x(1, 4, 6)          # asymmetric taps: a flipped kernel would differ
    b = _x(2, 6)
    want = jmamba._conv_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = mamba._conv_causal(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _close(got, want, 1e-5)
    # by hand at t = 5, channel 3: taps w[0..3] on x[2..5]
    hand = sum(w[j, 3] * x[0, 2 + j, 3] for j in range(4)) + b[3]
    assert abs(got[0, 5, 3].item() - hand) < 1e-5


@pytest.mark.parametrize("what", ["conv", "moe", "embedding"])
def test_forms_under_enabled_rules_equal_the_plain_forms(what):
    """Under enabled rules the mamba conv is W shifted multiply-adds, the
    MoE combine a bmm and the embedding ``F.embedding`` (forms DTensor can
    lay out); under disabled rules each keeps its plain form.  On plain
    tensors, where every ``constrain`` is the identity, both give the same
    result."""
    from repro_torch.parallel.sharding_rules import AxisRules as PortRules

    pod, null = PortRules.pod(), PortRules.null()
    if what == "conv":
        x, w, b = (torch.from_numpy(a) for a in (_x(0, 2, 9, 6), _x(1, 4, 6), _x(2, 6)))
        got, want = mamba._conv_causal(x, w, b, pod), mamba._conv_causal(x, w, b, null)
        assert torch.allclose(got, want, atol=1e-6, rtol=0)
    elif what == "moe":
        _, cfg, _, tp = _moe_setup("dense-residual")
        x = torch.from_numpy(_x(3, 2, 8, D))
        (got, got_aux), (want, want_aux) = (moe.moe_apply(tp, x, cfg, r) for r in (pod, null))
        assert torch.allclose(got, want, atol=1e-6, rtol=0) and got_aux == want_aux
    else:
        table = torch.from_numpy(_x(4, 32, 8))
        tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 32, (2, 5), np.int32))
        got = layers.embedding_lookup({"table": table}, tokens, pod)
        assert torch.equal(got, layers.embedding_lookup({"table": table}, tokens, null))


@pytest.mark.parametrize("S", [8, 2])  # S < W-1 left-pads the conv state
def test_mamba_apply_full_sequence_state_and_decode_match_jax(S):
    cfg, jcfg = SSMConfig(), JaxSSMConfig()
    jp = jlayers.values(jmamba.mamba_init(jax.random.key(3), D, jcfg))
    tp = _t(_np(jp))
    assert tp["A_log"].dtype == tp["D"].dtype == torch.float32
    x, step = _x(4, 2, S, D), _x(5, 2, 1, D)

    jy, jssm, jconv = jmamba.mamba_apply(jp, jnp.asarray(x), jcfg, RULES, return_state=True)
    ty, tssm, tconv = mamba.mamba_apply(tp, torch.from_numpy(x), cfg, return_state=True)
    _close(ty, jy, 1e-4)
    _close(tssm, jssm, 1e-4)
    _close(tconv, jconv, 0)
    assert tuple(tssm.shape) == mamba.mamba_state_shapes(2, D, cfg)["ssm"]
    assert tuple(tconv.shape) == mamba.mamba_state_shapes(2, D, cfg)["conv"]
    # the plain full pass gives the same output
    _close(mamba.mamba_apply(tp, torch.from_numpy(x), cfg), jy, 1e-4)

    jy1, jssm1, jconv1 = jmamba.mamba_apply(jp, jnp.asarray(step), jcfg, RULES,
                                            ssm_state=jssm, conv_state=jconv,
                                            return_state=True)
    ty1, tssm1, tconv1 = mamba.mamba_apply(tp, torch.from_numpy(step), cfg,
                                           ssm_state=tssm, conv_state=tconv,
                                           return_state=True)
    _close(ty1, jy1, 1e-4)
    _close(tssm1, jssm1, 1e-4)
    _close(tconv1, jconv1, 1e-6)


def test_mamba_scan_chunks_do_not_change_the_result(monkeypatch):
    cfg = SSMConfig()
    tp = _t(_np(jlayers.values(jmamba.mamba_init(jax.random.key(3), D, JaxSSMConfig()))))
    x = torch.from_numpy(_x(6, 2, 11, D))
    whole = mamba.mamba_apply(tp, x, cfg, return_state=True)
    monkeypatch.setattr(mamba, "SCAN_CHUNK", 3)
    chunked = mamba.mamba_apply(tp, x, cfg, return_state=True)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# -- MoE ------------------------------------------------------------------------


MOE_CASES = {
    "gated": dict(num_experts=4, top_k=2, expert_d_ff=16),
    "gelu": dict(num_experts=4, top_k=2, expert_d_ff=16),
    "dense-residual": dict(num_experts=8, top_k=2, expert_d_ff=16, dense_residual=True,
                           dense_d_ff=24),
    "top1": dict(num_experts=4, top_k=1, expert_d_ff=16),
}


def _moe_setup(case, seed=7):
    kw = MOE_CASES[case]
    gated = case != "gelu"
    jp = jlayers.values(jmoe.moe_init(jax.random.key(seed), D, JaxMoEConfig(**kw),
                                      gated=gated))
    return JaxMoEConfig(**kw), MoEConfig(**kw), jp, _t(_np(jp))


def _moe_both(jcfg, cfg, jp, tp, x, **kw):
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, RULES, **kw)
    ty, taux = moe.moe_apply(tp, torch.from_numpy(x), cfg, **kw)
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("cf", [1.25, 16.0])
def test_moe_apply_matches_jax(case, cf):
    jcfg, cfg, jp, tp = _moe_setup(case)
    # 24 tokens, group size 16 halves to 8: three groups
    x = _x(8, 2, 12, D)
    (jy, jaux), (ty, taux) = _moe_both(jcfg, cfg, jp, tp, x, capacity_factor=cf,
                                       group_size=16)
    _close(ty, jy, 1e-5)
    _close(taux, jaux, 1e-6)


def test_moe_overflow_drops_the_same_tokens_as_jax():
    jcfg, cfg, jp, tp = _moe_setup("gated")
    # a router that sends every token to expert 2 first: capacity
    # int(1.25 * 16 * 2 / 4) = 10 of 16 tokens keep their first slot
    router = np.zeros((D, 4), np.float32)
    router[0, 2] = 50.0
    router[0, 1] = 10.0
    x = _x(9, 1, 16, D)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    (jy, jaux), (ty, taux) = _moe_both(jcfg, cfg, jp, tp, x)
    _close(ty, jy, 1e-5)
    _close(taux, jaux, 1e-6)
    # tokens 10.. lost their expert-2 slot and keep only expert 1's share
    no_drop, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg, capacity_factor=16.0)
    assert torch.allclose(ty[0, :10], no_drop[0, :10], atol=1e-6)
    assert not torch.allclose(ty[0, 10:], no_drop[0, 10:], atol=1e-3)
    assert float(taux) == pytest.approx(4.0 * 1.0 * float(
        torch.softmax(torch.from_numpy(x[0] @ router), -1)[:, 2].mean()), rel=1e-5)


def test_moe_exact_router_ties_break_toward_the_lower_expert():
    jcfg, cfg, jp, tp = _moe_setup("gated")
    # columns 1 and 3 equal and largest, 0 and 2 equal: every token's
    # probabilities tie exactly in pairs
    router = np.zeros((D, 4), np.float32)
    router[:, 1] = router[:, 3] = np.abs(_x(10, D))
    router[:, 0] = router[:, 2] = np.abs(_x(10, D)) * 0.1
    x = np.abs(_x(11, 2, 8, D))
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(router), -1)
    assert torch.equal(probs[..., 1], probs[..., 3])
    w, idx = moe._top_k(probs, 2)
    jw, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert (idx == torch.tensor([1, 3])).all()
    (jy, jaux), (ty, taux) = _moe_both(jcfg, cfg, jp, tp, x)
    _close(ty, jy, 1e-5)
    _close(taux, jaux, 1e-6)


# -- xLSTM ----------------------------------------------------------------------


@pytest.mark.parametrize("S", [6, 1])
def test_slstm_apply_and_decode_match_jax(S):
    jcfg, cfg = JaxXLSTMConfig(), XLSTMConfig()
    jp = jlayers.values(jxlstm.slstm_init(jax.random.key(12), D, H, jcfg))
    tp = _t(_np(jp))
    x, step = _x(13, 2, S, D) * 2.0, _x(14, 2, 1, D)
    jy, jst = jxlstm.slstm_apply(jp, jnp.asarray(x), H, RULES, return_state=True)
    ty, tst = xlstm.slstm_apply(tp, torch.from_numpy(x), H, return_state=True)
    _close(ty, jy, 1e-5)
    _close(tst, jst, 1e-5)
    _close(xlstm.slstm_apply(tp, torch.from_numpy(x), H), jy, 1e-5)
    _close(xlstm.slstm_init_state(2, D), jxlstm.slstm_init_state(2, D), 0)
    jy1, jst1 = jxlstm.slstm_apply(jp, jnp.asarray(step), H, RULES, state=jst,
                                   return_state=True)
    ty1, tst1 = xlstm.slstm_apply(tp, torch.from_numpy(step), H, state=tst,
                                  return_state=True)
    _close(ty1, jy1, 1e-5)
    _close(tst1, jst1, 1e-5)


@pytest.mark.parametrize("S", [6, 1])
def test_mlstm_apply_and_decode_match_jax(S):
    jcfg, cfg = JaxXLSTMConfig(), XLSTMConfig()
    jp = jlayers.values(jxlstm.mlstm_init(jax.random.key(15), D, H, jcfg))
    tp = _t(_np(jp))
    x, step = _x(16, 2, S, D) * 2.0, _x(17, 2, 1, D)
    jy, jst = jxlstm.mlstm_apply(jp, jnp.asarray(x), H, jcfg, RULES, return_state=True)
    ty, tst = xlstm.mlstm_apply(tp, torch.from_numpy(x), H, cfg, return_state=True)
    _close(ty, jy, 1e-5)
    _close(tst, jst, 1e-5)
    _close(xlstm.mlstm_apply(tp, torch.from_numpy(x), H, cfg), jy, 1e-5)
    dh = xlstm._round64(cfg.proj_factor_mlstm * D) // H
    _close(xlstm.mlstm_init_state(2, H, dh), jxlstm.mlstm_init_state(2, H, dh), 0)
    jy1, jst1 = jxlstm.mlstm_apply(jp, jnp.asarray(step), H, jcfg, RULES, state=jst,
                                   return_state=True)
    ty1, tst1 = xlstm.mlstm_apply(tp, torch.from_numpy(step), H, cfg, state=tst,
                                  return_state=True)
    _close(ty1, jy1, 1e-5)
    _close(tst1, jst1, 1e-5)


@pytest.mark.parametrize("x", [1.0, 64.0, 1365.33, 2048.0, 4096.0 / 3.0])
def test_round64_matches_jax(x):
    assert xlstm._round64(x) == jxlstm._round64(x)


# -- loss -----------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(18)
    logits = rng.standard_normal((2, 5, 11), dtype=np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                         None if mask is None else jnp.asarray(mask))
    got = layers.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, 1e-5)
    if masked:  # an all-zero mask divides by 1, not 0
        zero = layers.softmax_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(labels), torch.zeros(2, 5))
        assert float(zero) == 0.0


@pytest.mark.parametrize("arch", ["grok-1-314b", "jamba-1.5-large-398b", "xlstm-350m"])
def test_loss_fn_model_loss_and_param_count_match_jax(arch):
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jm = JaxModel(jcfg, JaxRunConfig())
    leafs = jtransformer.init_params(jax.random.key(0), jcfg, JaxRunConfig())
    jparams = jlayers.values(leafs)          # what jm.init returns
    params = params_from_jax(_np(jparams))
    rng = np.random.default_rng(19)
    toks = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) < 0.7).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "mask": torch.from_numpy(mask)}
    jloss, jmet = jax.jit(jm.loss)(jparams, jb)
    tm = Model(tcfg, RunConfig(), device="cpu")
    with torch.inference_mode():
        tloss, tmet = tm.loss(params, tb)
        floss, fmet = transformer.loss_fn(params, tb, tcfg, RunConfig())
    _close(tloss, jloss, 1e-4)
    _close(tmet["ce"], jmet["ce"], 1e-4)
    _close(tmet["moe_aux"], jmet["moe_aux"], 1e-5)
    assert float(floss) == float(tloss)
    if jcfg.moe is not None:
        assert float(tmet["moe_aux"]) > 0
        assert float(tloss) == pytest.approx(
            float(tmet["ce"]) + 0.01 * float(tmet["moe_aux"]), rel=1e-6)
    assert layers.param_count(params) == jlayers.param_count(leafs)
    fresh = transformer.init_params(torch.Generator().manual_seed(0), tcfg, RunConfig())
    assert layers.param_count(fresh) == jlayers.param_count(leafs)


def test_moe_run_config_defaults_are_the_references():
    for name in ("capacity_factor", "moe_group_size", "moe_aux_weight"):
        assert getattr(RunConfig(), name) == getattr(JaxRunConfig(), name), name
    assert dataclasses.asdict(MoEConfig(4, 2, 16)) == dataclasses.asdict(
        JaxMoEConfig(4, 2, 16))
