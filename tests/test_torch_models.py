"""Port model (plain versions on the CPU) against the JAX model.

The JAX parameters are carried over with ``repro_torch.weights
.params_from_jax``; prefill logits and the populated decode cache (k/v, or
the recurrent state through ``cache_from_jax``), and three teacher-forced
decode steps, are compared at the tolerances of ``tests/test_decode.py``.
Tokens are made with numpy from a seed.
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
from repro.configs.base import list_archs as jax_list_archs
from repro.models import attention as jax_attention
from repro.models.model_zoo import Model as JaxModel
from repro.models.transformer import RunConfig as JaxRunConfig
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.models import attention
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.models.transformer import RunConfig, init_params
from repro_torch.weights import cache_from_jax, params_from_jax

# (arch, num_kv_heads override, MoE capacity factor): reduced yi-9b has 4
# heads over 4 KV heads, so the overrides give GQA (G = 2) and MQA (G = 4);
# starcoder2 has the GELU MLP, pixtral the patch-embedding frontend.  jamba
# holds mamba blocks and MoE FFNs beside one attention block, xlstm sLSTM
# and mLSTM blocks, grok and arctic (dense residual) MoE FFNs.  Each MoE
# arch runs at the default capacity factor, where one-token-per-sequence
# decode steps drop tokens (C = 1), and at 16, where nothing drops (as
# tests/test_decode.py runs it).
VARIANTS = [("yi-9b", None, None), ("yi-9b", 2, None), ("yi-9b", 1, None),
            ("starcoder2-15b", None, None), ("pixtral-12b", None, None),
            ("jamba-1.5-large-398b", None, 1.25), ("jamba-1.5-large-398b", None, 16.0),
            ("xlstm-350m", None, None),
            ("grok-1-314b", None, 1.25), ("grok-1-314b", None, 16.0),
            ("arctic-480b", None, 1.25), ("arctic-480b", None, 16.0)]
IDS = [a + (f"-kv{kv}" if kv else "") + (f"-cf{cf:g}" if cf else "")
       for a, kv, cf in VARIANTS]
B, S, EXTRA = 2, 8, 3


def _configs(arch, kv):
    jcfg, tcfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if kv is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
        tcfg = dataclasses.replace(tcfg, num_kv_heads=kv)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _init(arch, kv):
    """JAX parameters (they do not depend on the capacity factor)."""
    jparams, _ = JaxModel(_configs(arch, kv)[0]).init(jax.random.key(0))
    return jparams, jax.tree.map(np.asarray, jax.device_get(jparams))


@functools.lru_cache(maxsize=None)
def _setup(arch, kv, cf):
    jcfg, tcfg = _configs(arch, kv)
    jrcfg, trcfg = ((JaxRunConfig(), RunConfig()) if cf is None else
                    (JaxRunConfig(capacity_factor=cf), RunConfig(capacity_factor=cf)))
    jm = JaxModel(jcfg, jrcfg)
    jparams, np_params = _init(arch, kv)
    tm = Model(tcfg, trcfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    embeds = (rng.standard_normal((B, S + EXTRA, jcfg.frontend_dim), dtype=np.float32)
              if jcfg.frontend else None)
    return jm, jparams, np_params, tm, params_from_jax(np_params, device="cpu"), toks, embeds


def _assert_states_match(port_cache, jax_cache, atol, recurrent_only=False):
    want = cache_from_jax(jax.tree.map(np.asarray, jax.device_get(jax_cache)))
    assert len(port_cache) == len(want)
    for l, (got, exp) in enumerate(zip(port_cache, want)):
        assert got.keys() == exp.keys(), l
        if recurrent_only and "k" in got:
            continue
        for name in got:
            assert got[name].dtype == exp[name].dtype, (l, name)
            np.testing.assert_allclose(got[name].numpy(), exp[name].numpy(),
                                       atol=atol, rtol=0, err_msg=f"layer {l} {name}")


def _batches(toks, embeds, lo, hi):
    jb, tb = {"tokens": jnp.asarray(toks[:, lo:hi])}, {"tokens": torch.from_numpy(toks[:, lo:hi])}
    if embeds is not None:
        jb["embeds"] = jnp.asarray(embeds[:, lo:hi])
        tb["embeds"] = torch.from_numpy(embeds[:, lo:hi])
    return jb, tb


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", list_archs())
def test_configs_are_a_faithful_copy(arch):
    assert list_archs() == jax_list_archs()
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(jax_get_arch(arch))
    assert (dataclasses.asdict(get_arch(arch).reduced())
            == dataclasses.asdict(jax_get_arch(arch).reduced()))


@pytest.mark.parametrize("arch,kv,cf", VARIANTS, ids=IDS)
def test_params_from_jax_copies_every_leaf(arch, kv, cf):
    _, _, np_params, tm, params, _, _ = _setup(arch, kv, cf)
    cfg = tm.cfg
    assert len(params["blocks"]) == cfg.num_layers
    R = cfg.num_pattern_repeats
    for r in range(R):
        for i in range(len(cfg.layer_pattern)):
            jax_block = {p: a[r] for p, a in _leaves(np_params["blocks"][f"pos{i}"])}
            port_block = dict(_leaves(params["blocks"][r * len(cfg.layer_pattern) + i]))
            assert jax_block.keys() == port_block.keys()
            for p, a in jax_block.items():
                np.testing.assert_array_equal(port_block[p].numpy(), a)
    # a fresh port init has exactly the converted structure, shapes and dtypes
    fresh = dict(_leaves(init_params(torch.Generator().manual_seed(0), cfg, RunConfig())))
    conv = dict(_leaves(params))
    assert fresh.keys() == conv.keys()
    for p in fresh:
        assert fresh[p].shape == conv[p].shape and fresh[p].dtype == conv[p].dtype, p


@pytest.mark.parametrize("arch,kv,cf", VARIANTS, ids=IDS)
def test_prefill_matches_jax(arch, kv, cf):
    jm, jparams, _, tm, params, toks, embeds = _setup(arch, kv, cf)
    jb, tb = _batches(toks, embeds, 0, S)
    jlogits, jcache = jm.prefill(jparams, jb)
    with torch.inference_mode():
        tlogits, tcache = tm.prefill(params, tb)
        tfull = tm.forward_logits(params, tb)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tfull[:, -1].numpy(), tlogits.numpy(), atol=1e-5, rtol=0)
    _assert_states_match(tcache, jcache, atol=1e-4)


@pytest.mark.parametrize("arch,kv,cf", VARIANTS, ids=IDS)
def test_teacher_forced_decode_matches_jax(arch, kv, cf):
    jm, jparams, _, tm, params, toks, embeds = _setup(arch, kv, cf)
    jb, tb = _batches(toks, embeds, 0, S)
    _, jcache = jm.prefill(jparams, jb)
    jcache = {key: ({n: jnp.pad(a, ((0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0)))
                     for n, a in val.items()} if "k" in val else val)
              for key, val in jcache.items()}
    with torch.inference_mode():
        _, filled = tm.prefill(params, tb)
        cache = tm.decode_cache(filled, S + EXTRA)
        for i in range(EXTRA):
            jb, tb = _batches(toks, embeds, S + i, S + i + 1)
            jlogits, jcache = jm.decode_step(jparams, jb, jcache, jnp.int32(S + i))
            tlogits, cache = tm.decode_step(params, tb, cache, S + i)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=1e-3, rtol=0)
    _assert_states_match(cache, jcache, atol=1e-3, recurrent_only=True)


def test_decode_attention_writes_cache_in_place_and_matches_jax():
    rng = np.random.default_rng(5)
    Bq, Sc, H, KV, hd, t = 2, 12, 4, 2, 16, 7
    q = rng.standard_normal((Bq, 1, H, hd), dtype=np.float32)
    kn, vn = (rng.standard_normal((Bq, 1, KV, hd), dtype=np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((Bq, Sc, KV, hd), dtype=np.float32) for _ in range(2))
    jo, jk, jv = jax_attention.decode_attention_local(
        *(jnp.asarray(a) for a in (q, kn, vn, kc, vc)), jnp.int32(t))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, rk, rv = attention.decode_attention_local(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv, t)
    assert rk is tk and rv is tv  # updated in place, no copy
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)


def test_rope_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 3, 32), dtype=np.float32)
    pos = np.arange(9)
    want = jax_attention.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = attention.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_init_follows_the_jax_distributions():
    cfg = get_arch("yi-9b").reduced()
    p1 = init_params(torch.Generator().manual_seed(3), cfg, RunConfig())
    p2 = init_params(torch.Generator().manual_seed(3), cfg, RunConfig())
    for (name, a), (_, b) in zip(_leaves(p1), _leaves(p2)):
        assert torch.equal(a, b), name  # the generator alone decides the weights
    wq = p1["blocks"][0]["attn"]["wq"]
    assert wq.abs().max() <= 2.0 / cfg.d_model ** 0.5  # truncated at 2 std
    wo = p1["blocks"][0]["attn"]["wo"]
    assert wo.abs().max() <= 2.0 / (cfg.num_heads * cfg.head_dim) ** 0.5
    assert torch.equal(p1["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert 0.9 < p1["embed"]["table"].std().item() < 1.1


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_builds_prefills_and_decodes_reduced(arch):
    m = build_model(arch, reduced=True, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, m.cfg.vocab_size, (B, S + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :S]}
    step = {"tokens": toks[:, S:]}
    if m.cfg.frontend:
        batch["embeds"] = torch.zeros(B, S, m.cfg.frontend_dim)
        step["embeds"] = torch.zeros(B, 1, m.cfg.frontend_dim)
    with torch.inference_mode():
        logits, filled = m.prefill(params, batch)
        logits2, cache = m.decode_step(params, step, m.decode_cache(filled, S + 1), S)
    assert logits.shape == logits2.shape == (B, m.cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
    assert len(cache) == m.cfg.num_layers


def test_unknown_block_type_raises_value_error():
    cfg = dataclasses.replace(get_arch("yi-9b").reduced(), layer_pattern=("conv",))
    with pytest.raises(ValueError, match="conv"):
        init_params(torch.Generator().manual_seed(0), cfg, RunConfig())
