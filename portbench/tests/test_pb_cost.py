"""The benchmark's FLOP counters held against the port's roofline walker
(``roofline/graph_cost.py``) on reduced sizes of both configurations.

The products of the linear layers and the head are equal.  Attention
differs by design: the walker costs the JAX model's blocked attention,
every (query, key) pair of the padded square, where the benchmark counts
the causal pairs a step needs (T(T+1)/2 of T^2); in decode the walker
counts the whole preallocated cache, the benchmark the filled positions.
"""
from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny
from portbench.drivers import port
from portbench.lib import cost
from portbench.lib.dims import dims

SHAPES = {"yi-9b": dict(num_attention_heads=8, num_key_value_heads=2),
          "stablelm-3b": dict(num_attention_heads=4, num_key_value_heads=4)}
B, T, S = 2, 48, 64  # batch, tokens, decode cache positions


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _walk(arch, fn_of):
    from repro_torch import tree as tree_lib
    from repro_torch.roofline.graph_cost import graph_cost_by_class, trace

    cfg = tiny.config(**SHAPES[arch])
    dm = dims(cfg)
    m = port.model(dm, cfg, "meta")
    params, _ = m.abstract_params()
    fn, args = fn_of(m, dm, params, tree_lib)
    return dm, graph_cost_by_class(trace(fn, *args))


@pytest.mark.parametrize("arch", SHAPES)
def test_prefill_products_equal_the_walkers(arch):
    def fn_of(m, dm, params, _):
        return (lambda p, b: m.prefill(p, b)[0]), (params, {"tokens": _meta(B, T, dtype=torch.long)})

    dm, by = _walk(arch, fn_of)
    attn = cost.attention_flops(dm, B, T, T)
    assert by["dot"].flops == cost.prefill_flops(dm, B, T) - attn
    assert by["attention"].flops == 4.0 * B * dm.heads * dm.head_dim * T * T * dm.layers
    assert attn / by["attention"].flops == (T + 1) / (2 * T)


@pytest.mark.parametrize("arch", SHAPES)
def test_decode_products_equal_the_walkers(arch):
    pos = 40

    def fn_of(m, dm, params, _):
        cache = m.init_cache(B, S)
        cache = [{k: _meta(*v.shape) for k, v in c.items()} for c in cache]
        return ((lambda p, b, c: m.decode_step(p, b, c, pos)[0]),
                (params, {"tokens": _meta(B, 1, dtype=torch.long)}, cache))

    dm, by = _walk(arch, fn_of)
    walker_attn = 4.0 * B * dm.heads * dm.head_dim * S * dm.layers  # the whole cache
    assert by["dot"].flops == cost.decode_flops(dm, B, pos) - cost.attention_flops(
        dm, B, 1, pos + 1) + walker_attn


@pytest.mark.parametrize("arch", SHAPES)
def test_training_products_equal_the_walkers(arch):
    def fn_of(m, dm, params, tree_lib):
        params = tree_lib.map(lambda t: t.requires_grad_(True), params)
        batch = {"tokens": _meta(B, T, dtype=torch.long), "labels": _meta(B, T, dtype=torch.long)}
        return ((lambda p, b: torch.autograd.grad(m.loss(p, b)[0], tree_lib.leaves(p))),
                (params, batch))

    dm, by = _walk(arch, fn_of)
    attn = 3 * cost.attention_flops(dm, B, T, T)
    assert by["dot"].flops == cost.train_flops(dm, B, T) - attn
    # the walker: forward 2 products, backward 4, over the padded square
    assert by["attention"].flops == 12.0 * B * dm.heads * dm.head_dim * T * T * dm.layers


def test_kernel_counts_at_the_cells_shapes():
    # yi-9b's prefill flash call at 4 x 4,088: 2 products on the causal pairs
    f, b = cost.flash_fwd(4, 4088, 4088, 32, 4, 128)
    assert f == 4.0 * 4 * 32 * 128 * 4088 * 4089 // 2
    assert b == (2 * 4 * 4088 * 32 + 2 * 4 * 4088 * 4) * 128 * 4
    # stablelm-3b's backward at 1 x 2,048: 5 products, 2.5x the forward's
    fb, _ = cost.flash_bwd(1, 2048, 2048, 32, 32, 80)
    assert fb == 2.5 * cost.flash_fwd(1, 2048, 2048, 32, 32, 80)[0]
    assert cost.causal_pairs(1, 300) == 300 and cost.causal_pairs(3, 3) == 6
