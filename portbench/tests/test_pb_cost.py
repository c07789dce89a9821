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
from portbench.lib import cell, cost, family

SHAPES = {"yi-9b": dict(num_attention_heads=8, num_key_value_heads=2),
          "stablelm-3b": dict(num_attention_heads=4, num_key_value_heads=4)}
B, T, S = 2, 48, 64  # batch, tokens, decode cache positions


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _walk(arch, fn_of):
    from repro_torch import tree as tree_lib
    from repro_torch.roofline.graph_cost import graph_cost_by_class, trace

    cfg = tiny.config(**SHAPES[arch])
    fam = family.of(cfg)
    dm = fam.dims(cfg)
    m = port.model(fam, dm, cfg, "meta")
    params, _ = m.abstract_params()
    fn, args = fn_of(m, dm, params, tree_lib)
    return fam, dm, graph_cost_by_class(trace(fn, *args))


@pytest.mark.parametrize("arch", SHAPES)
def test_prefill_products_equal_the_walkers(arch):
    def fn_of(m, dm, params, _):
        return (lambda p, b: m.prefill(p, b)[0]), (params, {"tokens": _meta(B, T, dtype=torch.long)})

    fam, dm, by = _walk(arch, fn_of)
    attn = fam.attention_flops(dm, B, T, T)
    assert by["dot"].flops == fam.prefill_flops(dm, B, T) - attn
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

    fam, dm, by = _walk(arch, fn_of)
    walker_attn = 4.0 * B * dm.heads * dm.head_dim * S * dm.layers  # the whole cache
    assert by["dot"].flops == fam.decode_flops(dm, B, pos) - fam.attention_flops(
        dm, B, 1, pos + 1) + walker_attn


@pytest.mark.parametrize("arch", SHAPES)
def test_training_products_equal_the_walkers(arch):
    def fn_of(m, dm, params, tree_lib):
        params = tree_lib.map(lambda t: t.requires_grad_(True), params)
        batch = {"tokens": _meta(B, T, dtype=torch.long), "labels": _meta(B, T, dtype=torch.long)}
        return ((lambda p, b: torch.autograd.grad(m.loss(p, b)[0], tree_lib.leaves(p))),
                (params, batch))

    fam, dm, by = _walk(arch, fn_of)
    attn = 3 * fam.attention_flops(dm, B, T, T)
    assert by["dot"].flops == fam.train_flops(dm, B, T) - attn
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


def test_flash_decode_counts_at_the_decode_cells_shapes():
    # stablelm-3b.decode's call at 16 rows, position 2,500: every filled
    # position's k/v (32 heads of 80) read once, the new one written, q and o
    f, b = cost.flash_decode(16, 2500, 32, 32, 80)
    assert f == 4.0 * 16 * 32 * 80 * 2501
    assert b == 16 * (2501 * 2 * 32 * 80 + 2 * 32 * 80 + 2 * 32 * 80) * 4
    # 32 layers of it, less q and o, are the step's least bytes beyond the
    # weights and the 16 embedding rows
    fam = family.load("llama")
    dm = fam.dims(cell.config(cell.load_benchmark(), "stablelm-3b"))
    kv = dm.layers * (b - 16 * 2 * 32 * 80 * 4)
    assert kv + 16 * 2560 * 4 == fam.decode_bytes(dm, 16, 2500) - fam.decode_bytes(dm, 0, 2500)
    # yi-9b.decode's: 32 query heads over 4 k/v heads of 128; the bytes bound it
    f, b = cost.flash_decode(32, 2000, 32, 4, 128)
    assert b == 32 * (2001 * 2 * 4 * 128 + 2 * 4 * 128 + 2 * 32 * 128) * 4
    assert cost.roofline_s(f, b) == b / cost.HBM_BW
