"""The plain reference against the port's CPU path (its kernels' plain
versions) at reduced sizes of both configurations: prefill, decode through
the cache, the loss and its gradients.  fp32 on both sides; the tolerances
allow summation order only (a TF32 product would miss them by 100x)."""
from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny
from portbench.drivers import port
from portbench.lib import traffic, weights
from portbench.lib.dims import dims
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

# yi-9b's and stablelm-3b's shapes cut down: grouped (4 query heads a k/v
# head) and full multi-head attention; the published rotary bases
SHAPES = {"yi-9b": dict(num_attention_heads=8, num_key_value_heads=2, rope_theta=5e6),
          "stablelm-3b": dict(num_attention_heads=4, num_key_value_heads=4, rope_theta=1e4)}
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(arch: str, seed: int = 2**31 + 99):
    cfg = tiny.config(**SHAPES[arch])
    dm = dims(cfg)
    m = port.model(dm, cfg, torch.device("cpu"))
    params = weights.make(dm, seed, "cpu")
    port.check_layout(m, params)
    return cfg, dm, m, params


@pytest.mark.parametrize("arch", SHAPES)
def test_prefill_and_decode_match_the_reference(arch):
    cfg, dm, m, params = _setup(arch)
    wl = {"batch": 3, "prompt_lengths": [20]}
    prompts = traffic.prompts(dm, wl, 5, 0, "cpu")
    with torch.inference_mode():
        last, filled = m.prefill(params, {"tokens": prompts})
        cache = m.decode_cache(filled, 32)
        toks, logits = [last.argmax(-1)], [last]
        for i in range(6):
            lg, cache = m.decode_step(params, {"tokens": toks[-1][:, None]}, cache, 20 + i)
            logits.append(lg)
            toks.append(lg.argmax(-1))
        seq = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
        ref = ref_model.forward(params, seq, dm, logits_from=19)
    torch.testing.assert_close(torch.stack(logits, 1), ref, **TOL)


@pytest.mark.parametrize("arch", SHAPES)
def test_loss_and_gradients_match_the_reference(arch):
    cfg, dm, m, params = _setup(arch)
    batch = traffic.train_batch(dm, {"batch": 2, "seq_len": 24}, 9, 0, "cpu")
    leaves = weights.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = m.loss(params, batch)
    got = torch.autograd.grad(loss, leaves)
    ref_loss = ref_model.loss(params, batch["tokens"], batch["labels"], dm, remat=True)
    want = torch.autograd.grad(ref_loss, leaves)
    torch.testing.assert_close(loss, ref_loss, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 1.0 + 2**-12, -3.0 - 2**-9])
    assert ref_model.to_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9]


def test_the_reference_schedule_warms_up_then_decays():
    opt = {"lr": 1.0, "warmup_steps": 10, "total_steps": 110, "schedule": "cosine"}
    assert ref_train.lr_at(opt, 5) == 0.5 and ref_train.lr_at(opt, 10) == 1.0
    assert abs(ref_train.lr_at(opt, 60) - 0.5) < 1e-12 and ref_train.lr_at(opt, 110) < 1e-12
