"""The comparison that decides ``correct``, on the CPU at a small size with
each cell's committed limits: a sound run passes; the control (the
reference in TF32 in the program's place) fails; and a run driven whole,
with the timed path broken underneath, comes out not correct for every
fault the cell can have (one chip, so no exchange between chips)."""
from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny
from portbench.lib import cell, judge

CELLS = tuple(w["name"] for w in cell.load_benchmark()["workloads"])
SERVING = tuple(n for n in CELLS if cell.workload(n)["driver"] == "serve")
TRAINING = tuple(n for n in CELLS if cell.workload(n)["driver"] == "train")


def _serving(name: str) -> dict:
    # every request of the window compared, so a fault in any row shows
    return tiny.workload(name, check=dict(tiny.workload(name)["check"], requests=10**6))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_its_control_is_not(name):
    wl = _serving(name) if name in SERVING else tiny.workload(name)
    res, out = tiny.run(name, wl, tiny.config(), controls=True)
    assert res["correct"], res["checks"]
    limits = wl["check"]["limits"]
    ok, checks = judge.verdict(out["readings"]["control_tf32"], limits)
    assert not ok, checks


def _decode_step_patch(monkeypatch, change):
    from repro_torch.models.model_zoo import Model

    orig = Model.decode_step

    def broken(self, params, batch, cache, t):
        logits, cache = orig(self, params, batch, cache, t)
        return change(logits, t), cache

    monkeypatch.setattr(Model, "decode_step", broken)


def _state_unchanged(monkeypatch):
    """Decode attention that leaves the cache as it found it."""
    from repro_torch.models import attention

    orig = attention.decode_attention_local

    def broken(q, k_new, v_new, k_cache, v_cache, t):
        o, _, _ = orig(q, k_new, v_new, k_cache.clone(), v_cache.clone(), t)
        return o, k_cache, v_cache

    monkeypatch.setattr(attention, "decode_attention_local", broken)


def _half_batch(monkeypatch):
    """The second half of the rows gets the first half's logits."""
    def change(logits, t):
        h = (logits.shape[0] + 1) // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]])
    _decode_step_patch(monkeypatch, change)


def _token_altered(monkeypatch):
    """One request's logits negated, so its token is the least likely."""
    def change(logits, t):
        logits = logits.clone()
        logits[0] = -logits[0]
        return logits
    _decode_step_patch(monkeypatch, change)


@pytest.mark.parametrize("name", SERVING)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_serving_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    res, _ = tiny.run(name, _serving(name), tiny.config())
    assert not res["correct"], res["checks"]


def _train_state_unchanged(monkeypatch):
    """An optimizer step that returns parameters and state as they were."""
    from repro_torch.optim import optimizer

    monkeypatch.setattr(optimizer, "apply_updates",
                        lambda params, grads, state, cfg: (params, state, {}))


def _train_half_batch(monkeypatch):
    """The step's loss and gradient over the first half of the rows."""
    from repro_torch.core.stream_config import StreamConfig
    from repro_torch.launch import train

    orig = train.streamify_train_step

    def broken(loss_fn, config):
        inner = orig(loss_fn, StreamConfig(1, 1))
        return lambda params, batch: inner(
            params, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(train, "streamify_train_step", broken)


def _train_answer_altered(monkeypatch):
    """One leaf's gradient doubled where the backward hands it over."""
    from repro_torch.optim import optimizer

    orig = optimizer.apply_updates

    def broken(params, grads, state, cfg):
        grads["blocks"][0]["ffn"]["w_in"].mul_(2.0)
        return orig(params, grads, state, cfg)

    monkeypatch.setattr(optimizer, "apply_updates", broken)


@pytest.mark.parametrize("fault", [_train_state_unchanged, _train_half_batch,
                                   _train_answer_altered], ids=lambda f: f.__name__.strip("_"))
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    for name in TRAINING:
        res, _ = tiny.run(name, tiny.workload(name), tiny.config())
        assert not res["correct"], (name, res["checks"])
