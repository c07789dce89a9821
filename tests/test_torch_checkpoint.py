"""The port's checkpointer: every case of ``tests/test_checkpoint.py`` on the
port, checkpoints crossing between the two packages in both directions,
bf16 state bit for bit, and the synchronous host fetch."""
import os

import jax
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro_torch import tree as tree_lib
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _unflatten


def _tree(step):
    return {"params": {"w": np.full((4, 4), float(step)),
                       "blocks": (np.arange(3.0), np.ones(2))},
            "meta": {"step": np.int32(step)}}


def _assert_trees_equal(got, want):
    got_leaves, want_leaves = tree_lib.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The cases of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(7, _tree(7))
    step, tree = ck.restore()
    assert step == 7
    np.testing.assert_array_equal(tree["params"]["w"], _tree(7)["params"]["w"])
    assert isinstance(tree["params"]["blocks"], tuple)


def test_flatten_unflatten_identity():
    t = _tree(3)
    back = _unflatten(_flatten(t))
    _assert_trees_equal(back, t)


def test_torn_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _tree(1))
    # simulate a torn write at a later step: npz without manifest
    with open(os.path.join(tmp_path, "ckpt_00000002.npz"), "wb") as f:
        f.write(b"garbage")
    step, tree = ck.restore()
    assert step == 1  # fell back to the latest VALID checkpoint


def test_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in range(5):
        ck.save(s, _tree(s))
    assert ck.valid_steps() == [3, 4]


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(11, _tree(11))
    ck.wait()
    assert ck.latest_step() == 11


def test_auto_resume_training(tmp_path):
    from repro_torch.launch.train import train_loop
    r1 = train_loop("stablelm-3b", steps=6, batch=2, seq=8, ckpt_dir=str(tmp_path),
                    ckpt_every=3, verbose=False, device="cpu")
    assert r1.steps_run == 6
    # "crash" and resume: loop continues from the checkpoint, runs fewer steps
    r2 = train_loop("stablelm-3b", steps=9, batch=2, seq=8, ckpt_dir=str(tmp_path),
                    ckpt_every=3, verbose=False, device="cpu")
    assert r2.resumed_from is not None
    assert r2.steps_run < 9  # only the remaining steps ran


def test_restore_missing_dir(tmp_path):
    ck = Checkpointer(str(tmp_path / "empty"), async_save=False)
    step, tree = ck.restore()
    assert step is None and tree is None


# ---------------------------------------------------------------------------
# Across the two packages, bf16, in-place updates
# ---------------------------------------------------------------------------


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    JaxCheckpointer(str(tmp_path), async_save=False).save(4, _tree(4))
    step, tree = Checkpointer(str(tmp_path)).restore()
    assert step == 4
    assert isinstance(tree["params"]["w"], torch.Tensor)
    _assert_trees_equal(tree, _tree(4))


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    port_tree = {"params": {"w": torch.full((4, 4), 4.0, dtype=torch.float64),
                            "blocks": [torch.arange(3.0, dtype=torch.float64),
                                       torch.ones(2, dtype=torch.float64)]},
                 "meta": {"step": np.int32(4)}}
    Checkpointer(str(tmp_path), async_save=False).save(4, port_tree)
    step, tree = JaxCheckpointer(str(tmp_path)).restore()
    assert step == 4
    _assert_trees_equal(tree, _tree(4))


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    m = (torch.randn(64, generator=g) * 1e-3).to(torch.bfloat16)
    m[:4] = torch.tensor([float("inf"), -0.0, 1e-40, float("nan")])  # edge bit patterns
    tree = {"opt": {"m": m, "step": torch.tensor(3, dtype=torch.int32)},
            "params": {"w": torch.randn(3, 5, generator=g)}}
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(0, tree)
    _, back = ck.restore()
    assert back["opt"]["m"].dtype == torch.bfloat16
    assert torch.equal(back["opt"]["m"].view(torch.int16), m.view(torch.int16))
    assert back["opt"]["step"].dtype == torch.int32 and int(back["opt"]["step"]) == 3
    assert torch.equal(back["params"]["w"], tree["params"]["w"])
    with np.load(os.path.join(tmp_path, "ckpt_00000000.npz")) as z:
        assert z["opt/m::bfloat16"].dtype == np.uint16  # the bit pattern


def test_save_fetches_to_the_host_before_returning(tmp_path):
    """The train loop updates parameters in place right after a save: the
    checkpoint must hold the values at the save."""
    w = torch.zeros(1000)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, {"w": w})
    w.add_(1.0)  # the next step, in place, while the write may be running
    ck.wait()
    _, back = ck.restore()
    assert float(back["w"].abs().max()) == 0.0
