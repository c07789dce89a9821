"""The port's training stack (plain versions on the CPU) against the JAX
package's: the train step (microbatched gradients and AdamW) from carried
parameters on the same batches, ``train_loop`` and its auto-resume, and the
straggler watchdog.  The card runs the same step through the kernels in
``chip_smoke.py``."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core.stream_config import StreamConfig as JaxStreamConfig
from repro.core.streams import streamify_train_step as jax_streamify_train_step
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch.train import StragglerWatchdog as JaxStragglerWatchdog
from repro.models.model_zoo import Model as JaxModel
from repro.optim import optimizer as jax_opt
from repro_torch import tree as tree_lib
from repro_torch.configs.base import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import (StragglerWatchdog, make_train_step,
                                      train_loop)
from repro_torch.models.model_zoo import Model
from repro_torch.optim import optimizer as opt_lib
from repro_torch.weights import opt_state_from_jax, params_from_jax

STEPS, BATCH, SEQ, MICRO = 5, 4, 16, 2


@pytest.mark.parametrize("arch", ["stablelm-3b", "yi-9b"])
def test_train_steps_match_jax(arch):
    """5 steps of 2 microbatches: JAX's jitted ``streamify_train_step`` and
    ``apply_updates`` against the port's step, from the same parameters on
    the same batches.  Losses within rtol 1e-5 each step, parameters and
    moments within atol 1e-5 after the fifth."""
    jcfg = jax_get_arch(arch).reduced()
    jm = JaxModel(jcfg)
    jparams, _ = jm.init(jax.random.key(0))
    # train_loop's optimizer for a 5-step run
    jocfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS)
    grad_fn = jax_streamify_train_step(lambda p, b: jm.loss(p, b),
                                       JaxStreamConfig(1, MICRO), unroll=False)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, _, grads = grad_fn(params, batch)
        params, opt_state, om = jax_opt.apply_updates(params, grads, opt_state, jocfg)
        return params, opt_state, loss, om

    jstate = jax_opt.init_state(jparams, jocfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    state = opt_lib.init_state(params, ocfg)
    step = make_train_step(Model(get_arch(arch).reduced(), device="cpu"), ocfg, MICRO)
    data = JaxSyntheticLM(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                        global_batch=BATCH, seed=0))
    for i in range(STEPS):
        batch = data.batch_at(i)
        jparams, jstate, jloss, jom = jstep(jparams, jstate,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, loss, om = step(params, state,
                                       {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(om["grad_norm"]), float(jom["grad_norm"]), rtol=1e-5)
        assert float(om["lr"]) == pytest.approx(float(jom["lr"]), rel=1e-6)
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert int(state["step"]) == int(want["step"]) == STEPS
    got_p = tree_lib.leaves(params)
    want_p = tree_lib.leaves(params_from_jax(jax.tree.map(np.asarray, jparams)))
    for key in ("m", "v"):
        got_p += tree_lib.leaves(state[key])
        want_p += tree_lib.leaves(want[key])
    for i, (a, b) in enumerate(zip(got_p, want_p)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"leaf {i}")


def test_training_loss_goes_down():
    res = train_loop("stablelm-3b", steps=25, batch=4, seq=16, verbose=False, lr=3e-3,
                     device="cpu")
    assert res.steps_run == 25
    first, last = float(np.mean(res.losses[:5])), float(np.mean(res.losses[-5:]))
    assert last < first, (first, last)


def test_training_with_microbatches_matches_shapes():
    res = train_loop("yi-9b", steps=6, batch=8, seq=16, microbatches=4, verbose=False,
                     device="cpu")
    assert res.steps_run == 6
    assert np.isfinite(res.losses).all()


def continued_losses(arch, *, first, then, batch, seq, lr=1e-3, seed=0, device="cpu"):
    """The losses of steps ``first`` .. ``then - 1`` of a run that trains
    ``first`` steps under ``train_loop(steps=first)``'s schedule and goes on,
    in memory with no checkpoint, under ``train_loop(steps=then)``'s: what a
    run resumed from a checkpoint of step ``first - 1`` must reproduce."""
    model = Model(get_arch(arch).reduced(), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    data = SyntheticLM(DataConfig(vocab_size=model.cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    state, losses = None, []
    for steps, lo, hi in ((first, 0, first), (then, first, then)):
        ocfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
        state = state or opt_lib.init_state(params, ocfg)
        step = make_train_step(model, ocfg)
        for i in range(lo, hi):
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in data.batch_at(i).items()}
            params, state, loss, _ = step(params, state, b)
            losses.append(float(loss))
    return losses[first:]


def test_auto_resume_training(tmp_path):
    r1 = train_loop("stablelm-3b", steps=6, batch=2, seq=8, ckpt_dir=str(tmp_path),
                    ckpt_every=3, verbose=False, device="cpu")
    assert r1.steps_run == 6
    # "crash" and resume: the loop continues from the checkpoint of step 5
    r2 = train_loop("stablelm-3b", steps=9, batch=2, seq=8, ckpt_dir=str(tmp_path),
                    ckpt_every=3, verbose=False, device="cpu")
    assert r2.resumed_from == 5
    assert r2.steps_run == 3  # only the remaining steps ran
    # the restored parameters, moments, step and data position are exact
    assert r2.losses == continued_losses("stablelm-3b", first=6, then=9, batch=2, seq=8)


def test_watchdog_flags_what_the_jax_watchdog_flags():
    times = [0.1, 0.11, 0.09, 0.1, 0.1, 0.1, 0.9, 0.1, 0.1, 400.0, 0.1, 0.45, 0.55]
    port, ref = StragglerWatchdog(), JaxStragglerWatchdog()
    got = [port.observe(i, t) for i, t in enumerate(times)]
    want = [ref.observe(i, t) for i, t in enumerate(times)]
    assert got == want
    assert port.flagged == ref.flagged == [6, 9, 12]
    tight = StragglerWatchdog(factor=100.0, timeout_s=1.0)
    for i, t in enumerate([0.1] * 6 + [2.0]):
        tight.observe(i, t)
    assert tight.flagged == [6]  # past the timeout, though under 100x the median


def test_train_loop_needs_the_cpu_asked_for_where_cuda_is_missing(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop("stablelm-3b", steps=1, verbose=False)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "stablelm-3b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.main()


def test_main_trains_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "stablelm-3b", "--device", "cpu",
                                      "--steps", "3", "--batch", "2", "--seq", "8"])
    train_mod.main()
    assert "done: 3 steps" in capsys.readouterr().out
