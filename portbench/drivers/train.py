"""Training traffic: the port's training step, ``launch/train.make_train_step``
(AdamW, no recomputation, ``microbatches`` microbatches), on batches of
``batch`` x ``seq_len`` tokens drawn from the seed for each step.

Set-up builds one step with its model and optimizer state and runs its
first ``setup_steps`` steps through the same call and feed as the window
(which warms every shape), reading what the comparison needs on the way:
each step's loss, the first gradient by leaf as the optimizer took it
(its first moment over 1 - b1 after step 1), and each leaf's change after
the last set-up step (against the weights regenerated from the seed).
The window then runs the same object on, one step after the other, the
loss read after each, and closes at the first step boundary after
``--seconds``; a traced run profiles ``trace_steps`` more.

``correct``: once the window has closed and the program's state is freed,
the reference follows the set-up steps from the same weights and batches,
and ``lib.judge.train_numbers`` is held to ``check.limits``.
"""
from __future__ import annotations

import time

import torch

from portbench.drivers import Run, port
from portbench.lib import family, judge, traffic, weights
from portbench.lib.trace import traced
from portbench.reference import train as ref_train

CONTROLS = {"control_tf32": {"prec": "tf32"}, "half_batch": {"fault": "half_batch"},
            "double_leaf": {"fault": "double_leaf"}}


def _norms(ts, scale: float = 1.0) -> list[float]:
    return (torch.stack([torch.linalg.vector_norm(t) for t in ts]) * scale).tolist()


def run(r: Run) -> dict:
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import optimizer as opt_lib

    wl, dev = r.workload, r.device
    fam = family.of(r.config)
    dm = fam.dims(r.config)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    m = port.model(fam, dm, r.config, dev)
    r.mark("port")
    ocfg = opt_lib.AdamWConfig(**wl["optimizer"])
    params = weights.make(fam, dm, r.seed, dev)
    port.check_layout(m, params)
    r.mark("weights")
    opt_state = opt_lib.init_state(params, ocfg)
    step = make_train_step(m, ocfg, wl["microbatches"])
    tokens = wl["batch"] * wl["seq_len"]
    n = 0

    def one():
        nonlocal params, opt_state, n
        batch = traffic.train_batch(dm, wl, r.seed, n, dev)
        with torch.profiler.record_function("train_step"):
            params, opt_state, loss, _ = step(params, opt_state, batch)
        n += 1
        return loss.item()

    prog: dict = {"losses": []}
    for i in range(wl["setup_steps"]):
        prog["losses"].append(one())
        if i == 0:
            prog["grad"] = _norms(fam.leaves(opt_state["m"]), 1.0 / (1.0 - ocfg.b1))
    with torch.no_grad():
        p0 = fam.leaves(weights.make(fam, dm, r.seed, dev))
        prog["change"] = _norms(p - q for p, q in zip(fam.leaves(params), p0))
        del p0
    sync()
    out: dict = {"window_start": time.perf_counter()}
    first = n
    while True:
        one()
        if time.perf_counter() - out["window_start"] >= r.seconds:
            break
    sync()
    window_s = time.perf_counter() - out["window_start"]
    steps = n - first
    if r.trace:
        out["trace"], _ = traced(r, lambda: [one() for _ in range(wl["trace_steps"])])
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del params, opt_state, step, m
    if cuda:
        torch.cuda.empty_cache()
    ref = ref_train.steps(fam, dm, wl, r.seed, dev, wl["setup_steps"])
    readings = {}
    if r.controls:
        for name, kw in CONTROLS.items():
            alt = ref_train.steps(fam, dm, wl, r.seed, dev, wl["setup_steps"], **kw)
            readings[name] = judge.train_numbers(alt, ref)
    out.update(e2e={"train_tokens_per_s": steps * tokens / window_s}, attempted=steps,
               failed=0, numbers=judge.train_numbers(prog, ref), readings=readings,
               record={"family": r.config["family"], "dims": dm, "workload": wl,
                       "window_s": window_s, "steps": steps, "trace": out.get("trace"),
                       "trace_steps": wl["trace_steps"] if r.trace else 0})
    return out
