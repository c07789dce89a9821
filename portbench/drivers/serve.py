"""Serving traffic: closed-loop batches of greedy requests through the
port's ``Model``, in the order ``launch/serve.serve`` calls it.

The harness is the single client.  Batch ``i`` holds ``batch`` prompts of
``prompt_lengths[i % len]`` tokens drawn from the seed; it is prefilled
(``Model.prefill``, then ``Model.decode_cache`` into a cache of
``cache_positions``), which gives each request its first token, and then
decoded one token per request a step (``Model.decode_step``) until each has
``output_tokens``; then the next batch starts.  A mark is recorded on the
serving stream after each unit that yields tokens (a CUDA event on the
card), so the gaps between a request's tokens are device time and count
every stall the host causes.

The window closes at the first boundary after ``--seconds``: after any
decode step (``close_at: step``) or after a whole cycle of prompt lengths
(``close_at: cycle``), so a rate is never taken over part of a unit.
Set-up runs the traffic to ``setup_boundaries`` boundaries first, which
warms every shape the window uses (and, for the decode cell, fills the
cache the sessions need); a traced run profiles ``trace_boundaries`` more.

``correct``: once the window has closed and the program's caches are
freed, ``check.requests`` requests that had tokens in the window are drawn
from the seed, with one of the longest among them; the reference runs once
over each prompt and its served tokens, and the widest gap by which a
served token's logit lies below the reference's best (``max_gap``) and the
widest difference between a served token's logit and the reference's
logit of that token (``logit_err``) are held to ``check.limits``.
"""
from __future__ import annotations

import random
import statistics
import sys
import time

import torch

from portbench.drivers import Run, collector_pauses, port
from portbench.lib import family, judge, traffic, weights
from portbench.lib.cell import derive
from portbench.lib.trace import traced


class _Marks:
    """Times on the serving stream: CUDA events on the card, the host's
    clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> int:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return len(self.marks) - 1

    def ms(self, a: int, b: int) -> float:
        x, y = self.marks[a], self.marks[b]
        return x.elapsed_time(y) if self.cuda else (y - x) * 1e3


class _Batch:
    def __init__(self, index: int, prompts: torch.Tensor, n_out: int):
        self.index = index
        self.prompts = prompts
        self.length = prompts.shape[1]
        self.out = torch.empty((prompts.shape[0], n_out), dtype=torch.long,
                               device=prompts.device)
        self.top = torch.empty((prompts.shape[0], n_out), dtype=torch.float32,
                               device=prompts.device)  # each served token's logit
        self.n_out = 0
        self.cache = None
        self.token_marks: list[int] = []  # the mark of each output column


class Server:
    def __init__(self, m, params, fam, dm, wl: dict, seed: int, device):
        self.m, self.params, self.fam, self.dm, self.wl = m, params, fam, dm, wl
        self.seed, self.device = seed, device
        self.marks = _Marks(device)
        self.batches: list[_Batch] = []
        self.units: list[dict] = []

    @property
    def current(self):
        return self.batches[-1] if self.batches else None

    def _prefill(self) -> None:
        if self.current is not None:
            self.current.cache = None  # the finished batch's cache goes first
        b = _Batch(len(self.batches), traffic.prompts(self.dm, self.wl, self.seed,
                                                      len(self.batches), self.device),
                   self.wl["output_tokens"])
        self.batches.append(b)
        with torch.profiler.record_function("prefill"):
            logits, filled = self.m.prefill(self.params, {"tokens": b.prompts})
            b.cache = self.m.decode_cache(filled, self.wl["cache_positions"])
            del filled
        self._emit(b, logits)
        self.units.append({"kind": "prefill", "batch": b.index, "rows": b.out.shape[0],
                           "length": b.length, "col": 0})

    def _decode(self) -> None:
        b = self.current
        pos = b.length + b.n_out - 1  # position of the token fed in
        h0, c0 = time.perf_counter(), time.thread_time()
        with torch.profiler.record_function("decode_step"):
            logits, b.cache = self.m.decode_step(
                self.params, {"tokens": b.out[:, b.n_out - 1:b.n_out]}, b.cache, pos)
        host, cpu = time.perf_counter() - h0, time.thread_time() - c0
        self._emit(b, logits)
        self.units.append({"kind": "decode", "batch": b.index, "rows": b.out.shape[0],
                           "position": pos, "host_s": host, "host_cpu_s": cpu,
                           "col": b.n_out - 1})

    def _emit(self, b: _Batch, logits: torch.Tensor) -> None:
        """The greedy token of each request, and its logit."""
        top, tokens = logits.max(dim=-1)
        b.out[:, b.n_out] = tokens
        b.top[:, b.n_out] = top
        b.n_out += 1
        b.token_marks.append(self.marks.mark())

    def unit(self) -> bool:
        """Run one unit (a prefill or a decode step); True at a boundary."""
        b = self.current
        if b is None or b.n_out == self.wl["output_tokens"]:
            self._prefill()
            kind = "prefill"
        else:
            self._decode()
            kind = "decode"
        b = self.current
        if self.wl["close_at"] == "step":
            return kind == "decode"
        cycle = len(self.wl["prompt_lengths"])
        return b.n_out == self.wl["output_tokens"] and (b.index + 1) % cycle == 0

    def boundaries(self, n: int) -> list[dict]:
        """Run to the ``n``-th boundary; the units run."""
        start, done = len(self.units), 0
        while done < n:
            done += self.unit()
        return self.units[start:]


def _window(srv: Server, first_unit: int, last_unit: int, window_s: float) -> dict:
    """End-to-end numbers and the readers' record of units
    ``first_unit:last_unit``."""
    units = srv.units[first_unit:last_unit]
    u0 = units[0]
    first_mark = srv.batches[u0["batch"]].token_marks[u0["col"]]
    out_tokens, prompt_tokens, batches = 0, 0, set()
    for u in units:
        b = srv.batches[u["batch"]]
        batches.add(b.index)
        out_tokens += u["rows"]
        if u["kind"] == "prefill":
            prompt_tokens += u["rows"] * u["length"]
        col = u["col"]
        if col > 0 and b.token_marks[col - 1] >= first_mark:
            u["gap_s"] = srv.marks.ms(b.token_marks[col - 1], b.token_marks[col]) / 1e3
    e2e = {"output_tokens_per_s": out_tokens / window_s,
           "prompt_tokens_per_s": prompt_tokens / window_s}
    return {"e2e": e2e, "units": units, "batches": sorted(batches),
            "attempted": sum(srv.batches[i].out.shape[0] for i in batches)}


def _steps_line(units: list, pauses: list) -> str:
    """The window's decode steps in one line: the gap between a request's
    tokens, and the host's wall and CPU time in each ``decode_step`` call,
    over every step and over the slowest 5% by gap, and the cyclic
    collector's pauses.  A slow gap whose host wall time exceeds its CPU
    time had the host thread waiting or descheduled."""
    steps = sorted((u for u in units if u["kind"] == "decode" and "gap_s" in u),
                   key=lambda u: u["gap_s"])
    if not steps:
        return "no decode steps"
    def q(xs):
        cuts = statistics.quantiles(xs, n=20) if len(xs) > 1 else xs * 19
        return "/".join(f"{x:.2f}" for x in (cuts[9], cuts[17], cuts[18], max(xs)))

    slow = steps[-max(1, len(steps) // 20):]
    ms = lambda us, k: statistics.mean(u[k] for u in us) * 1e3
    return (f"{len(steps)} decode steps; ms p50/p90/p95/max: gap {q([u['gap_s'] * 1e3 for u in steps])}"
            f", host {q([u['host_s'] * 1e3 for u in steps])}; slowest 5% mean: gap "
            f"{ms(slow, 'gap_s'):.2f}, host wall {ms(slow, 'host_s'):.2f}, host cpu "
            f"{ms(slow, 'host_cpu_s'):.2f}; all mean host cpu {ms(steps, 'host_cpu_s'):.2f}; "
            f"collector {len(pauses)} pauses, {sum(d for _, d in pauses) * 1e3:.2f} ms, "
            f"longest {max((d for _, d in pauses), default=0.0) * 1e3:.2f} ms")


def _sample(srv: Server, batches: list[int], n: int, seed: int) -> dict:
    """{batch: [rows]} of ``n`` requests of ``batches`` drawn from the
    seed, the first one among the longest."""
    reqs = [(i, r) for i in batches for r in range(srv.batches[i].out.shape[0])]
    served = lambda q: srv.batches[q[0]].length + srv.batches[q[0]].n_out
    rng = random.Random(derive(seed, "sample"))
    longest = max(served(q) for q in reqs)
    first = rng.choice([q for q in reqs if served(q) == longest])
    rest = [q for q in reqs if q != first]
    picked = [first] + rng.sample(rest, min(n, len(reqs)) - 1)
    out: dict = {}
    for i, r in sorted(picked):
        out.setdefault(i, []).append(r)
    return out


def _check(srv: Server, picked: dict, controls: bool) -> tuple[dict, dict]:
    """(the numbers, the control's readings) for the picked requests: the
    reference runs over each prompt and its served tokens."""
    fam, dm, got, ctl = srv.fam, srv.dm, [], []
    for i, rows in picked.items():
        b = srv.batches[i]
        tokens = torch.cat([b.prompts[rows], b.out[rows, :b.n_out - 1]], dim=1)
        ref = fam.forward(srv.params, tokens, dm, logits_from=b.length - 1)
        got.append(judge.served(ref, b.out[rows, :b.n_out], b.top[rows, :b.n_out]))
        if controls:
            low = fam.forward(srv.params, tokens, dm, prec="tf32", logits_from=b.length - 1)
            top, toks = low.max(dim=-1)
            ctl.append(judge.served(ref, toks, top))
            del low, top, toks
        del ref
    readings = {"control_tf32": judge.worst(ctl)} if controls else {}
    return judge.worst(got), readings


def run(r: Run) -> dict:
    wl, dev = r.workload, r.device
    fam = family.of(r.config)
    dm = fam.dims(r.config)
    m = port.model(fam, dm, r.config, dev)
    r.mark("port")
    params = weights.make(fam, dm, r.seed, dev)
    port.check_layout(m, params)
    r.mark("weights")
    srv = Server(m, params, fam, dm, wl, r.seed, dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out: dict = {}
    with torch.inference_mode():
        srv.boundaries(wl["setup_boundaries"])
        sync()
        out["window_start"] = t0 = time.perf_counter()
        first = len(srv.units)
        with collector_pauses() as pauses:
            while not (srv.unit() and time.perf_counter() - t0 >= r.seconds):
                pass
            sync()
        window_s = time.perf_counter() - t0
        last = len(srv.units)
        traced_units: list = []
        if r.trace:
            out["trace"], traced_units = traced(
                r, lambda: srv.boundaries(wl["trace_boundaries"]))
        win = _window(srv, first, last, window_s)
        print("portbench: window: " + _steps_line(win["units"], pauses), file=sys.stderr,
              flush=True)
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
        srv.current.cache = None  # the program's state; the weights are the benchmark's
        if cuda:
            torch.cuda.empty_cache()
        picked = _sample(srv, win["batches"], wl["check"]["requests"], r.seed)
        numbers, readings = _check(srv, picked, r.controls)
    out.update(e2e=win["e2e"], attempted=win["attempted"], failed=0, numbers=numbers,
               readings=readings,
               record={"family": r.config["family"], "dims": dm, "workload": wl,
                       "window_s": window_s, "units": win["units"], "trace": out.get("trace"),
                       "trace_units": traced_units})
    return out
