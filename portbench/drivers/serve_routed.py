"""Serving traffic for a model that routes tokens to experts: ``serve``'s
closed loop (its ``Server``, window, sample and traced stretch), with the
port's routing record (``repro_torch.models.moe.record_routes``) open
around every prefill and decode step, so each batch keeps the experts
every MoE layer chose for every position it served.

``correct``: as in ``serve``, the reference runs once over each picked
request's prompt and served tokens, but follows the program's recorded
routes (teacher forced, as the served tokens are), since with random
weights the reference and the program disagree on a near tie of the
router about once a check, and the token's FFN output then changes by
O(1).  Beside ``max_gap`` and ``logit_err``, ``route_gap`` is the widest
gap by which the reference's probability of a chosen expert lies below the
reference's own K-th largest (0 where the sets agree).  The control (the
reference in TF32 in the program's place) routes freely and is judged on
its own routes.  A family whose model records no routes (no MoE layer) is
judged as ``serve`` judges it, with ``route_gap`` 0.

The record's ``span_units`` are the units of the traced stretch that
records host ops (the one the program's spans are read from), each decode
step with ``experts``: the distinct experts it routed to, one count a MoE
layer.
"""
from __future__ import annotations

import sys
import time

import torch

from portbench.drivers import Run, collector_pauses, port
from portbench.drivers.serve import Server, _sample, _steps_line, _window
from portbench.lib import family, judge, weights
from portbench.lib.trace import traced


class RoutedServer(Server):
    """``Server`` with each unit's routes kept: a batch's ``routes[c]`` is
    the list (one tensor a MoE layer) of the unit that served its output
    column ``c``: the prefill's (B * length, K) at 0, the decode steps' (B,
    K) after it."""

    def __init__(self, *args, record_routes, **kw):
        super().__init__(*args, **kw)
        self.record_routes = record_routes

    def _prefill(self) -> None:
        with self.record_routes() as got:
            super()._prefill()
        self.current.routes = [got]

    def _decode(self) -> None:
        with self.record_routes() as got:
            super()._decode()
        self.current.routes.append(got)


def batch_routes(b, rows: list) -> list:
    """The routes of requests ``rows`` of batch ``b`` at each position the
    reference runs over (the prompt, then every served token but the last):
    one (len(rows), positions, K) tensor a MoE layer."""
    n = len(b.routes[0])
    if any(len(r) != n for r in b.routes) or len(b.routes) != b.n_out:
        raise ValueError("a unit recorded another number of MoE calls than the prefill")
    out = []
    for j in range(n):
        first = b.routes[0][j].reshape(b.prompts.shape[0], b.length, -1)[rows]
        steps = [r[j][rows, None] for r in b.routes[1:b.n_out]]
        out.append(torch.cat([first] + steps, dim=1))
    return out


def _check(srv: Server, picked: dict, controls: bool) -> tuple[dict, dict]:
    """(the numbers, the control's readings) for the picked requests."""
    fam, dm, got, ctl = srv.fam, srv.dm, [], []
    for i, rows in picked.items():
        b = srv.batches[i]
        tokens = torch.cat([b.prompts[rows], b.out[rows, :b.n_out - 1]], dim=1)
        served, top = b.out[rows, :b.n_out], b.top[rows, :b.n_out]
        routes = batch_routes(b, rows)
        if routes:
            ref, gap, _ = fam.run(srv.params, tokens, dm, logits_from=b.length - 1,
                                  routes=routes)
        else:
            ref, gap = fam.forward(srv.params, tokens, dm, logits_from=b.length - 1), 0.0
        got.append(dict(judge.served(ref, served, top), route_gap=gap))
        del ref
        if controls:
            if routes:
                low, _, own = fam.run(srv.params, tokens, dm, prec="tf32",
                                      logits_from=b.length - 1)
                ref, gap, _ = fam.run(srv.params, tokens, dm, logits_from=b.length - 1,
                                      routes=own)
            else:
                low = fam.forward(srv.params, tokens, dm, prec="tf32", logits_from=b.length - 1)
                ref = fam.forward(srv.params, tokens, dm, logits_from=b.length - 1)
            top_c, toks = low.max(dim=-1)
            ctl.append(dict(judge.served(ref, toks, top_c), route_gap=gap))
            del low, ref, top_c, toks
    readings = {"control_tf32": judge.worst(ctl)} if controls else {}
    return judge.worst(got), readings


def _experts(srv: Server, units: list) -> list:
    """``units`` with each decode step's distinct experts a MoE layer."""
    for u in units:
        if u["kind"] == "decode":
            routes = srv.batches[u["batch"]].routes[u["col"]]
            u["experts"] = [int(r.unique().numel()) for r in routes]
    return units


def run(r: Run) -> dict:
    from repro_torch.models.moe import record_routes

    wl, dev = r.workload, r.device
    fam = family.of(r.config)
    dm = fam.dims(r.config)
    m = port.model(fam, dm, r.config, dev)
    r.mark("port")
    params = weights.make(fam, dm, r.seed, dev)
    port.check_layout(m, params)
    r.mark("weights")
    srv = RoutedServer(m, params, fam, dm, wl, r.seed, dev, record_routes=record_routes)
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
        span_units: list = []
        if r.trace:
            out["trace"], traced_units = traced(
                r, lambda: srv.boundaries(wl["trace_boundaries"]))
            span_units = _experts(srv, srv.units[last + len(traced_units):])
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
                       "trace_units": traced_units, "span_units": span_units})
    return out
