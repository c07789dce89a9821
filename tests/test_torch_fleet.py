"""The port's fleet: the tenant-sharding router over N spawn-isolated
worker processes, on the CPU (``device="cpu"``).

The cases of ``tests/test_fleet.py`` run on the port's modules: the
sharding function, the cross-process telemetry/metrics merge, end-to-end
serving with tenant→worker consistency and model refresh acks, the
SIGKILL → respawn → requeue drill, and respawn-budget exhaustion.  Then
parity with the JAX package (``shard_for`` for 1,000 tenants, the merge
functions on the same samples) and the no-fallback rule: a worker asked
for ``"cuda"`` on a machine without CUDA makes the router raise.

Each worker process imports torch, which by default takes every core;
the tests pin ``OMP_NUM_THREADS=1`` before any router spawns so the
worker processes of parallel test runs do not oversubscribe the host.
"""
import json
import multiprocessing
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
import torch

from repro.serving import fleet as jfleet
from repro.serving.telemetry import TelemetrySample as JaxSample
from repro_torch.launch.stats import render
from repro_torch.serving import (FleetRouter, WorkerConfig, fleet_summary,
                                 make_trace, merge_metrics, merge_samples,
                                 shard_for)
from repro_torch.serving.telemetry import TelemetrySample

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread_per_worker(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cpu(**kw):
    return WorkerConfig(model="heuristic", device="cpu", **kw)


def _sample(seq, worker=None, tenant="tenant-0", retire=None, status="ok",
            cache_hit=False, refined=False, cls=TelemetrySample):
    return cls(
        seq=seq, tenant=tenant, workload="vecadd", key="vecadd",
        backend="host-sync", partitions=1, tasks=1, cache_hit=cache_hit,
        predicted_s=None, measured_s=0.01, rel_error=None, status=status,
        refined=refined, t_retire_s=retire, worker=worker)


def _fleet_children():
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("fleet-")]


# -- sharding -----------------------------------------------------------------


def test_shard_for_is_stable_and_in_range():
    for n in (1, 2, 3, 4, 7):
        for i in range(16):
            tenant = f"tenant-{i}"
            slot = shard_for(tenant, n)
            assert 0 <= slot < n
            assert slot == shard_for(tenant, n)
    assert {shard_for(f"tenant-{i}", 2) for i in range(8)} == {0, 1}


def test_shard_for_agrees_with_jax_for_1000_tenants():
    tenants = [f"tenant-{i}" for i in range(1000)]
    for n in (1, 2, 3, 4, 7, 8):
        assert [shard_for(t, n) for t in tenants] == \
            [jfleet.shard_for(t, n) for t in tenants]


# -- telemetry merge ----------------------------------------------------------


def test_merge_samples_labels_orders_and_never_mutates():
    w0 = [_sample(0, retire=2.0), _sample(1, retire=None)]
    w1 = [_sample(0, retire=1.0), _sample(1, retire=2.0)]
    merged = merge_samples({"w0": w0, "w1": w1})

    assert [s.worker for s in merged].count("w0") == 2
    assert all(s.worker in ("w0", "w1") for s in merged)
    assert all(s.worker is None for s in w0 + w1)
    assert [(s.worker, s.seq) for s in merged] == [
        ("w1", 0), ("w0", 0), ("w1", 1), ("w0", 1)]
    again = merge_samples({"w1": w1, "w0": w0})
    assert [(s.worker, s.seq, s.t_retire_s) for s in again] \
        == [(s.worker, s.seq, s.t_retire_s) for s in merged]


def test_worker_field_roundtrips_and_stays_backwards_compatible():
    s = _sample(3, worker="w2")
    assert TelemetrySample.from_json(s.to_json()).worker == "w2"
    legacy = {k: v for k, v in s.to_json().items() if k != "worker"}
    legacy["some_future_field"] = 1
    assert TelemetrySample.from_json(legacy).worker is None


def test_merge_metrics_labels_series_and_sorts_deterministically():
    fam = {"type": "counter",
           "values": [{"labels": {"namespace": "shared"}, "value": 2}]}
    merged = merge_metrics({"w1": {"serving.cache.hit": fam},
                            "w0": {"serving.cache.hit": fam},
                            "w2": None})
    series = merged["serving.cache.hit"]["values"]
    assert [e["labels"] for e in series] == [
        {"namespace": "shared", "worker": "w0"},
        {"namespace": "shared", "worker": "w1"}]
    assert merged["serving.cache.hit"]["type"] == "counter"

    report = render([_sample(0, worker="w0", retire=1.0)], merged)
    assert "worker=w0" in report

    with pytest.raises(ValueError, match="conflicting types"):
        merge_metrics({"w0": {"m": {"type": "counter", "values": []}},
                       "w1": {"m": {"type": "gauge", "values": []}}})


def test_fleet_summary_breaks_down_per_worker():
    samples = merge_samples({
        "w0": [_sample(0, retire=1.0, cache_hit=True),
               _sample(1, retire=2.0, status="failed")],
        "w1": [_sample(0, retire=1.5, refined=True)]})
    s = fleet_summary(samples)
    assert s["requests"] == 3
    assert s["per_worker"] == {
        "w0": {"requests": 2, "cache_hits": 1, "refinements": 0,
               "failed": 1},
        "w1": {"requests": 1, "cache_hits": 0, "refinements": 1,
               "failed": 0}}


def test_merge_and_summary_identical_to_jax():
    def streams(cls):
        return {"w1": [_sample(0, retire=1.0, cls=cls),
                       _sample(2, retire=3.0, status="failed", cls=cls)],
                "w0": [_sample(1, retire=1.0, cache_hit=True, cls=cls),
                       _sample(3, retire=None, refined=True, cls=cls)]}
    port = merge_samples(streams(TelemetrySample))
    ref = jfleet.merge_samples(streams(JaxSample))
    assert [s.to_json() for s in port] == [s.to_json() for s in ref]
    assert fleet_summary(port) == jfleet.fleet_summary(ref)
    snaps = {"w0": {"a": {"type": "gauge", "values": [
                 {"labels": {"t": "x"}, "value": 1.5}]}},
             "w1": {"a": {"type": "gauge", "values": [
                 {"labels": {"t": "a"}, "value": 2.0}]}}}
    assert merge_metrics(snaps) == jfleet.merge_metrics(snaps)


# -- real worker processes ----------------------------------------------------


def test_fleet_end_to_end_shards_refreshes_and_shuts_down(tmp_path):
    """2 real workers on the CPU, 8 requests over 8 tenants: every result
    terminal and served by the worker its tenant hashes to; refresh acks
    from every worker; close() drains the goodbye metrics, is
    idempotent, and leaves no child processes behind."""
    reqs = make_trace(["vecadd"], occurrences=8, tenants=8, scale_index=0)
    jsonl = tmp_path / "fleet.jsonl"
    with FleetRouter(2, worker=_cpu(), telemetry_path=str(jsonl)) as fr:
        fr.submit_all(reqs)
        results = fr.run()

        assert len(results) == len(reqs)
        workers_used = set()
        for r in results:
            assert r["status"] in ("served", "degraded")
            s = TelemetrySample.from_json(r["sample"])
            assert s.worker == f"w{shard_for(s.tenant, 2)}"
            workers_used.add(s.worker)
        assert workers_used == {"w0", "w1"}

        tags = fr.refresh_model("heuristic")
        assert set(tags) == {"w0", "w1"}
        assert all(tag == "heuristic" for tag in tags.values())

    assert fr.closed
    fr.close()
    assert _fleet_children() == []

    summary = fr.summary()
    assert summary["requests"] == len(reqs)
    assert summary["worker_deaths"] == 0
    assert set(summary["per_worker"]) == {"w0", "w1"}

    snap = fr.metrics_snapshot()
    assert snap
    for fam in snap.values():
        assert all(e["labels"]["worker"] in ("w0", "w1")
                   for e in fam["values"])
    assert sum(1 for _ in open(jsonl)) == len(reqs)


def test_fleet_sigkill_respawns_and_every_request_terminates():
    """SIGKILL a worker between batches: the next run() detects the
    death, respawns the slot, requeues its un-acked work, and every
    admitted request still reaches a terminal status."""
    first = make_trace(["vecadd"], occurrences=4, tenants=8, scale_index=0)
    second = make_trace(["vecadd"], occurrences=8, tenants=8,
                        scale_index=0, seed=1)
    with FleetRouter(2, worker=_cpu()) as fr:
        fr.submit_all(first)
        assert len(fr.run()) == len(first)

        victim = fr._slots[fr.shard_for("tenant-0")]
        os.kill(victim.pid, signal.SIGKILL)
        victim.proc.join(10)
        assert not victim.proc.is_alive()

        fr.submit_all(second)
        results = fr.run()

        assert len(results) == len(second)
        assert all(r["status"] in ("served", "degraded") for r in results)
        assert fr.stats["worker_deaths"] == 1
        assert fr.stats["worker_respawns"] == 1
        assert fr.stats["requeued_requests"] >= 1
    assert _fleet_children() == []
    assert fr.summary()["requests"] == len(first) + len(second)


def test_fleet_respawn_budget_exhaustion_fails_terminally_and_closes():
    """max_respawns=0: a SIGKILL'd slot is abandoned instead of
    respawned and its un-acked work fails terminally with synthetic
    samples, while the healthy slot keeps serving its own requests;
    every admitted request still reaches a terminal status and shutdown
    leaves no orphans."""
    reqs = make_trace(["vecadd"], occurrences=8, tenants=8, scale_index=0)
    with FleetRouter(2, worker=_cpu(), max_respawns=0) as fr:
        victim_i = fr.shard_for("tenant-0")
        victim = fr._slots[victim_i]
        os.kill(victim.pid, signal.SIGKILL)
        victim.proc.join(10)
        assert not victim.proc.is_alive()

        fr.submit_all(reqs)
        results = fr.run()

        assert len(results) == len(reqs)
        failed, served = [], []
        for r in results:
            s = TelemetrySample.from_json(r["sample"])
            if shard_for(s.tenant, 2) == victim_i:
                failed.append(r)
                assert r["status"] == "failed"
                assert "respawn budget" in r["error"]
                assert s.status == "failed"
                assert s.worker == f"w{victim_i}"
            else:
                served.append(r)
                assert r["status"] in ("served", "degraded")
        assert failed and served
        assert fr.stats["worker_deaths"] == 1
        assert fr.stats["abandoned_slots"] == 1
        assert fr.stats["worker_respawns"] == 0

        more = make_trace(["vecadd"], occurrences=4, tenants=8,
                          scale_index=0, seed=1)
        fr.submit_all(more)
        again = fr.run()
        assert len(again) == len(more)
        for r in again:
            s = TelemetrySample.from_json(r["sample"])
            if shard_for(s.tenant, 2) == victim_i:
                assert r["status"] == "failed"
            else:
                assert r["status"] in ("served", "degraded")
    assert fr.closed
    fr.close()
    assert _fleet_children() == []
    assert fr.summary()["requests"] == len(reqs) + len(more)


# -- no fallback --------------------------------------------------------------


def test_worker_config_defaults_to_the_card():
    assert WorkerConfig().device == "cuda"
    assert WorkerConfig().capacity == 1.0


@pytest.mark.parametrize("n,threads", [(2, None), (1, 2)])
def test_spawned_workers_report_their_share_of_the_cores(n, threads):
    """Each worker sets torch's intra-op pool before it builds its
    scheduler and reports it in its ready handshake: an even share of the
    host's cores by default (OMP_NUM_THREADS=1 is set here, so a worker
    left at torch's default would report 1), or the count asked for."""
    want = threads if threads else max(1, os.cpu_count() // n)
    with FleetRouter(n, worker=_cpu(intra_op_threads=threads)) as fr:
        assert [s.threads for s in fr._slots] == [want] * n
        reqs = make_trace(["vecadd"], occurrences=2, tenants=2, scale_index=0)
        fr.submit_all(reqs)
        assert all(r["status"] in ("served", "degraded") for r in fr.run())
    assert WorkerConfig().intra_op_threads is None


def test_cuda_worker_without_cuda_makes_the_router_raise():
    """The worker's ready handshake carries the device error, so the
    router raises rather than the fleet serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the worker would serve on the card")
    fr = FleetRouter(1, worker=WorkerConfig(model="heuristic"))
    with pytest.raises(RuntimeError, match="failed to start.*CUDA"):
        fr.start()
    fr.close()
    assert _fleet_children() == []


def test_fleet_serve_defaults_to_the_card_and_raises_without_it():
    from repro_torch.launch.serve import fleet_serve
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: fleet_serve would serve on the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_serve(n_requests=2, worker_procs=1, model="heuristic",
                    verbose=False)


def test_fleet_serve_on_the_cpu(tmp_path):
    """The CLI's entry point end to end on the CPU: 8 tenants over two
    workers, the merged metrics snapshot written and renderable."""
    from repro_torch.launch.serve import fleet_serve
    out = tmp_path / "metrics.json"
    s = fleet_serve(["vecadd", "dotprod"], n_requests=8, worker_procs=2,
                    model="heuristic", metrics_out=str(out),
                    verbose=False, device="cpu")
    assert s["requests"] == 8 and s["worker_procs"] == 2
    assert s["device"] == "cpu" and s["worker_deaths"] == 0
    assert set(s["per_worker"]) == {"w0", "w1"}
    assert 0.0 <= s["ipc_overhead_fraction"] <= 1.0
    assert out.exists()
    assert _fleet_children() == []


def test_cli_worker_procs_defaults_and_refusal():
    """``serve --worker-procs 2``: the card by default (refused here with
    the device error), and on ``--device cpu`` the JAX package's fleet
    defaults — window 2 per worker and 8 tenants when ``--tenants`` is
    unset."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "repro_torch.launch.serve",
            "--worker-procs", "2", "--model", "heuristic", "--requests", "8"]
    if not torch.cuda.is_available():
        proc = subprocess.run(base, capture_output=True, text=True, env=env,
                              timeout=120)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
        assert "throughput_rps" not in proc.stdout
    proc = subprocess.run(base + ["--device", "cpu"], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout)
    assert summary["window"] == 2 and summary["worker_procs"] == 2
    assert summary["device"] == "cpu" and summary["requests"] == 8
    assert len(summary["per_tenant"]) == 8
    assert set(summary["per_worker"]) == {"w0", "w1"}
