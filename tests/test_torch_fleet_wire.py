"""The port's fleet data plane: wire codec, framing edges, event-driven
collect, on the CPU (``device="cpu"``).

The cases of ``tests/test_fleet_wire.py`` run on the port's modules,
the source scan over ``src/repro_torch/serving/fleet/`` included.  Then
parity: both packages speak the same ``WIRE_VERSION`` and the same
positional rows, so a row or a frame one package encodes decodes in the
other, in both directions.
"""
import dataclasses
import os
import queue as queue_mod
import types

import pytest

from repro.serving.fleet import aggregate as jaggregate
from repro.serving.fleet import wire as jwire
from repro.serving.telemetry import WIRE_FIELDS as JAX_WIRE_FIELDS
from repro.serving.telemetry import TelemetrySample as JaxSample
pytest.importorskip("torch")  # the port's tests need torch; the reference's CI has none
from repro_torch.serving import (FleetRouter, WorkerConfig, make_trace,
                                 shard_for)
from repro_torch.serving.fleet import aggregate as fleet_aggregate
from repro_torch.serving.fleet import wire
from repro_torch.serving.fleet.router import (DISPATCH_FLOOR,
                                              MAX_DISPATCH_CHUNK)
from repro_torch.serving.fleet.worker import _drain_serve
from repro_torch.serving.telemetry import WIRE_FIELDS, TelemetrySample


@pytest.fixture(autouse=True)
def one_thread_per_worker(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cpu(**kw):
    return WorkerConfig(model="heuristic", device="cpu", **kw)


def _sample(cls=TelemetrySample, **kw):
    base = dict(seq=7, tenant="tenant-3", workload="vecadd", key="vecadd",
                backend="host-sync", partitions=4, tasks=8, cache_hit=True,
                predicted_s=0.01, measured_s=0.012, rel_error=0.2,
                status="ok", trace_id="r000007", worker="w1")
    base.update(kw)
    return cls(**base)


# -- wire schema --------------------------------------------------------------


def test_wire_fields_cover_the_dataclass_exactly():
    assert WIRE_FIELDS == tuple(
        f.name for f in dataclasses.fields(TelemetrySample))


def test_sample_row_roundtrip_and_forward_compat():
    s = _sample()
    assert TelemetrySample.from_row(s.to_row()) == s
    short = s.to_row()[:-2]
    back = TelemetrySample.from_row(short)
    assert back.trace_id is None and back.worker is None
    assert back.seq == s.seq and back.measured_s == s.measured_s


def test_resolve_wire_mode_explicit_env_and_unknown(monkeypatch):
    monkeypatch.delenv(wire.WIRE_ENV_VAR, raising=False)
    assert wire.resolve_wire_mode("auto") == "v2"
    assert wire.resolve_wire_mode("legacy") == "legacy"
    monkeypatch.setenv(wire.WIRE_ENV_VAR, "legacy")
    assert wire.resolve_wire_mode("auto") == "legacy"
    assert wire.resolve_wire_mode("v2") == "v2"
    with pytest.raises(ValueError, match="unknown fleet wire mode"):
        wire.resolve_wire_mode("v3")


def test_results_frame_roundtrip_and_version_guard():
    items = [("r000001", _sample().to_row())]
    frame = wire.make_results_frame("w0", 0.25, items)
    assert frame[0] == "results" and frame[2] == wire.WIRE_VERSION
    busy, back = wire.parse_results_frame(frame)
    assert busy == 0.25 and back == items

    stale = ("results", "w0", wire.WIRE_VERSION + 1, 0.0, [])
    with pytest.raises(wire.WireProtocolError, match="wire version"):
        wire.parse_results_frame(stale)


def test_split_frames_size_window():
    batch = list(range(5))
    assert [list(f) for f in wire.split_frames(batch, 2)] \
        == [[0, 1], [2, 3], [4]]
    assert [list(f) for f in wire.split_frames(batch, 99)] == [batch]
    assert [list(f) for f in wire.split_frames([1, 2], 0)] == [[1], [2]]
    assert list(wire.split_frames([], 4)) == []


def test_payload_from_sample_rehydrates_the_legacy_shape():
    p = fleet_aggregate.payload_from_sample(_sample())
    assert p["status"] == "served"
    assert p["config"] == [4, 8]
    assert p["cache_hit"] is True and p["tenant"] == "tenant-3"
    assert p["sample"]["worker"] == "w1"
    p = fleet_aggregate.payload_from_sample(
        _sample(partitions=0, tasks=0, status="failed", error="boom"))
    assert p["status"] == "failed" and p["config"] is None
    assert p["error"] == "boom"


# -- parity with the JAX package ----------------------------------------------


def test_wire_version_and_fields_are_the_jax_packages():
    assert wire.WIRE_VERSION == jwire.WIRE_VERSION
    assert wire.WIRE_MODES == jwire.WIRE_MODES
    assert wire.WIRE_ENV_VAR == jwire.WIRE_ENV_VAR
    assert WIRE_FIELDS == JAX_WIRE_FIELDS


@pytest.mark.parametrize("kw", [
    {},
    dict(partitions=0, tasks=0, status="failed", error="boom",
         cache_hit=False, predicted_s=None, rel_error=None),
    dict(status="degraded", refined=True, t_retire_s=1.25,
         deadline_s=2.0, slo_violation=True, inflight=3),
])
def test_rows_and_frames_cross_decode_both_ways(kw):
    port, ref = _sample(**kw), _sample(JaxSample, **kw)
    assert port.to_row() == ref.to_row()
    assert vars(JaxSample.from_row(port.to_row())) == vars(ref)
    assert vars(TelemetrySample.from_row(ref.to_row())) == vars(port)
    # a frame the port's worker sends, the JAX router parses, and back
    frame = wire.make_results_frame("w0", 0.5, [("r7", port.to_row())])
    busy, items = jwire.parse_results_frame(frame)
    assert busy == 0.5 and JaxSample.from_row(items[0][1]) == ref
    frame = jwire.make_results_frame("w0", 0.5, [("r7", ref.to_row())])
    busy, items = wire.parse_results_frame(frame)
    assert busy == 0.5 and TelemetrySample.from_row(items[0][1]) == port
    assert (fleet_aggregate.payload_from_sample(port)
            == jaggregate.payload_from_sample(ref))


# -- worker-side folding / router-side chunking -------------------------------


def test_drain_serve_folds_until_first_control_message():
    q = queue_mod.Queue()
    q.put(("serve", [("t1", "r1")]))
    q.put(("serve", [("t2", "r2"), ("t3", "r3")]))
    q.put(("refresh", "latest"))
    q.put(("serve", [("t4", "r4")]))
    batch, ctrl = _drain_serve(q, [("t0", "r0")])
    assert [t for t, _ in batch] == ["t0", "t1", "t2", "t3"]
    assert ctrl == ("refresh", "latest")
    assert q.get_nowait() == ("serve", [("t4", "r4")])

    batch, ctrl = _drain_serve(q, [])
    assert batch == [] and ctrl is None


def test_adaptive_dispatch_chunk_tracks_queue_depth():
    r = FleetRouter.__new__(FleetRouter)
    r.dispatch_chunk = None
    r.n_workers = 2
    r._slots = [None, None]
    assert r._chunk_for_depth(0) == DISPATCH_FLOOR
    assert r._chunk_for_depth(6) == DISPATCH_FLOOR
    assert r._chunk_for_depth(100) == 50
    assert r._chunk_for_depth(10_000) == MAX_DISPATCH_CHUNK
    r.dispatch_chunk = 1
    assert r._chunk_for_depth(10_000) == 1


def test_truncated_frame_eofs_instead_of_hanging():
    """A SIGKILL mid-send leaves a partial frame: a length header whose
    promised bytes never arrive.  Because the router holds no write end,
    the reader sees EOF — _drain_slot must return, not block or raise."""
    import multiprocessing

    reader, writer = multiprocessing.Pipe(duplex=False)
    os.write(writer.fileno(), (4096).to_bytes(4, "big") + b"\x80\x04")
    writer.close()
    slot = types.SimpleNamespace(conn=reader, label="w0")
    r = FleetRouter.__new__(FleetRouter)
    assert FleetRouter._drain_slot(r, slot) is False
    reader.close()


def test_no_sleep_polls_left_in_fleet_sources():
    """The port's fleet data plane is event-driven too: nothing in
    ``src/repro_torch/serving/fleet/`` sleeps in a loop."""
    import repro_torch.serving.fleet as fleet_pkg
    pkg_dir = os.path.dirname(fleet_pkg.__file__)
    assert pkg_dir.endswith(os.path.join("repro_torch", "serving", "fleet"))
    names = sorted(f for f in os.listdir(pkg_dir) if f.endswith(".py"))
    assert names == ["__init__.py", "aggregate.py", "router.py", "wire.py",
                     "worker.py"]
    for fname in names:
        with open(os.path.join(pkg_dir, fname)) as f:
            assert "time.sleep" not in f.read(), \
                f"sleep-poll reintroduced in fleet/{fname}"


# -- real worker processes ----------------------------------------------------


def test_dispatch_chunk_one_and_batch_smaller_than_chunk():
    reqs = make_trace(["vecadd"], occurrences=6, tenants=8, scale_index=0)
    with FleetRouter(2, worker=_cpu(), dispatch_chunk=1) as fr:
        fr.submit_all(reqs)
        results = fr.run()
        assert len(results) == len(reqs)
        assert all(r["status"] in ("served", "degraded") for r in results)
        assert fr.stats["dispatch_frames"] == len(reqs)

        lone = make_trace(["vecadd"], occurrences=1, tenants=8,
                          scale_index=0, seed=3)
        fr.submit_all(lone)
        again = fr.run()
        assert len(again) == 1
        assert again[0]["status"] in ("served", "degraded")
        assert fr.stats["duplicate_results"] == 0
        assert fr.last_run["ipc_overhead_fraction"] is not None
        assert 0.0 <= fr.last_run["ipc_overhead_fraction"] <= 1.0


def test_result_frame_racing_sigkill_loses_and_duplicates_nothing():
    reqs = make_trace(["vecadd"], occurrences=12, tenants=8, scale_index=0)
    with FleetRouter(2, worker=_cpu(frame_max=2)) as fr:
        fr.submit_all(reqs)
        fr.inject_kill(fr.shard_for("tenant-0"), after_results=1)
        results = fr.run()

        assert len(results) == len(reqs)
        seen_tokens = {r["sample"]["trace_id"] for r in results}
        assert len(seen_tokens) == len(reqs)
        assert all(r["status"] in ("served", "degraded", "failed")
                   for r in results)
        assert fr.stats["injected_kills"] == 1
        assert fr.stats["worker_deaths"] == 1
        assert fr.stats["worker_respawns"] == 1
    assert fr.summary()["requests"] == len(reqs)


def test_kill_after_every_result_still_lands_within_its_run():
    # after_results=len(reqs): the kill can fire only once every result is
    # in, when the victim owes nothing.  run() must still count the kill,
    # the death and the respawn, and lose or double nothing.
    reqs = make_trace(["vecadd"], occurrences=12, tenants=8, scale_index=0)
    with FleetRouter(2, worker=_cpu(frame_max=2)) as fr:
        victim = fr.shard_for("tenant-0")
        old_pid = fr._slots[victim].pid
        fr.submit_all(reqs)
        fr.inject_kill(victim, after_results=len(reqs))
        results = fr.run()

        assert len(results) == len(reqs)
        assert len({r["sample"]["trace_id"] for r in results}) == len(reqs)
        assert all(r["status"] in ("served", "degraded") for r in results)
        assert fr.stats["injected_kills"] == 1
        assert fr.stats["worker_deaths"] == 1
        assert fr.stats["worker_respawns"] == 1
        assert fr.stats["requeued_requests"] == 0
        assert fr.stats["duplicate_results"] == 0
        fresh = fr._slots[victim]
        assert fresh.pid != old_pid and fresh.proc.is_alive()

        # the respawned seat serves the next run
        more = make_trace(["vecadd"], occurrences=4, tenants=8,
                          scale_index=0, seed=5)
        fr.submit_all(more)
        again = fr.run()
        assert len(again) == len(more)
        assert all(r["status"] in ("served", "degraded") for r in again)
        assert fr.stats["worker_deaths"] == 1
    assert fr.summary()["requests"] == len(reqs) + len(more)


def test_legacy_wire_end_to_end(tmp_path):
    reqs = make_trace(["vecadd"], occurrences=6, tenants=8, scale_index=0)
    with FleetRouter(2, worker=_cpu(wire="legacy")) as fr:
        fr.submit_all(reqs)
        results = fr.run()
        assert len(results) == len(reqs)
        for r in results:
            assert r["status"] in ("served", "degraded")
            s = TelemetrySample.from_json(r["sample"])
            assert s.worker == f"w{shard_for(s.tenant, 2)}"
        assert fr.last_run["ipc_overhead_fraction"] is None
        assert fr.summary()["ipc_overhead_fraction"] is None
