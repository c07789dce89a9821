"""Serving drivers.

Two entry points share this module:

  * the batched LM driver (``serve``): prefill, then greedy decode over a
    KV cache (below);
  * the adaptive streamed-workload driver (``adaptive_serve``,
    ``--adaptive``): drains a mixed multi-tenant trace through
    :class:`repro_torch.serving.AdaptiveScheduler` (window 1) or
    :class:`repro_torch.serving.ConcurrentScheduler` (window > 1) —
    per-request model-predicted configs, tuning-cache warm hits, JSONL
    telemetry, and drift-triggered refinement;
  * the fleet (``fleet_serve``, ``--worker-procs N``): the same trace
    through :class:`repro_torch.serving.FleetRouter` over N worker
    processes, tenants sharded across them, one CUDA context each.

LM requests are batched in fixed slots (``batch_slots`` sequences per batch,
the last batch may be short).  Each batch is prefilled in one forward pass;
its k/v are copied into a cache preallocated at ``prompt_len + gen_len``
and the recurrent layers (mamba, sLSTM, mLSTM) keep the state the prefill
left, and then every step decodes one token per sequence against that
cache.  Prompts come from
``np.random.default_rng(seed)`` exactly as in the JAX ``serve``, so both
packages serve the same tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --adaptive \
        [--device cpu] [--model heuristic] [--window 4]
    PYTHONPATH=src python -m repro_torch.launch.serve --worker-procs 2 \
        [--device cpu] [--model heuristic]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.models.model_zoo import Model, resolve_device
from repro_torch.models.transformer import RunConfig


@dataclasses.dataclass
class ServeResult:
    n_requests: int
    tokens_generated: int
    wall_s: float
    tokens_per_s: float
    outputs: list
    logits_finite: bool  # every prefill and decode logit was finite
    prefill_s: float     # wall time in prefill (and cache fill), all batches


def serve(
    arch: str,
    *,
    n_requests: int = 8,
    batch_slots: int = 4,
    prompt_len: int = 16,
    gen_len: int = 16,
    reduced: bool = True,
    seed: int = 0,
    greedy: bool = True,
    verbose: bool = True,
    device="cuda",
    params=None,
) -> ServeResult:
    """Serve ``n_requests`` random prompts.  ``params`` (the port's
    parameter dict, e.g. from ``repro_torch.weights.params_from_jax``)
    replaces the random init from ``seed``.  ``wall_s`` covers serving
    only, not the init."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is implemented")
    dev = resolve_device(device)
    model = Model(get_arch(arch).reduced() if reduced else get_arch(arch),
                  RunConfig(), device=dev)
    cfg = model.cfg
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    max_seq = prompt_len + gen_len

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (n_requests, prompt_len)).astype(np.int32)

    def make_batch(tokens):
        b = {"tokens": tokens}
        if cfg.frontend:
            b["embeds"] = torch.zeros(
                (tokens.shape[0], tokens.shape[1], cfg.frontend_dim),
                dtype=torch.float32, device=dev)
        return b

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    outputs = []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    total_tokens = 0
    prefill_s = 0.0
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for start in range(0, n_requests, batch_slots):
            chunk = torch.from_numpy(prompts[start:start + batch_slots]).to(dev)
            B = chunk.shape[0]
            tp = time.perf_counter()
            logits, filled = model.prefill(params, make_batch(chunk))
            cache = model.decode_cache(filled, max_seq)
            del filled
            sync()
            prefill_s += time.perf_counter() - tp
            finite &= torch.isfinite(logits).all()
            toks = logits.argmax(dim=-1)
            gen = [toks]
            for i in range(gen_len - 1):
                logits, cache = model.decode_step(
                    params, make_batch(toks[:, None]), cache, prompt_len + i)
                finite &= torch.isfinite(logits).all()
                toks = logits.argmax(dim=-1)
                gen.append(toks)
            seqs = torch.stack(gen, dim=1).to(torch.int32).cpu().numpy()
            outputs.extend(list(seqs))
            total_tokens += B * gen_len
            if verbose:
                print(f"batch {start // batch_slots}: {B} requests, "
                      f"{B * gen_len} tokens")
    all_finite = bool(finite.item())
    wall = time.perf_counter() - t0
    return ServeResult(
        n_requests=n_requests, tokens_generated=total_tokens, wall_s=wall,
        tokens_per_s=total_tokens / wall, outputs=outputs,
        logits_finite=all_finite, prefill_s=prefill_s)


DEFAULT_ADAPTIVE_WORKLOADS = ("vecadd", "dotprod", "mvmult")


def resolve_serving_model(spec: str = "latest", model_dir=None, *,
                          bootstrap: bool = True, verbose: bool = True,
                          metrics=None, device="cuda"):
    """Resolve ``--model`` to ``(model, info)``, the model on ``device``.

    ``spec`` is ``"latest"``, an artifact id, an artifact directory
    path, or ``"heuristic"`` — the explicit opt-in for the zero-training
    stand-in.  The default path serves from a registry-loaded trained
    artifact (``build/models`` or ``REPRO_TORCH_MODEL_DIR``); when
    ``latest`` resolves to an empty registry, a minimal artifact is
    bootstrap-trained on ``device`` and published first (one-off; the
    profile cache makes repeats cheap).  ``info["artifact_id"]`` doubles
    as the scheduler's ``model_tag`` so tuning-cache entries are keyed
    by model version and a hot-swapped model never serves stale picks.
    ``metrics`` (a MetricsRegistry) makes registry fallbacks — e.g. a
    dangling ``latest`` pointer resolving to the newest surviving
    version — countable instead of silent.
    """
    from repro_torch.core.modeling import OverlapHeuristicModel
    from repro_torch.core.modeling.registry import ModelRegistry

    dev = resolve_device(device)
    if spec == "heuristic":
        return OverlapHeuristicModel(), {
            "spec": spec, "kind": "heuristic", "artifact_id": "heuristic"}
    registry = ModelRegistry(model_dir, metrics=metrics)
    try:
        model, manifest = registry.load(spec)
    except FileNotFoundError:
        if spec != "latest" or not bootstrap:
            raise
        from repro_torch.launch.train_model import bootstrap_artifact
        artifact_id = bootstrap_artifact(registry, verbose=verbose,
                                         device=dev)
        model, manifest = registry.load(artifact_id)
    if hasattr(model, "to"):
        model = model.to(dev)      # artifacts load onto the CPU
    info = {"spec": spec, "kind": manifest["kind"],
            "artifact_id": manifest["artifact_id"],
            "corpus_fingerprint": manifest.get("corpus_fingerprint"),
            "cv_frac_of_oracle": (manifest.get("cv") or {}).get(
                "frac_of_oracle")}
    if verbose:
        print(f"serving model: {info['artifact_id']} "
              f"(kind={info['kind']}, registry={registry.root})",
              file=sys.stderr, flush=True)
    return model, info


def adaptive_serve(
    workloads: Sequence[str] = DEFAULT_ADAPTIVE_WORKLOADS,
    *,
    n_requests: int = 10,
    backend: str = "host-sync",
    policy: str = "fifo",
    slo_ms: Optional[float] = None,
    telemetry_path: Optional[str] = None,
    cache_path: Optional[str] = None,
    drift_threshold: float = 4.0,
    window: int = 1,
    workers: Optional[int] = None,
    tenants: int = 0,
    model: str = "latest",
    model_dir=None,
    seed: int = 0,
    verbose: bool = True,
    trace_out: Optional[str] = None,
    metrics_out: Optional[str] = None,
    resilience: bool = False,
    watchdog_ms: Optional[float] = None,
    fault_plan: Optional[str] = None,
    device="cuda",
) -> dict:
    """Serve ``n_requests`` of a mixed multi-tenant trace adaptively on
    ``device`` (the card unless ``device="cpu"``).

    ``window > 1`` serves through the concurrent engine with that many
    requests in flight; its drift signal is load-aware (measured wall
    time is normalized by window occupancy over host capacity before
    error computation), so thresholds need no loosening for contention.
    ``slo_ms`` stamps every request with a deadline that many
    milliseconds after its arrival; under ``policy="deadline"`` the
    queue serves earliest-deadline-first and sheds already-expired work
    (reported as ``shed`` in the summary) instead of burning capacity
    on guaranteed misses.  ``tenants > 0`` names that many tenants AND
    isolates them: each gets its own tuning-cache namespace, drift
    windows, and (on first refit) a private model fork; ``tenants=0``
    keeps the legacy two-tenant shared-state trace.  ``model`` selects
    the predictor: the default ``"latest"`` serves from the registry's
    pinned trained artifact (bootstrap-training one if the registry is
    empty); ``"heuristic"`` opts into the zero-training stand-in.
    Returns the telemetry summary dict (requests, hit rate,
    refinements, per-tenant breakdown, mean prediction error); the
    per-request JSONL stream lands at ``telemetry_path`` when given, and
    new tuning-cache entries persist to ``cache_path``.

    ``trace_out`` switches span tracing on and exports the run as Chrome
    trace-event JSON (load it in https://ui.perfetto.dev); a sibling
    ``.jsonl`` with the raw spans lands next to it.  ``metrics_out``
    switches the metrics registry on and saves its snapshot there;
    either flag also adds a ``metrics`` block to the returned summary.

    ``resilience=True`` (or a ``watchdog_ms`` / ``fault_plan``) arms the
    fault-tolerance layer: deadline-aware retries, the per-(tenant,
    stage) circuit breaker over the degradation ladder, an execution
    watchdog, and individual request failure instead of scheduler
    crashes — including falling back to the heuristic model when the
    registry itself cannot be loaded (the JAX package's documented
    degradation, counted in ``serving.faults.degraded``; the device is
    never swapped).  ``fault_plan`` names a
    :class:`~repro_torch.serving.FaultPlan` JSON for deterministic
    injection.
    """
    import warnings

    from repro_torch.core.autotuner import TuningCache
    from repro_torch.core.modeling import OverlapHeuristicModel
    from repro_torch.serving import (AdaptiveScheduler, ConcurrentScheduler,
                                     DriftDetector, FaultPlan,
                                     MetricsRegistry, ResiliencePolicy,
                                     TelemetryLog, Tracer, make_trace)

    dev = resolve_device(device)
    faults = FaultPlan.load(fault_plan) if fault_plan else None
    policy_obj = None
    if resilience or watchdog_ms is not None or faults is not None:
        policy_obj = ResiliencePolicy(
            watchdog_s=watchdog_ms / 1e3 if watchdog_ms else None)

    tracer = Tracer() if trace_out else None
    metrics = MetricsRegistry() if (metrics_out or trace_out) else None
    try:
        if faults is not None and faults.enabled:
            faults.bind(metrics=metrics)
            faults.fire("registry.load")
        serving_model, model_info = resolve_serving_model(
            model, model_dir, verbose=verbose, metrics=metrics, device=dev)
    except Exception as e:  # noqa: BLE001 — top ladder rung
        if policy_obj is None:
            raise
        # registry down ==> serve on the zero-training heuristic rather
        # than refuse traffic (the top rung of the degradation ladder)
        warnings.warn(f"serving model unavailable ({type(e).__name__}: "
                      f"{e}); falling back to the heuristic model")
        if metrics is not None:
            metrics.counter("serving.faults.degraded").inc()
        serving_model = OverlapHeuristicModel()
        model_info = {"spec": model, "kind": "heuristic",
                      "artifact_id": "heuristic-fallback"}
    occurrences = -(-n_requests // len(workloads))  # ceil
    trace = make_trace(list(workloads), occurrences=occurrences,
                       tenants=tenants if tenants > 0
                       else ("tenant-a", "tenant-b"),
                       seed=seed)[:n_requests]
    common = dict(
        device=dev, backend=backend, policy=policy,
        cache=TuningCache(cache_path),
        telemetry=TelemetryLog(telemetry_path),
        drift=DriftDetector(threshold=drift_threshold),
        isolate_tenants=tenants > 0,
        model_tag=model_info["artifact_id"],
        keep_outputs=False,
        tracer=tracer, metrics=metrics,
        faults=faults, resilience=policy_obj)
    if window > 1:
        sched = ConcurrentScheduler(serving_model,
                                    window=window, workers=workers,
                                    **common)
    else:
        sched = AdaptiveScheduler(serving_model, **common)
    # context-managed: telemetry is flushed/fsynced/closed even if the
    # trace dies mid-flight, so artifact uploads never see a truncated
    # last line
    with sched:
        sched.submit_all(trace)
        if slo_ms is not None:
            # arrival_s was stamped at submit; deadlines are absolute on
            # the scheduler's clock
            for req in trace:
                req.deadline_s = req.arrival_s + slo_ms / 1e3
        t0 = time.perf_counter()
        results = sched.run()
        wall = time.perf_counter() - t0
        if verbose:
            # progress goes to stderr so `--adaptive > summary.json`
            # stays valid JSON
            for r in results:
                if r.config is None or r.measured_s is None:
                    print(f"  #{r.sample.seq:<3d} {r.request.tenant:10s} "
                          f"{r.request.workload:12s} {r.status}: "
                          f"{r.error}", file=sys.stderr)
                    continue
                print(f"  #{r.sample.seq:<3d} {r.request.tenant:10s} "
                      f"{r.request.workload:12s} "
                      f"{r.config.partitions}x{r.config.tasks} "
                      f"{'hit ' if r.cache_hit else 'cold'} "
                      f"measured={r.measured_s*1e6:8.0f}us"
                      + (f" predicted={r.predicted_s*1e6:8.0f}us"
                         if r.predicted_s else ""), file=sys.stderr)
        summary = sched.telemetry.summary()
        summary["wall_s"] = wall
        summary["backend"] = backend
        summary["policy"] = policy
        summary["model"] = model_info
        summary["window"] = window
        summary["isolate_tenants"] = tenants > 0
        summary["throughput_rps"] = n_requests / max(wall, 1e-12)
        summary["slo_ms"] = slo_ms
        summary["shed"] = len(sched.queue.shed)
        summary["resilience"] = policy_obj is not None
        summary["device"] = str(dev)
        if faults is not None:
            summary["faults_injected"] = faults.fired
        if cache_path:
            sched.cache.save()
    if metrics is not None:
        snap = metrics.snapshot()
        # the compact dashboard block: single-valued families inline
        summary["metrics"] = {
            name: (fam["values"][0]["value"]
                   if len(fam["values"]) == 1
                   and not fam["values"][0]["labels"] else fam)
            for name, fam in snap.items()}
        if metrics_out:
            metrics.save(metrics_out)
            if verbose:
                print(f"metrics snapshot -> {metrics_out}",
                      file=sys.stderr)
    if tracer is not None and trace_out:
        n = tracer.export_chrome(trace_out)
        stem = trace_out[:-5] if trace_out.endswith(".json") else trace_out
        tracer.export_jsonl(stem + ".jsonl")
        if verbose:
            print(f"chrome trace ({n} spans) -> {trace_out} "
                  f"(+ {stem}.jsonl)", file=sys.stderr)
    return summary


def fleet_serve(
    workloads: Sequence[str] = DEFAULT_ADAPTIVE_WORKLOADS,
    *,
    n_requests: int = 16,
    worker_procs: int = 2,
    window: int = 2,
    backend: str = "host-sync",
    policy: str = "fifo",
    tenants: int = 8,
    model: str = "latest",
    model_dir=None,
    telemetry_path: Optional[str] = None,
    cache_path: Optional[str] = None,
    metrics_out: Optional[str] = None,
    drift_threshold: float = 4.0,
    wire: str = "auto",
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Serve a mixed multi-tenant trace through the fleet router:
    ``worker_procs`` spawn-isolated worker processes, each running its
    own :class:`~repro_torch.serving.ConcurrentScheduler` with
    ``window`` requests in flight on ``device`` (on the card, one CUDA
    context per worker process), tenants sharded stably across them.

    The model spec is resolved *once* here (bootstrap-training if the
    registry is empty, exactly like single-process serving) and the
    pinned artifact id is what ships to the workers — N processes load
    one immutable registry version instead of racing ``latest``.
    Returns the merged fleet summary: worker-labeled telemetry
    aggregates, a ``per_worker`` breakdown, respawn/death counters, and
    (when ``metrics_out`` is set) the merged worker-labeled metrics
    snapshot, which ``repro_torch.launch.stats --metrics`` renders
    unchanged.
    """
    from repro_torch.serving import make_trace
    from repro_torch.serving.fleet import FleetRouter, WorkerConfig

    dev = resolve_device(device)
    model_obj, model_info = resolve_serving_model(
        model, model_dir, verbose=verbose, device=dev)
    del model_obj                     # workers load their own copy
    spec = (model_info["artifact_id"]
            if model_info["kind"] != "heuristic" else "heuristic")
    occurrences = -(-n_requests // len(workloads))  # ceil
    trace = make_trace(list(workloads), occurrences=occurrences,
                       tenants=max(tenants, 1), seed=seed)[:n_requests]
    cfg = WorkerConfig(backend=backend, window=window, model=spec,
                       model_dir=model_dir, drift_threshold=drift_threshold,
                       cache_path=cache_path, wire=wire, device=str(dev))
    t0 = time.perf_counter()
    with FleetRouter(worker_procs, worker=cfg, policy=policy,
                     telemetry_path=telemetry_path) as router:
        router.submit_all(trace)
        results = router.run()
        if verbose:
            for r in results:
                cfg_s = ("x".join(map(str, r["config"]))
                         if r["config"] else "-")
                meas = (f"{r['measured_s']*1e6:8.0f}us"
                        if r["measured_s"] is not None else "        -")
                print(f"  {r['sample'].get('worker', '?'):3s} "
                      f"{r['tenant']:10s} {r['workload']:12s} {cfg_s:8s} "
                      f"{'hit ' if r['cache_hit'] else 'cold'} "
                      f"measured={meas} {r['status']}", file=sys.stderr)
        wall = time.perf_counter() - t0
    summary = router.summary()
    summary["wall_s"] = wall
    summary["backend"] = backend
    summary["policy"] = policy
    summary["model"] = model_info
    summary["window"] = window
    summary["worker_procs"] = worker_procs
    summary["throughput_rps"] = len(results) / max(wall, 1e-12)
    summary["ipc"] = dict(router.last_run)
    summary["device"] = str(dev)
    if verbose and summary.get("ipc_overhead_fraction") is not None:
        print(f"  ipc overhead: "
              f"{summary['ipc_overhead_fraction']*100:.1f}% of run wall "
              f"({summary['result_frames']} result frames, "
              f"{summary['dispatch_frames']} dispatch frames)",
              file=sys.stderr)
    if metrics_out:
        from repro_torch.serving.resilience import atomic_write_json
        atomic_write_json(metrics_out, router.metrics_snapshot())
        if verbose:
            print(f"merged fleet metrics -> {metrics_out}",
                  file=sys.stderr)
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(),
                    help="LM arch for the batched driver "
                         "(required unless --adaptive)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (cuda or cpu)")
    ap.add_argument("--adaptive", action="store_true",
                    help="serve a streamed-workload trace through the "
                         "adaptive scheduler instead of the LM driver")
    ap.add_argument("--workloads", default=",".join(
        DEFAULT_ADAPTIVE_WORKLOADS))
    ap.add_argument("--backend", default="host-sync")
    ap.add_argument("--policy", default="fifo",
                    choices=("fifo", "priority", "fair", "deadline"))
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request SLO: deadline = arrival + this "
                         "many ms (deadline policy sheds expired work)")
    ap.add_argument("--telemetry", default=None,
                    help="append-only JSONL telemetry path")
    ap.add_argument("--tuning-cache", default=None,
                    help="persistent tuning-cache JSON path")
    ap.add_argument("--window", type=int, default=None,
                    help="in-flight request window; >1 serves through "
                         "the concurrent engine (default: 1, or 2 per "
                         "worker under --worker-procs)")
    ap.add_argument("--workers", type=int, default=None,
                    help="concurrent engine pool size (default: window)")
    ap.add_argument("--worker-procs", type=int, default=0,
                    help="serve through the fleet router with this many "
                         "worker PROCESSES (tenant-sharded, respawn on "
                         "death, one CUDA context each on the card; "
                         "implies --adaptive).  Each worker runs its own "
                         "concurrent engine with --window requests in "
                         "flight; 0 = single-process")
    ap.add_argument("--wire", default="auto",
                    choices=["auto", "v2", "legacy"],
                    help="fleet result wire: 'v2' batched frames of "
                         "positional rows, 'legacy' per-request payload "
                         "dicts, 'auto' = $REPRO_FLEET_WIRE or v2 "
                         "(only meaningful with --worker-procs)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve N isolated tenants (per-tenant cache "
                         "namespace, drift windows, model fork on "
                         "refit); 0 = legacy shared-state trace "
                         "(8 tenants under --worker-procs)")
    ap.add_argument("--model", default="latest",
                    help="'latest' (registry-pinned trained artifact, "
                         "the default), an artifact id/path, or "
                         "'heuristic' for the zero-training fallback")
    ap.add_argument("--model-dir", default=None,
                    help="model registry root (default: "
                         "REPRO_TORCH_MODEL_DIR or <repo>/build/models)")
    ap.add_argument("--trace-out", default=None,
                    help="enable span tracing; write Chrome trace-event "
                         "JSON here (Perfetto-loadable; a .jsonl with "
                         "raw spans lands alongside)")
    ap.add_argument("--metrics-out", default=None,
                    help="enable the metrics registry; write its "
                         "snapshot JSON here (summary also gains a "
                         "'metrics' block)")
    ap.add_argument("--resilience", action="store_true",
                    help="arm the fault-tolerance layer: deadline-aware "
                         "retries, per-(tenant, stage) circuit breaker "
                         "over the degradation ladder, individual "
                         "request failure instead of scheduler crashes")
    ap.add_argument("--watchdog-ms", type=float, default=None,
                    help="execution watchdog: abandon + requeue-once a "
                         "dispatch exceeding this many ms (implies "
                         "--resilience)")
    ap.add_argument("--fault-plan", default=None,
                    help="FaultPlan JSON for deterministic fault "
                         "injection (implies --resilience)")
    args = ap.parse_args()

    if args.worker_procs and args.worker_procs > 0:
        summary = fleet_serve(
            args.workloads.split(","),
            n_requests=args.requests,
            worker_procs=args.worker_procs,
            window=args.window if args.window is not None else 2,
            backend=args.backend,
            policy=args.policy,
            tenants=args.tenants if args.tenants > 0 else 8,
            model=args.model, model_dir=args.model_dir,
            telemetry_path=args.telemetry,
            cache_path=args.tuning_cache,
            metrics_out=args.metrics_out,
            wire=args.wire, device=args.device)
        print(json.dumps(summary, indent=2))
        return

    if args.adaptive:
        summary = adaptive_serve(
            args.workloads.split(","),
            n_requests=args.requests, backend=args.backend,
            policy=args.policy, slo_ms=args.slo_ms,
            telemetry_path=args.telemetry,
            cache_path=args.tuning_cache,
            window=args.window if args.window is not None else 1,
            workers=args.workers, tenants=args.tenants,
            model=args.model, model_dir=args.model_dir,
            trace_out=args.trace_out, metrics_out=args.metrics_out,
            resilience=args.resilience, watchdog_ms=args.watchdog_ms,
            fault_plan=args.fault_plan, device=args.device)
        print(json.dumps(summary, indent=2))
        return

    if not args.arch:
        ap.error("--arch is required unless --adaptive is given")
    res = serve(args.arch, n_requests=args.requests, batch_slots=args.slots,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                device=args.device)
    print(f"{res.tokens_generated} tokens in {res.wall_s:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s)")


if __name__ == "__main__":
    main()
