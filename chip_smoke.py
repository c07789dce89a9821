#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

On one NVIDIA card (written for an H100) it

1. prints the card, builds the hand-written CUDA kernels from the sources
   in this checkout, and pins fp32 matmuls to full precision (no TF32);
2. holds each kernel against its plain PyTorch version on the card, at the
   JAX package's test shapes and at the yi-9b serving shapes, within the
   reference's tolerances, and checks the served tokens of reduced yi-9b on
   the card against the port's CPU path;
3. serves 8 requests on yi-9b at full width and depth (fp32, prompt 512,
   16 new tokens), then 4 requests on stablelm-3b at full width and depth
   (head dim 80, prompt 256, 8 new tokens), and checks for each that every
   kernel was launched as often as the model needs and that every logit is
   finite; then the recurrent and MoE blocks: reduced jamba, xlstm, grok
   and arctic on the card against the CPU, xlstm-350m served at full width
   and depth (4 slots, prompt 512, 16 new tokens), and grok-1-314b (2
   layers), jamba-1.5-large-398b (2) and arctic-480b (1) at full width,
   depth cut to fit the card, prefilled at 4 x 512 and decoded 8 tokens,
   each with its launch counts, peak memory, idle share and the time per
   step of its recurrence;
3c. trains on the card (``repro_torch.launch.train``): builds and reports
   the two backward kernels (flash attention, RMSNorm), holds each against
   its plain version at the training shapes, every head dim and widths
   16-8192 in fp32 and bf16; holds the gradients of reduced stablelm-3b and
   yi-9b (remat none, full, dots, with exact launch counts) and of
   stablelm-3b at full width and depth 2 against the CPU; trains the
   reduced models 8 steps against the CPU and runs the checkpoint resume
   drill; then ``train_loop`` trains stablelm-3b at full width and depth
   (2.8 B parameters, fp32, 4 x 512 tokens a step in 2 microbatches, 6
   steps) with exact launch counts, and prints step time, tokens/s, the
   share of the fp32 peak, peak memory, one profiled step's idle share and
   top kernels, and each backward kernel's time against its bounds, its
   plain version and the library's backward;
4. times each kernel at the serving shapes against its bounds, its plain
   version and the nearest single PyTorch call (the RMSNorm decode shape
   both per call, host included, and per launch on the device; RMSNorm with
   256 and with 1024 threads per row at the decode and prefill shapes), and
   prints the device time by kernel of one full-width prefill and one decode
   step (torch.profiler);
5. runs the paper's streamed-autotuning loop on the card: all 39 workloads
   at their smallest and largest dataset against the port on the CPU, the
   two runner backends against single-stream ``host-sync`` (up to (32, 64)),
   the D2H cost per slice, then ``train_model``'s ``train_and_publish`` on
   the 6-program corpus (profile 12 cells, leave-one-program-out with the
   MLP trained on the card, train, publish to ``build/models``), the
   12-cell table with ``host-pipelined`` at each best config, the
   heuristic's score, and the published artifact read back;
6. serves adaptively on the card (``repro_torch.serving``): bootstraps a
   model from an empty registry; serves 24 requests of the 6 programs at
   their largest dataset over 4 isolated tenants with the autotune phase's
   artifact, serially on ``host-sync`` and ``host-pipelined``, warm at
   window 1 and window 4 on ``host-sync``, and cold at window 4 on
   ``host-threads``, every output against the port on the CPU; runs the
   poison -> drift -> refinement drill and the ``adaptive_serve`` entry
   point with its trace and metrics files; prints requests/s, latency,
   stage times, hit rate, configs, the capacity probe, the pinning cost
   and the device's idle share; then serves the committed fault plan
   ``benchmarks/data/chaos_faults.json`` through ``adaptive_serve`` (400
   requests, ``host-threads``, window 4) and gates on no crash, every
   request terminal and no failure the plan did not inject;
7. scores the paper's baselines on the autotune phase's 12-cell corpus
   (no new profiling): Liu et al. and Werkhoven et al. from each cell's
   features, the k-NN classifier (k=3) under leave-one-program-out, beside
   the MLP's LOO and the heuristic; every pick must be a valid config;
8. serves the JAX package's real-trace configuration: 2,000 requests of
   ``generate_trace`` (Poisson; vecadd, dotprod, mvmult at dataset index
   4), through the concurrent engine at window 4 on ``host-sync`` with the
   autotune phase's artifact, drift off; prints requests/s, latency, hit
   rate, stage seconds and the coordinator's share of the wall, and holds
   the first request of every bucket against the CPU;
9. serves ``BENCH_fleet.json``'s configuration through the fleet router
   (``fleet_serve``'s path: 24 requests, 8 tenants, window 2,
   ``host-sync``, 3 reps) at 1, 2 and 4 worker processes, each with its
   own CUDA context on the card; prints cold and warm requests/s, the
   per-worker breakdown, ``ipc_overhead_fraction``, spawn seconds and
   each worker's device memory; runs the SIGKILL drill at 2 workers;
   serves two long warm windows (1,200 requests each, 6 in every task
   message, drift off) at 1, 2 and 4 workers, each with its even share
   of the host's cores, and at 4 workers with every core each, and
   prints requests/s, the
   intra-op threads each worker reported and each worker's engine time
   per request; holds the first request of every
   (workload, tenant) bucket, as each worker served it, against the CPU;
   times one message of 2, 12 and 46 MB through a pipe; and renders the
   merged telemetry and metrics of ``fleet_serve`` with
   ``launch/stats.py``;
10. runs the sharding layer (``repro_torch.parallel``, ``launch.mesh``,
   ``launch.elastic``) on a one-rank ``nccl`` process group and a (1, 1)
   card mesh: decodes yi-9b at full width and depth (fp32, 4 x 512 prompt
   tokens, 16 greedy steps) with ``decode_attn="sharded"`` and with
   ``"local"`` and gates on equal tokens, logits within 1e-4, caches within
   1e-6 and exact launch counts, printing decode ms a step both ways;
   distributes stablelm-3b's full-width parameters (from numpy) onto the
   card by their logical axes through ``reshard_tree`` and restores a
   reduced checkpoint with ``shardings``, each bitwise equal on readback;
   and runs the four ``examples/torch/`` scripts with ``--device cuda``,
   each gated on exit 0 and its own checks;
11. prints an ``{"autotune": {...}}`` line, a ``{"serving": {...}}``
   line, ``{"chaos": ...}``, ``{"recurrent_moe": ...}``,
   ``{"train": ...}``, ``{"baselines": ...}``, ``{"real_trace": ...}``,
   ``{"fleet": ...}`` and ``{"sharding": ...}`` lines, a
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

Any failure raises and exits non-zero.  Without CUDA, or without this
checkout's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): HBM bytes/s, fp32 CUDA-core, TF32 and
# bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

# the autotune phase's profile cache: the 12-cell card corpus the baselines
# phase reads back
CORPUS_CACHE = os.path.join(ROOT, "build", "chip_smoke", "profile_cache_cuda.json")

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# workloads and backends, card against the reference: the backend tolerance
# of tests/test_backends.py, but for
WL_RTOL, WL_ATOL = 2e-4, 1e-3
WL_TOL = {
    # float adds in the order the atomics land: the sum tolerance of
    # tests/test_workloads.py replaces the rtol
    "mri-gridding": (1e-3, WL_ATOL),
    # cuBLAS and the CPU's BLAS sum the two chained 256-long contractions
    # in other orders, and the values reach ~1e3-1e4: the chunk-invariance
    # tolerance of tests/test_workloads.py, which names 3mm for this
    "3mm": (1e-3, 0.1),
}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# yi-9b serving shapes: prefill of 4 slots x 512 tokens, 32 heads over 4 KV
# heads of 128; d_model 4096.
YI_ATTN = (4, 512, 32, 4, 128)
YI_NORM_PREFILL = (4, 512, 4096)
YI_NORM_DECODE = (4, 1, 4096)
# The other served head dims at prefill 4 x 512: stablelm-3b (32 heads of 80,
# no GQA) and pixtral-12b (32 heads over 8 KV heads of 160).
OTHER_ATTN = {"stablelm-3b": (4, 512, 32, 32, 80), "pixtral-12b": (4, 512, 32, 8, 160)}
# stablelm-3b serving shapes of phase 3: 4 slots x 256 tokens, 32 heads of
# 80; d_model 2560.
SL_ATTN = (4, 256, 32, 32, 80)
SL_NORM_PREFILL = (4, 256, 2560)
SL_NORM_DECODE = (4, 1, 2560)
# the recurrent and MoE phase: the row width of each arch (xlstm-350m,
# grok-1-314b, arctic-480b, jamba-1.5-large-398b: 8192 is the RMSNorm
# kernel's widest row), and the prefill attention of the archs that have it
# at 4 slots x 512 tokens (jamba's attention position is past the depth the
# card holds at full width)
RECURRENT_MOE_WIDTHS = {"xlstm-350m": 1024, "grok-1-314b": 6144, "arctic-480b": 7168,
                        "jamba-1.5-large-398b": 8192}
MOE_ATTN = {"grok-1-314b": (4, 512, 48, 8, 128), "arctic-480b": (4, 512, 56, 8, 128)}
# depth of each arch the card holds at full width in fp32 (parameters of
# the embedding, the LM head and that many layers: grok 45.8 GB, jamba
# 48.7 GB, arctic 56.3 GB of 80)
FULL_WIDTH_DEPTH = {"grok-1-314b": 2, "jamba-1.5-large-398b": 2, "arctic-480b": 1}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models.model_zoo import build_model

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. card and build ---------------------------------------------------
    card = smi()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built or 'up to date'} in {time.perf_counter() - t0:.2f} s "
          f"-> {_build.build_dir()}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    # -- 2. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    failures = []
    main_err = {}

    def attn_case(label, B, Sq, Sk, H, KV, hd, dtype, causal=True, blocks=None):
        q = randn((B, Sq, H, hd), dtype)
        k = randn((B, Sk, KV, hd), dtype)
        v = randn((B, Sk, KV, hd), dtype)
        if blocks is None:
            out = flash_attention_cuda(q, k, v, causal=causal)
        else:
            out = ops.flash_attention(q, k, v, causal=causal, q_block=blocks[0],
                                      kv_block=blocks[1])
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        ok = out.dtype == dtype and out.shape == q.shape and err <= tol
        print(f"  flash_attention {label:28s} {str(dtype):15s} causal={causal!s:5s} "
              f"max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention {label} {dtype}: {err:.3e}")
        return err

    print("kernels against their plain versions:")
    for B, S, H, KV, hd in [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64),
                            (1, 256, 6, 3, 128), (2, 128, 4, 1, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            attn_case(f"{(B, S, H, KV, hd)}", B, S, S, H, KV, hd, dtype)
    for qb, kb in [(64, 64), (128, 64), (64, 128)]:
        attn_case(f"blocks {(qb, kb)}", 1, 256, 256, 4, 2, 32, torch.float32,
                  blocks=(qb, kb))
    for dtype in (torch.float32, torch.bfloat16):
        attn_case("ragged S=500", 2, 500, 500, 8, 2, 64, dtype)
    attn_case("full, Sq=77 Sk=200", 1, 77, 200, 4, 2, 64, torch.float32, causal=False)
    attn_case("causal, Sq=77 Sk=200", 1, 77, 200, 4, 2, 64, torch.float32)
    attn_case("reduced yi-9b hd=16", 2, 64, 64, 4, 4, 16, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        attn_case("stablelm-3b hd=80 (2, 256, 32, 32)", 2, 256, 256, 32, 32, 80, dtype)
        attn_case("pixtral-12b hd=160 (2, 256, 32, 8)", 2, 256, 256, 32, 8, 160, dtype)
    B, S, H, KV, hd = YI_ATTN
    main_err["flash_attention"] = attn_case(
        f"yi-9b prefill {YI_ATTN}", B, S, S, H, KV, hd, torch.float32)
    B, S, H, KV, hd = SL_ATTN
    main_err["flash_attention"] = max(main_err["flash_attention"], attn_case(
        f"stablelm-3b prefill {SL_ATTN}", B, S, S, H, KV, hd, torch.float32))
    for arch, (B, S, H, KV, hd) in MOE_ATTN.items():
        main_err["flash_attention"] = max(main_err["flash_attention"], attn_case(
            f"{arch} prefill {(B, S, H, KV, hd)}", B, S, S, H, KV, hd, torch.float32))

    def norm_case(label, shape, dtype, ones=False):
        x = randn(shape, dtype)
        scale = (torch.ones(shape[-1], device=dev, dtype=dtype) if ones
                 else randn((shape[-1],), dtype))
        out = rmsnorm_cuda(x, scale)
        want = ref.rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = NORM_TOL[str(dtype).split(".")[1]]
        ok = out.dtype == dtype and out.shape == x.shape and err <= tol
        print(f"  rmsnorm {label:36s} {str(dtype):15s} "
              f"max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"rmsnorm {label} {dtype}: {err:.3e}")
        return err

    for rows, d in [(4, 64), (37, 96), (256, 128), (1, 32)]:
        for dtype in (torch.float32, torch.bfloat16):
            norm_case(f"{(rows, d)}", (rows, d), dtype)
    norm_case("3-D (2, 17, 64), unit scale", (2, 17, 64), torch.float32, ones=True)
    for dtype in (torch.float32, torch.bfloat16):
        norm_case("(3, 4099), scalar accesses", (3, 4099), dtype)
        norm_case("(2, 8192), widest row", (2, 8192), dtype)
    main_err["rmsnorm"] = norm_case(f"yi-9b prefill {YI_NORM_PREFILL}",
                                    YI_NORM_PREFILL, torch.float32)
    main_err["rmsnorm"] = max(main_err["rmsnorm"], norm_case(
        f"yi-9b decode {YI_NORM_DECODE}", YI_NORM_DECODE, torch.float32))
    for label, shape in (("prefill", SL_NORM_PREFILL), ("decode", SL_NORM_DECODE)):
        main_err["rmsnorm"] = max(main_err["rmsnorm"], norm_case(
            f"stablelm-3b {label} {shape}", shape, torch.float32))
    for arch, d in RECURRENT_MOE_WIDTHS.items():
        for label, shape in (("prefill", (4, 512, d)), ("decode", (4, 1, d))):
            main_err["rmsnorm"] = max(main_err["rmsnorm"], norm_case(
                f"{arch} {label} {shape}", shape, torch.float32))

    # The main path at a small size: reduced yi-9b, the same weights on the
    # card and on the CPU (plain versions) give the same logits and tokens.
    cpu_model = build_model("yi-9b", reduced=True, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    gpu_params = _to(cpu_params, dev)
    small = dict(n_requests=5, batch_slots=2, prompt_len=64, gen_len=8,
                 reduced=True, verbose=False)
    toks = torch.from_numpy(_prompts(cpu_model.cfg.vocab_size, (2, 64)))
    gpu_model = build_model("yi-9b", reduced=True, device=dev)
    with torch.inference_mode():
        lc, _ = cpu_model.prefill(cpu_params, {"tokens": toks})
        lg, _ = gpu_model.prefill(gpu_params, {"tokens": toks.to(dev)})
    err = (lg.cpu() - lc).abs().max().item()
    r_cpu = serve("yi-9b", device="cpu", params=cpu_params, **small)
    r_gpu = serve("yi-9b", device=dev, params=gpu_params, **small)
    same = all((a == b).all() for a, b in zip(r_cpu.outputs, r_gpu.outputs))
    ok = err <= 1e-4 and same and len(r_gpu.outputs) == 5
    print(f"  reduced yi-9b card vs CPU: prefill logits max_abs_err={err:.3e} "
          f"tol=1e-4, served tokens identical={same} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"reduced yi-9b card vs CPU: err {err:.3e}, same {same}")
    if failures:
        raise SystemExit("kernel checks failed:\n  " + "\n  ".join(failures))

    # -- 3. the main path at full width ---------------------------------------
    cfg = get_arch("yi-9b")
    n_req, slots, prompt_len, gen_len = 8, 4, 512, 16
    n_batches = -(-n_req // slots)
    n_forwards = n_batches * gen_len  # one prefill + gen_len - 1 decode steps each
    want_launches = launch_dict(flash_attention=n_batches * cfg.num_layers,
                                rmsnorm=n_forwards * (2 * cfg.num_layers + 1))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = serve("yi-9b", reduced=False, n_requests=n_req, batch_slots=slots,
                prompt_len=prompt_len, gen_len=gen_len, device="cuda")
    launches = ops.launch_counts()
    path_launches = dict(launches)  # every full-width run of the main path
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve yi-9b full width: {res.tokens_generated} tokens in "
          f"{res.wall_s:.3f} s ({res.tokens_per_s:.1f} tok/s); prefill "
          f"{res.prefill_s:.3f} s, decode {res.wall_s - res.prefill_s:.3f} s; "
          f"with init {total_s:.1f} s; peak memory {peak_gb:.1f} GB")
    print(f"launches on the main path: {launches} (expected {want_launches})")
    outputs_ok = (len(res.outputs) == n_req
                  and all(o.shape == (gen_len,) and (o >= 0).all()
                          and (o < cfg.vocab_size).all() for o in res.outputs))
    if launches != want_launches or not res.logits_finite or not outputs_ok:
        raise SystemExit(f"main path failed: launches {launches}, finite "
                         f"{res.logits_finite}, outputs ok {outputs_ok}")
    del res
    torch.cuda.empty_cache()

    # stablelm-3b at full width and depth (head dim 80): one batch.
    B, prompt_len, _, _, _ = SL_ATTN
    n_req, slots, gen_len, layers = B, B, 8, get_arch("stablelm-3b").num_layers
    want_sl = launch_dict(flash_attention=layers, rmsnorm=gen_len * (2 * layers + 1))
    ops.reset_launch_counts()
    res = serve("stablelm-3b", reduced=False, n_requests=n_req, batch_slots=slots,
                prompt_len=prompt_len, gen_len=gen_len, device="cuda")
    sl_launches = ops.launch_counts()
    print(f"serve stablelm-3b full width and depth: {res.tokens_generated} tokens in "
          f"{res.wall_s:.3f} s; launches {sl_launches} (expected {want_sl})")
    sl_ok = (len(res.outputs) == n_req
             and all(o.shape == (gen_len,) for o in res.outputs))
    if sl_launches != want_sl or not res.logits_finite or not sl_ok:
        raise SystemExit(f"stablelm-3b path failed: launches {sl_launches}, finite "
                         f"{res.logits_finite}, outputs ok {sl_ok}")
    del res
    torch.cuda.empty_cache()
    for k in path_launches:
        path_launches[k] += sl_launches[k]

    # -- 3b. the recurrent and MoE blocks ---------------------------------------
    recurrent = recurrent_moe_phase(torch, dev, card)
    for k in path_launches:
        path_launches[k] += recurrent["launches"][k]

    # -- 3c. the training stack ------------------------------------------------
    train = train_phase(torch, dev, card)
    for k in path_launches:
        path_launches[k] += train["launches"][k]

    # -- 4. times at the main-path shapes --------------------------------------
    def time_ms(fn, sets, iters=50):
        return cuda_time_ms(torch, fn, sets, iters)

    def attn_bounds(B, S, H, KV, hd):
        """The fp32 CUDA-core bound and the 3xTF32 tensor-core bound (3
        products per multiply-add) of causal attention, in ms, each with
        what bounds it."""
        pairs = S * (S + 1) // 2  # causal (query, key) pairs per head
        n_ops = 4 * B * H * hd * pairs
        n_bytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        return bound(n_bytes, n_ops, "float32"), bound(n_bytes, 3 * n_ops, "tf32")

    def time_attn(shape, plain=False):
        B, S, H, KV, hd = shape
        sets = [(randn((B, S, H, hd), torch.float32), randn((B, S, KV, hd), torch.float32),
                 randn((B, S, KV, hd), torch.float32)) for _ in range(4)]
        sdpa_sets = [tuple(t.transpose(1, 2).contiguous() for t in st) for st in sets]
        t_kernel = time_ms(lambda q, k, v: flash_attention_cuda(q, k, v, causal=True), sets)
        t_lib = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), sdpa_sets)
        t_plain = (time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True),
                           sets, iters=10) if plain else None)
        return sets, sdpa_sets, t_kernel, t_lib, t_plain

    rows = []
    attn_sets, sdpa_sets, t_kernel, t_lib, t_plain = time_attn(YI_ATTN, plain=True)
    q0, k0, v0 = attn_sets[0]
    t_dev, _, _ = device_ms(torch, lambda q, k, v: flash_attention_cuda(q, k, v, causal=True),
                            attn_sets)
    lib_err = (F.scaled_dot_product_attention(*sdpa_sets[0], is_causal=True, enable_gqa=True)
               .transpose(1, 2) - ref.flash_attention_ref(q0, k0, v0)).abs().max().item()
    del attn_sets, sdpa_sets
    (c_ms, c_by), (b_ms, b_by) = attn_bounds(*YI_ATTN)
    print(f"time flash_attention {YI_ATTN} fp32 causal: kernel {t_kernel:.4f} ms (device "
          f"{t_dev:.4f} ms a call, profiler), plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms (sdpa vs plain "
          f"max_abs_err {lib_err:.1e}), bound 3xTF32 tensor cores {b_ms:.4f} ms by "
          f"{b_by}, bound fp32 CUDA cores {c_ms:.4f} ms by {c_by}")
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:123",
        launches=path_launches["flash_attention"], max_abs_err=main_err["flash_attention"],
        ms=t_kernel, device_ms=t_dev, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib))
    for arch, shape in OTHER_ATTN.items():
        _, _, t_k, t_l, _ = time_attn(shape)
        (c_ms, _), (b_ms, _) = attn_bounds(*shape)
        print(f"time flash_attention {arch} {shape} fp32 causal: kernel {t_k:.4f} ms, "
              f"sdpa {t_l:.4f} ms, bound 3xTF32 {b_ms:.4f} ms, bound fp32 {c_ms:.4f} ms")

    norm_times = {}
    for label, shape in (("prefill", YI_NORM_PREFILL), ("decode", YI_NORM_DECODE)):
        d = shape[-1]
        sets = [(randn(shape, torch.float32), randn((d,), torch.float32))
                for _ in range(4)]
        # The decode shape is host-bound, and the host is shared: kernel and
        # F.rms_norm are timed in 5 alternating rounds and the medians kept.
        fns = {"kernel": lambda x, s: rmsnorm_cuda(x, s),
               "F.rms_norm": lambda x, s: F.rms_norm(x, (d,), weight=s, eps=1e-5)}
        rounds = {name: [] for name in fns}
        for r in range(5):
            for name in (fns if r % 2 == 0 else reversed(fns)):
                rounds[name].append(time_ms(fns[name], sets, iters=200))
        t_kernel, t_lib = (sorted(rounds[name])[2] for name in fns)
        t_plain = time_ms(lambda x, s: ref.rmsnorm_ref(x, s), sets)
        numel = 1
        for n in shape:
            numel *= n
        b_ms, b_by = bound(4 * (2 * numel + d), 4 * numel, "float32")
        t_dev, _, _ = device_ms(torch, fns["kernel"], sets, iters=100)
        norm_times[label] = (t_kernel, t_dev, t_plain, t_lib, b_ms, b_by)
        # A copy moves the same bytes (x read, y written): what the card's
        # memory reaches for this mix, beside the bound.
        t_copy = time_ms(lambda x, s: torch.empty_like(x).copy_(x), sets)
        print(f"time rmsnorm {label} {shape} fp32: kernel {t_kernel:.4f} ms (rounds "
              f"{min(rounds['kernel']):.4f}-{max(rounds['kernel']):.4f}; device {t_dev:.4f} "
              f"ms a call, profiler), plain "
              f"{t_plain:.4f} ms, F.rms_norm {t_lib:.4f} ms (rounds "
              f"{min(rounds['F.rms_norm']):.4f}-{max(rounds['F.rms_norm']):.4f}), copy of x "
              f"{t_copy:.4f} ms, bound {b_ms:.6f} ms by {b_by}")
    decode_device_us(torch, dev, randn, rmsnorm_cuda, F)
    norm_threads_us(torch)
    t_kernel, t_dev, t_plain, t_lib, b_ms, b_by = norm_times["prefill"]
    rows.append(dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:35", launches=path_launches["rmsnorm"],
        max_abs_err=main_err["rmsnorm"], ms=t_kernel, device_ms=t_dev, plain_ms=t_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=t_lib))

    rows.extend(train.pop("rows"))

    profile_main_path(torch, dev, build_model, cfg)

    # -- 5. the streamed-autotuning loop ---------------------------------------
    autotune = autotune_phase(torch, dev)

    # -- 6. adaptive serving ---------------------------------------------------
    serving = serving_phase(torch, dev, autotune["artifact_id"])
    chaos = chaos_phase(autotune["artifact_id"])

    # -- 7. the paper's baselines on the card corpus ---------------------------
    baselines = baselines_phase(dev, autotune)

    # -- 8. the real trace -----------------------------------------------------
    real_trace = real_trace_phase(torch, dev, autotune["artifact_id"])

    # -- 9. the fleet ----------------------------------------------------------
    fleet = fleet_phase(torch, autotune["artifact_id"])

    # -- 10. the sharding layer and the examples --------------------------------
    sharding = sharding_phase(torch, dev, card)
    for row in rows:
        row["launches"] += sharding["launches"].get(row["name"], 0)

    # -- 11. result ------------------------------------------------------------
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"autotune": autotune}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"chaos": chaos}))
    print(json.dumps({"recurrent_moe": recurrent}))
    print(json.dumps({"train": train}))
    print(json.dumps({"baselines": baselines}))
    print(json.dumps({"real_trace": real_trace}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"sharding": sharding}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cuda_time_ms(torch, fn, sets, iters=50):
    """Mean ms per call, cycling through input sets larger than L2: the
    median of 3 timed loops after 10 warm-up calls."""
    for i in range(10):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    loops = []
    for _ in range(3):
        start.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        loops.append(start.elapsed_time(end) / iters)
    return sorted(loops)[1]


def device_ms(torch, fn, sets, iters=20):
    """Device ms per call of ``fn`` from torch.profiler over ``iters`` calls
    cycling through ``sets`` after one warm-up call: for every kernel, copy
    or memset the calls launch, its mean time times its launches per call
    (its count over ``iters``, rounded: a trace can miss its first event),
    summed.  Returns the ms, the device ops launched per call and the ms
    a call by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn(*sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        raise SystemExit("device_ms: the profiler saw no device work")
    us, ops, parts = 0.0, 0, {}
    for e in ev:
        per_call = max(1, round(e.count / iters))
        part = (getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) \
            / e.count * per_call
        us += part
        ops += per_call
        name = re.search(r"(\w+)(<|\()", e.key)
        parts[name.group(1) if name else e.key[:40]] = part / 1e3
    return us / 1e3, ops, parts


def host_us(torch, fn, sets, iters=500):
    """Host us per call of ``fn``: the time until it returns (the launch
    enqueued, not run), over ``iters`` calls after a synchronize."""
    fn(*sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def ptxas_instances(log):
    """ptxas's report (``-Xptxas -v``) by kernel instance: the mangled
    entry function's registers and spill-store bytes."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = dict(registers=0, spill_stores=0)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def bound(n_bytes, n_ops, dtype):
    """The least time (ms) the card could take: bytes over its memory rate
    or operations over its peak for ``dtype``, the larger, and which."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def launch_dict(**counts):
    """A full ``ops.launch_counts()`` dict: the given counts, every other
    kernel 0 (a serving run launches no backward kernel)."""
    out = {"flash_attention": 0, "flash_attention_bwd": 0, "rmsnorm": 0, "rmsnorm_bwd": 0}
    for k, n in counts.items():
        if k not in out:
            raise KeyError(k)
        out[k] = n
    return out


def _norms_per_forward(cfg):
    """RMSNorm launches of one forward: norm1 in every block, norm2 where
    the block has an FFN, and the final norm."""
    from repro_torch.models import transformer

    P = len(cfg.layer_pattern)
    return sum(1 + transformer._has_ffn(cfg, l % P) for l in range(cfg.num_layers)) + 1


def _step_us(torch, fn, steps):
    """Host and wall microseconds per time step of ``fn()``, a full-sequence
    pass over ``steps`` steps: host = until ``fn`` returns, wall = until the
    card is done too."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return host / steps * 1e6, wall / steps * 1e6


def recurrent_moe_phase(torch, dev, card):
    """The mamba, MoE and xLSTM blocks on the card, fp32, random weights.

    1. Reduced jamba (all 8 pattern positions), xlstm, grok and arctic: the
       same weights on the card and on the CPU (plain versions) give the
       same prefill logits (atol 1e-4) and the same served tokens.
    2. xlstm-350m at full width and depth through ``serve``: 4 slots,
       prompt 512, 16 new tokens.
    3. grok-1-314b (2 layers), jamba-1.5-large-398b (2: mamba with the
       dense MLP, mamba with the 16-expert MoE) and arctic-480b (1) at full
       width through ``Model.prefill`` and ``Model.decode_step``: one batch
       of 4 x 512 prompt tokens and 8 new tokens.

    Each full-width run prints tokens/s with prefill and decode apart, peak
    device memory, the device's idle share over one decode step (and, for
    the three cut models, over one prefill), the host and wall time per
    step of each recurrent block's full-sequence pass, and its RMSNorm and
    flash launches against the counts the config implies; every logit must
    be finite.  Returns the summary, with the launches of the full-width
    runs summed; any failure raises."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers, mamba, xlstm
    from repro_torch.models.model_zoo import Model, build_model

    t_phase = time.perf_counter()
    out = {"card": card, "reduced": {}, "full": {}}
    total = launch_dict()
    failures = []

    # -- 1. reduced configs: card against CPU
    small = dict(n_requests=5, batch_slots=2, prompt_len=64, gen_len=8, reduced=True,
                 verbose=False)
    for arch in ("jamba-1.5-large-398b", "xlstm-350m", "grok-1-314b", "arctic-480b"):
        cpu_model = build_model(arch, reduced=True, device="cpu")
        cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
        gpu_params = _to(cpu_params, dev)
        gpu_model = build_model(arch, reduced=True, device=dev)
        toks = torch.from_numpy(_prompts(cpu_model.cfg.vocab_size, (2, 64)))
        with torch.inference_mode():
            lc, _ = cpu_model.prefill(cpu_params, {"tokens": toks})
            lg, _ = gpu_model.prefill(gpu_params, {"tokens": toks.to(dev)})
        err = (lg.cpu() - lc).abs().max().item()
        r_cpu = serve(arch, device="cpu", params=cpu_params, **small)
        r_gpu = serve(arch, device=dev, params=gpu_params, **small)
        same = all((a == b).all() for a, b in zip(r_cpu.outputs, r_gpu.outputs))
        ok = err <= 1e-4 and same and len(r_gpu.outputs) == 5 and r_gpu.logits_finite
        out["reduced"][arch] = dict(max_abs_err=err, tokens_identical=bool(same))
        print(f"recurrent/MoE: reduced {arch} ({cpu_model.cfg.num_layers} layers, pattern "
              f"{tuple(cpu_model.cfg.layer_pattern)}) card vs CPU: prefill logits "
              f"max_abs_err={err:.3e} tol=1e-4, served tokens identical={same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"reduced {arch} card vs CPU: err {err:.3e}, same {same}")
    del cpu_params, gpu_params
    torch.cuda.empty_cache()

    def recurrence(cfg, params, B, S):
        """Host and wall us per step of each recurrent block type's
        full-sequence pass at (B, S), on the first layer of that type."""
        gen = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
        row = {}
        for l, btype in enumerate(cfg.layer_pattern):
            bp = params["blocks"][l]
            if btype in row or btype == "attn":
                continue
            if btype == "mamba":
                def fn():
                    return mamba.mamba_apply(bp["mamba"], x, cfg.ssm)
            elif btype == "slstm":
                def fn():
                    return xlstm.slstm_apply(bp["cell"], x, cfg.num_heads)
            else:
                def fn():
                    return xlstm.mlstm_apply(bp["cell"], x, cfg.num_heads, cfg.xlstm)
            fn()                           # warm
            host, wall = _step_us(torch, fn, S)
            row[btype] = dict(host_us_per_step=host, wall_us_per_step=wall)
        return row

    def report(arch, cfg, row):
        rec = "; ".join(f"{b} full-sequence pass: host {v['host_us_per_step']:.1f} us, wall "
                        f"{v['wall_us_per_step']:.1f} us per step"
                        for b, v in row["recurrence"].items())
        print(f"recurrent/MoE: {arch} at full width, {cfg.num_layers} of "
              f"{get_arch(arch).num_layers} layers ({row['params'] / 1e9:.2f} B parameters, "
              f"{row['param_gb']:.1f} GB fp32): {row['tokens']} tokens in "
              f"{row['prefill_s'] + row['decode_s']:.3f} s = {row['tokens_per_s']:.1f} tok/s; "
              f"prefill {row['prefill_s']:.3f} s, decode {row['decode_s']:.3f} s "
              f"({row['decode_ms_per_step']:.2f} ms a step); peak memory "
              f"{row['peak_gb']:.1f} GB; launches {row['launches']} (expected "
              f"{row['want_launches']}); logits finite {row['finite']}; {card}")
        print(f"  idle over one decode step: {idle_line(row['idle_decode'])}")
        if "idle_prefill" in row:
            print(f"  idle over one prefill: {idle_line(row['idle_prefill'])}")
        if rec:
            print(f"  {rec}")
        if (row["launches"] != row["want_launches"] or not row["finite"]):
            failures.append(f"{arch} full width: launches {row['launches']} (expected "
                            f"{row['want_launches']}), finite {row['finite']}")
        for k in total:
            total[k] += row["launches"][k]
        out["full"][arch] = row

    B, P = 4, 512

    # -- 2. xlstm-350m at full width and depth, through serve
    cfg = get_arch("xlstm-350m")
    G = 16
    want = launch_dict(flash_attention=cfg.attn_layers, rmsnorm=G * _norms_per_forward(cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve("xlstm-350m", reduced=False, n_requests=B, batch_slots=B, prompt_len=P,
                gen_len=G, device="cuda", verbose=False)
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ok_out = len(res.outputs) == B and all(o.shape == (G,) for o in res.outputs)
    model = build_model("xlstm-350m", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = layers.param_count(params)
    toks = torch.from_numpy(_prompts(cfg.vocab_size, (B, P))).to(dev)
    with torch.inference_mode():
        logits, filled = model.prefill(params, {"tokens": toks})
        cache = model.decode_cache(filled, P + 2)
        nxt = {"tokens": logits.argmax(dim=-1)[:, None]}
        _, idle, _ = device_idle(torch, lambda: model.decode_step(params, nxt, cache, P),
                                 os.path.join(ROOT, "build", "chip_smoke", "xlstm_decode.json"))
    row = dict(depth=cfg.num_layers, params=n_params, param_gb=n_params * 4 / 1e9,
               tokens=res.tokens_generated, prefill_s=res.prefill_s,
               decode_s=res.wall_s - res.prefill_s, tokens_per_s=res.tokens_per_s,
               decode_ms_per_step=(res.wall_s - res.prefill_s) / (G - 1) * 1e3,
               peak_gb=peak_gb, launches=launches, want_launches=want,
               finite=bool(res.logits_finite and ok_out), idle_decode=idle,
               recurrence=recurrence(cfg, params, B, P))
    report("xlstm-350m", cfg, row)
    del res, model, params, logits, filled, cache
    torch.cuda.empty_cache()

    # -- 3. MoE and mamba at full width, depth cut to fit the card
    G = 8
    for arch, depth in FULL_WIDTH_DEPTH.items():
        base = get_arch(arch)
        cfg = dataclasses.replace(base, num_layers=depth,
                                  layer_pattern=tuple(base.layer_pattern)[:depth])
        want = launch_dict(flash_attention=cfg.attn_layers,
                           rmsnorm=G * _norms_per_forward(cfg))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = layers.param_count(params)
        toks = torch.from_numpy(_prompts(cfg.vocab_size, (B, P))).to(dev)
        ops.reset_launch_counts()
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, filled = model.prefill(params, {"tokens": toks})
            cache = model.decode_cache(filled, P + G)
            del filled
            finite = torch.isfinite(logits).all()
            tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            for i in range(G - 1):
                logits, cache = model.decode_step(params, {"tokens": tok[:, None]}, cache,
                                                  P + i)
                finite &= torch.isfinite(logits).all()
                tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0 - prefill_s
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with torch.inference_mode():
            nxt = {"tokens": tok[:, None]}
            _, idle_d, _ = device_idle(
                torch, lambda: model.decode_step(params, nxt, cache, P + G - 1),
                os.path.join(ROOT, "build", "chip_smoke", f"{arch}_decode.json"))
            _, idle_p, _ = device_idle(
                torch, lambda: model.prefill(params, {"tokens": toks}),
                os.path.join(ROOT, "build", "chip_smoke", f"{arch}_prefill.json"))
        row = dict(depth=depth, params=n_params, param_gb=n_params * 4 / 1e9, init_s=init_s,
                   tokens=B * G, prefill_s=prefill_s, decode_s=decode_s,
                   tokens_per_s=B * G / (prefill_s + decode_s),
                   decode_ms_per_step=decode_s / (G - 1) * 1e3, peak_gb=peak_gb,
                   launches=launches, want_launches=want, finite=bool(finite.item()),
                   idle_decode=idle_d, idle_prefill=idle_p,
                   recurrence=recurrence(cfg, params, B, P))
        report(arch, cfg, row)
        del model, params, logits, cache, tok
        torch.cuda.empty_cache()

    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"recurrent/MoE: launches of the full-width runs {total}; phase "
          f"{out['phase_s']:.1f} s")
    if failures:
        raise SystemExit("recurrent/MoE phase failed:\n  " + "\n  ".join(failures))
    return out


# the training phase: stablelm-3b at full width and depth, 4 x 512 tokens a
# step in two microbatches, 6 steps; the backward kernels at the shapes of
# one microbatch (2 x 512 tokens, 32 heads of 80; rows x d_model)
TRAIN_FULL = dict(batch=4, seq=512, microbatches=2, steps=6)
TRAIN_ATTN = (2, 512, 32, 32, 80)
TRAIN_NORM = (1024, 2560)
TRAIN_GQA_ATTN = (2, 512, 32, 4, 128)  # yi-9b's attention at the same batch and length
# the hand-written kernels by their CUDA names, for their share of a step
OWN_KERNELS = ("flash_fwd_kernel", "flash_bwd_dot_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_dq_kernel", "rmsnorm_kernel", "rmsnorm_bwd_kernel",
               "rmsnorm_bwd_colsum_kernel")
# card against CPU: model gradients within the CPU parity tests' atol
# (tests/test_torch_grads.py); at full width each leaf within 1e-4 of its
# largest gradient, since a full-width product sums 2560-6912 terms in
# another order on each side; training losses within 1e-4 relative (10x
# the CPU parity test's 1e-5: the card sums every product in another order
# and Adam carries the differences from step to step)
TRAIN_GRAD_ATOL = 1e-5
TRAIN_FULL_GRAD_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-4


def _copy(tree, device):
    """A detached copy of a parameter tree on ``device``."""
    from repro_torch import tree as tree_lib

    return tree_lib.map(lambda p: p.detach().to(device, copy=True), tree)


def _loss_and_grads(model, params, batch):
    """One forward and backward of ``model.loss``: (loss, tree of grads)."""
    from repro_torch import tree as tree_lib

    for p in tree_lib.leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = model.loss(params, batch)
    loss.backward()
    return float(loss.detach()), tree_lib.map(lambda p: p.grad, params)


def _batch(torch, cfg, batch, seq, step, device):
    """``SyntheticLM`` batch ``step`` (seed 0) as tensors on ``device``."""
    import numpy as np

    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0)).batch_at(step)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}


def _train_losses(torch, cfg, params, device, *, steps, batch, seq, microbatches, ocfg):
    """Losses of ``steps`` train steps of config ``cfg`` from a copy of
    ``params`` on ``device``."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model_zoo import Model
    from repro_torch.optim import optimizer as opt_lib

    model = Model(cfg, device=device)
    params = _copy(params, device)
    state = opt_lib.init_state(params, ocfg)
    step = make_train_step(model, ocfg, microbatches)
    losses = []
    for i in range(steps):
        params, state, loss, _ = step(params, state,
                                      _batch(torch, model.cfg, batch, seq, i, device))
        losses.append(float(loss))
    return losses


def _continued_losses(torch, arch, *, first, then, batch, seq, device, lr=1e-3, seed=0):
    """Steps ``first`` .. ``then - 1`` of a run that trains ``first`` steps
    under ``train_loop(steps=first)``'s schedule and goes on in memory, with
    no checkpoint, under ``train_loop(steps=then)``'s: what ``train_loop``
    resumed from a checkpoint of step ``first - 1`` must reproduce."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model_zoo import Model
    from repro_torch.optim import optimizer as opt_lib

    model = Model(get_arch(arch).reduced(), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    state, losses = None, []
    for steps, lo, hi in ((first, 0, first), (then, first, then)):
        ocfg = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
        state = state or opt_lib.init_state(params, ocfg)
        step = make_train_step(model, ocfg)
        for i in range(lo, hi):
            params, state, loss, _ = step(params, state,
                                          _batch(torch, model.cfg, batch, seq, i, device))
            losses.append(float(loss))
    return losses[first:]


def train_phase(torch, dev, card):
    """The training stack on the card, fp32 (TF32 off), random weights.

    (a) The two backward kernels' build: registers and spills of every
        instance (ptxas); the flash-attention backward's instances at head
        dims 80 and 128 (training, serving) must not spill.
    (b) Both backward kernels against their plain versions on the card:
        flash attention at the stablelm-3b training shape (2, 512, 32, 32,
        80), with GQA at (2, 512, 32, 4, 128), and at every head dim on
        (1, 77, 8, 2, hd), fp32 and bf16, causal, plus a ragged Sq != Sk
        causal and full; the forward's row log-sum-exp beside them; RMSNorm
        at rows (2048, 2560), (1024, 4096) and widths 16-8192, fp32 and
        bf16, with an fp32 and a bf16 scale.  Tolerance: max abs error at
        most tol * max(1, max |plain|), tol the forward's (attention 2e-5
        fp32, 2e-2 bf16; RMSNorm 1e-5, 2e-2); and a second call on the same
        inputs bitwise equal to the first (no atomics: the resume drill's
        equality rests on it).
    (c) Reduced stablelm-3b and yi-9b (over 2 KV heads: GQA), initialised
        on the CPU and copied to the card: one forward and backward under remat none, full and dots
        gives every parameter a gradient that is not all zero, each leaf
        within atol 1e-5 of the CPU's, and exactly the launches the remat
        mode implies of all four kernels.
    (d) 8 train steps (2 microbatches) of both reduced models on the card
        and on the CPU from the same parameters: losses within 1e-4
        relative.  Then the resume drill: ``train_loop`` to 6 steps with a
        checkpoint every 3, then to 9 from the checkpoint; steps 6-8 equal
        (1e-6 relative) an in-memory continuation's.
    (e) stablelm-3b at full width, depth 2, batch 1 x 512: every gradient
        leaf of the card within 1e-4 of the leaf's largest CPU gradient.
    (f) ``train_loop("stablelm-3b", reduced=False, batch=4, seq=512,
        microbatches=2, steps=6)`` at full width and depth, no checkpoint:
        finite losses, grad_norm > 0 every step, exact launch counts; the
        median step time of steps 2-6, tokens/s, 6 N tokens / step time
        as a share of 67 TFLOP/s, peak memory; one more step under the
        profiler for its idle share and top kernels; each backward
        kernel's time at a microbatch's shape (events around a loop of
        calls, and the profiler's device time a call over all of the
        wrapper's launches) beside its bounds, its plain version and the
        library's backward (SDPA; ``F.rms_norm``) through
        ``torch.autograd.grad`` on a kept graph.

    Returns the summary with the launches of (f) and the two kernel rows;
    any failure raises."""
    import dataclasses
    import math
    import shutil
    import statistics

    import torch.nn.functional as F

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    from repro_torch.launch import train as train_mod
    from repro_torch.models import layers
    from repro_torch.models.model_zoo import Model
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim import optimizer as opt_lib

    t_phase = time.perf_counter()
    out = {"card": card, "ptxas": {}}
    failures = []

    # -- (a) the backward kernels' build
    for name in ("flash_attention_bwd", "rmsnorm_bwd"):
        insts = ptxas_instances(_build.build_log(name))
        if not insts:
            raise SystemExit(f"train (a): no ptxas report in the build log of {name}")
        regs = [i["registers"] for i in insts.values()]
        spills = [i["spill_stores"] for i in insts.values()]
        out["ptxas"][name] = dict(instances=len(insts), registers=[min(regs), max(regs)],
                                  max_spill_store_bytes=max(spills))
        print(f"train (a): {name}: {len(insts)} kernel instances, {min(regs)}-{max(regs)} "
              f"registers, spill stores at most {max(spills)} bytes")
        if name != "flash_attention_bwd":
            continue
        # the attention backward's instances by kernel, dtype and head dim;
        # the training and serving head dims (80, 128) must not spill
        gated = []
        for fn, inst in sorted(insts.items()):
            m = re.search(r"flash_bwd_(dkdv|dq)_kernelI(f|13__nv_bfloat16)Li(\d+)E", fn)
            if not m:
                continue
            kind, dtype, hd = m.group(1), "fp32" if m.group(2) == "f" else "bf16", int(m.group(3))
            must = hd in (80, 128)
            ok = not must or inst["spill_stores"] == 0
            print(f"  {kind:4s} {dtype} hd {hd:3d}: {inst['registers']} registers, spill stores "
                  f"{inst['spill_stores']} bytes" + (f" (gated: 0) {'ok' if ok else 'FAIL'}"
                                                     if must else ""))
            gated.append(must)
            if not ok:
                failures.append(f"flash_attention_bwd {kind} {dtype} hd {hd} spills "
                                f"{inst['spill_stores']} bytes")
        if sum(gated) != 8:  # dkdv and dq, fp32 and bf16, hd 80 and 128
            failures.append(f"flash_attention_bwd: {sum(gated)} of the 8 gated instances found")
    if failures:
        raise SystemExit("train (a) failed:\n  " + "\n  ".join(failures))

    # -- (b) the backward kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err_of(got, want):
        err = (got.float() - want.float()).abs().max().item()
        return err, err / max(1.0, want.float().abs().max().item())

    main_err = {}

    def attn_bwd_case(label, B, Sq, Sk, H, KV, hd, dtype, causal=True):
        q, k, v = randn((B, Sq, H, hd), dtype), randn((B, Sk, KV, hd), dtype), \
            randn((B, Sk, KV, hd), dtype)
        do = randn((B, Sq, H, hd), dtype)
        o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        lse_want = ref.flash_attention_lse_ref(q, k, causal=causal)
        torch.cuda.synchronize()
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        errs = [err_of(g, w) for g, w in zip(got, want)]
        lse_err = err_of(lse, lse_want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = (all(s <= tol for _, s in errs) and lse_err[1] <= ATTN_TOL["float32"] and same
              and all(g.dtype == t.dtype and g.shape == t.shape
                      for g, t in zip(got, (q, k, v))))
        print(f"  flash_attention_bwd {label:30s} {str(dtype):15s} causal={causal!s:5s} "
              f"max_abs_err dq {errs[0][0]:.2e} dk {errs[1][0]:.2e} dv {errs[2][0]:.2e} "
              f"(scaled {max(s for _, s in errs):.2e}) lse {lse_err[0]:.2e} tol={tol:g}; "
              f"a second call bitwise equal {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"flash_attention_bwd {label} {dtype}: {errs}, lse {lse_err}, "
                            f"bitwise equal {same}")
        return max(e for e, _ in errs)

    def norm_bwd_case(label, rows, d, dtype, scale_dtype=torch.float32):
        x, s, dy = randn((rows, d), dtype), randn((d,), scale_dtype), randn((rows, d), dtype)
        dx, ds = rmsnorm_bwd_cuda(x, s, dy)
        dx2, ds2 = rmsnorm_bwd_cuda(x, s, dy)
        wdx, wds = ref.rmsnorm_bwd_ref(x, s, dy)
        torch.cuda.synchronize()
        tol = NORM_TOL[str(dtype).split(".")[1]]
        e_dx, e_ds = err_of(dx, wdx), err_of(ds, wds)
        same = torch.equal(dx, dx2) and torch.equal(ds, ds2)
        ok = (e_dx[1] <= tol and e_ds[1] <= NORM_TOL[str(scale_dtype).split(".")[1]]
              and same and dx.dtype == dtype and ds.dtype == scale_dtype)
        print(f"  rmsnorm_bwd {label:30s} {str(dtype):15s} scale {str(scale_dtype):15s} "
              f"max_abs_err dx {e_dx[0]:.2e} dscale {e_ds[0]:.2e} (scaled "
              f"{max(e_dx[1], e_ds[1]):.2e}) tol={tol:g}; a second call bitwise equal {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"rmsnorm_bwd {label} {dtype}: dx {e_dx}, dscale {e_ds}, "
                            f"bitwise equal {same}")
        return max(e_dx[0], e_ds[0])

    print("train (b): backward kernels against their plain versions:")
    for dtype in (torch.float32, torch.bfloat16):
        e = attn_bwd_case(f"stablelm-3b train {TRAIN_ATTN}", *TRAIN_ATTN[:2], TRAIN_ATTN[1],
                          *TRAIN_ATTN[2:], dtype)
        if dtype == torch.float32:
            main_err["flash_attention_bwd"] = e
        attn_bwd_case("GQA (2, 512, 32, 4, 128)", 2, 512, 512, 32, 4, 128, dtype)
        for hd in HEAD_DIMS:
            attn_bwd_case(f"(1, 77, 8, 2, {hd})", 1, 77, 77, 8, 2, hd, dtype)
    attn_bwd_case("ragged Sq=77 Sk=200", 1, 77, 200, 4, 2, 64, torch.float32)
    attn_bwd_case("ragged Sq=77 Sk=200", 1, 77, 200, 4, 2, 64, torch.float32, causal=False)
    for dtype in (torch.float32, torch.bfloat16):
        e = norm_bwd_case(f"stablelm-3b train {TRAIN_NORM}", *TRAIN_NORM, dtype)
        if dtype == torch.float32:
            main_err["rmsnorm_bwd"] = e
        norm_bwd_case("(2048, 2560)", 2048, 2560, dtype)
        norm_bwd_case("(1024, 4096)", 1024, 4096, dtype)
        for d in (16, 32, 100, 1000, 4099, 8192):
            norm_bwd_case(f"(7, {d})", 7, d, dtype)
    norm_bwd_case("(64, 2560), bf16 scale", 64, 2560, torch.bfloat16, torch.bfloat16)
    if failures:
        raise SystemExit("train (b) failed:\n  " + "\n  ".join(failures))

    # -- (c) reduced models: gradients on the card against the CPU, and the
    # launches of one forward and backward under each remat mode
    out["reduced"] = {}
    # reduced yi-9b keeps 4 of 4 KV heads and so equals reduced stablelm-3b;
    # over 2 KV heads it keeps yi-9b's grouped queries (GQA, G = 2)
    for arch, kv in (("stablelm-3b", None), ("yi-9b", 2)):
        cfg = get_arch(arch).reduced()
        if kv is not None:
            cfg = dataclasses.replace(cfg, num_kv_heads=kv)
            arch = f"{arch} (KV {kv})"
        L = cfg.num_layers
        cpu_model = Model(cfg, device="cpu")
        params_cpu = cpu_model.init(torch.Generator().manual_seed(0))
        init_cpu = _copy(params_cpu, "cpu")
        loss_cpu, g_cpu = _loss_and_grads(cpu_model, params_cpu,
                                          _batch(torch, cfg, 4, 64, 0, "cpu"))
        want_leaves = tree_lib.leaves(g_cpu)
        row = {"loss_cpu": loss_cpu}
        g_none = None
        for remat in ("none", "full", "dots"):
            model = Model(cfg, RunConfig(remat=remat), device=dev)
            params = _copy(init_cpu, dev)
            ops.reset_launch_counts()
            loss, grads = _loss_and_grads(model, params, _batch(torch, cfg, 4, 64, 0, dev))
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            f = 1 if remat == "none" else 2  # remat runs each group's forward again
            want = launch_dict(flash_attention=f * L, flash_attention_bwd=L,
                               rmsnorm=f * 2 * L + 1, rmsnorm_bwd=2 * L + 1)
            leaves = tree_lib.leaves(grads)
            present = all(g is not None and bool(g.abs().max() > 0) for g in leaves)
            err = max((g.cpu() - w).abs().max().item() for g, w in zip(leaves, want_leaves))
            same = (g_none is None or max((a - b).abs().max().item() for a, b in
                                          zip(leaves, tree_lib.leaves(g_none))) <= TRAIN_GRAD_ATOL)
            g_none = g_none or grads
            ok = (present and err <= TRAIN_GRAD_ATOL and launches == want and same
                  and abs(loss - loss_cpu) <= 1e-5 * max(1.0, abs(loss_cpu)))
            print(f"train (c): reduced {arch} remat={remat}: loss {loss:.6f} (CPU "
                  f"{loss_cpu:.6f}); {len(leaves)} gradient leaves, all present and nonzero "
                  f"{present}; max abs err vs CPU {err:.2e} (atol {TRAIN_GRAD_ATOL:g}); equal to "
                  f"remat none {same}; launches {launches} (expected {want}) "
                  f"{'ok' if ok else 'FAIL'}")
            row[remat] = dict(loss=loss, max_abs_err=err, launches=launches)
            if not ok:
                failures.append(f"reduced {arch} remat={remat}: present {present}, err "
                                f"{err:.2e}, launches {launches} vs {want}, same {same}")
        out["reduced"][arch] = row

        # -- (d) 8 train steps on the card and on the CPU
        ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
        kw = dict(steps=8, batch=4, seq=64, microbatches=2, ocfg=ocfg)
        on_card = _train_losses(torch, cfg, init_cpu, dev, **kw)
        on_cpu = _train_losses(torch, cfg, init_cpu, "cpu", **kw)
        rel = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
        ok = rel <= TRAIN_LOSS_RTOL and all(math.isfinite(x) for x in on_card)
        print(f"train (d): reduced {arch}, 8 steps of 4 x 64 in 2 microbatches: card "
              f"losses {[round(x, 6) for x in on_card]}, max rel diff vs CPU {rel:.2e} "
              f"(tol {TRAIN_LOSS_RTOL:g}) {'ok' if ok else 'FAIL'}")
        row["train_losses"], row["train_losses_cpu"], row["train_rel_diff"] = \
            on_card, on_cpu, rel
        if not ok:
            failures.append(f"reduced {arch} training: rel diff {rel:.2e}")

    # the resume drill on the card
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke", "train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(batch=4, seq=64, ckpt_dir=ckpt_dir, ckpt_every=3, verbose=False, device="cuda")
    r1 = train_mod.train_loop("stablelm-3b", steps=6, **kw)
    r2 = train_mod.train_loop("stablelm-3b", steps=9, **kw)
    cont = _continued_losses(torch, "stablelm-3b", first=6, then=9, batch=4, seq=64,
                             device=dev)
    rel = max((abs(a - b) / abs(b) for a, b in zip(r2.losses, cont)), default=float("inf"))
    ok = (r1.steps_run == 6 and r2.resumed_from == 5 and r2.steps_run == 3
          and len(r2.losses) == len(cont) and rel <= 1e-6)
    print(f"train (d): resume drill: 6 steps (checkpoints at steps 2, 5), then to 9: resumed "
          f"from {r2.resumed_from}, ran {r2.steps_run}; losses {r2.losses} against the "
          f"in-memory continuation's {cont} (max rel diff {rel:.2e}, bitwise equal "
          f"{r2.losses == cont}) {'ok' if ok else 'FAIL'}")
    out["resume"] = dict(resumed_from=r2.resumed_from, steps_run=r2.steps_run,
                         losses=r2.losses, continued=cont, bitwise=r2.losses == cont)
    if not ok:
        failures.append(f"resume drill: resumed {r2.resumed_from}, ran {r2.steps_run}, "
                        f"rel {rel:.2e}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if failures:
        raise SystemExit("train (c)-(d) failed:\n  " + "\n  ".join(failures))

    # -- (e) full width, depth 2: every gradient leaf against the CPU
    cfg = dataclasses.replace(get_arch("stablelm-3b"), num_layers=2)
    cpu_model = Model(cfg, device="cpu")
    params_cpu = cpu_model.init(torch.Generator().manual_seed(0))
    init_dev = _copy(params_cpu, dev)
    t0 = time.perf_counter()
    loss_cpu, g_cpu = _loss_and_grads(cpu_model, params_cpu, _batch(torch, cfg, 1, 512, 0, "cpu"))
    cpu_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    loss, grads = _loss_and_grads(Model(cfg, device=dev), init_dev,
                                  _batch(torch, cfg, 1, 512, 0, dev))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = launch_dict(flash_attention=2, flash_attention_bwd=2, rmsnorm=5, rmsnorm_bwd=5)
    worst, present = 0.0, True
    for g, w in zip(tree_lib.leaves(grads), tree_lib.leaves(g_cpu)):
        present &= g is not None and bool(g.abs().max() > 0)
        worst = max(worst, (g.cpu() - w).abs().max().item()
                    / max(w.abs().max().item(), 1e-30))
    n_params = layers.param_count(params_cpu)
    ok = (present and worst <= TRAIN_FULL_GRAD_RTOL and launches == want
          and abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu))
    print(f"train (e): stablelm-3b full width, depth 2 ({n_params / 1e9:.3f} B parameters), "
          f"1 x 512: loss {loss:.6f} (CPU {loss_cpu:.6f}, {cpu_s:.1f} s on the CPU); every "
          f"leaf present and nonzero {present}; worst leaf max abs err / its largest CPU "
          f"gradient {worst:.2e} (tol {TRAIN_FULL_GRAD_RTOL:g}); launches {launches} "
          f"(expected {want}) {'ok' if ok else 'FAIL'}")
    out["full_depth2"] = dict(params=n_params, loss=loss, loss_cpu=loss_cpu,
                              worst_rel_err=worst, launches=launches)
    if not ok:
        failures.append(f"full width depth 2: present {present}, worst {worst:.2e}, "
                        f"launches {launches}")
    del params_cpu, g_cpu, init_dev, grads
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit("train (e) failed:\n  " + "\n  ".join(failures))

    # -- (f) train_loop at full width and depth
    cfg = get_arch("stablelm-3b")
    steps, mb = TRAIN_FULL["steps"], TRAIN_FULL["microbatches"]
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
    fwd = steps * mb  # forwards and backwards in the run
    want = launch_dict(flash_attention=fwd * cfg.num_layers,
                       flash_attention_bwd=fwd * cfg.num_layers,
                       rmsnorm=fwd * (2 * cfg.num_layers + 1),
                       rmsnorm_bwd=fwd * (2 * cfg.num_layers + 1))
    grad_norms, watchdogs = [], []
    apply_updates, watchdog_cls = opt_lib.apply_updates, train_mod.StragglerWatchdog

    def recording_apply_updates(*a, **kw):
        res = apply_updates(*a, **kw)
        grad_norms.append(float(res[2]["grad_norm"]))
        return res

    class RecordingWatchdog(watchdog_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            watchdogs.append(self)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt_lib.apply_updates, train_mod.StragglerWatchdog = recording_apply_updates, \
        RecordingWatchdog
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_mod.train_loop("stablelm-3b", reduced=False, device="cuda", verbose=True,
                                   **TRAIN_FULL)
        run_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        opt_lib.apply_updates, train_mod.StragglerWatchdog = apply_updates, watchdog_cls
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = watchdogs[0].history
    median_s = statistics.median(step_s[1:])
    torch.cuda.empty_cache()

    # one more step under the profiler, on parameters of its own
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = layers.param_count(params)
    ocfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    state = opt_lib.init_state(params, ocfg)
    step = train_mod.make_train_step(model, ocfg, mb)
    batch = _batch(torch, cfg, TRAIN_FULL["batch"], TRAIN_FULL["seq"], 0, dev)
    step(params, state, batch)
    _, idle, prof = device_idle(torch, lambda: step(params, state, batch),
                                os.path.join(ROOT, "build", "chip_smoke", "train_step.json"))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    top = [(e.key, dev_us(e) / 1e3, e.count) for e in
           sorted(kernels, key=dev_us, reverse=True)[:12]]
    own = {}  # the port's hand-written kernels in the step, ms and launches
    for e in kernels:
        for name in OWN_KERNELS:
            if f"{name}<" in e.key:
                ms, n = own.get(name, (0.0, 0))
                own[name] = (ms + dev_us(e) / 1e3, n + e.count)
    del model, params, state, batch, prof
    torch.cuda.empty_cache()

    flops = 6 * n_params * tokens
    share = flops / median_s / PEAK_OPS_PER_S["float32"]
    finite = all(math.isfinite(x) for x in res.losses)
    gn_ok = len(grad_norms) == steps and all(math.isfinite(g) and g > 0 for g in grad_norms)
    ok = res.steps_run == steps and finite and gn_ok and launches == want
    print(f"train (f): train_loop stablelm-3b full width and depth ({cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters), {TRAIN_FULL['batch']} x {TRAIN_FULL['seq']} "
          f"tokens a step in {mb} microbatches, {steps} steps in {run_s:.1f} s (init "
          f"included): losses {res.losses}; grad norms {grad_norms}; step s "
          f"{[round(t, 4) for t in step_s]}; median of steps 2-{steps} {median_s:.4f} s = "
          f"{tokens / median_s:.1f} tokens/s; 6 N tokens / step time {flops / median_s / 1e12:.2f} "
          f"TFLOP/s = {share:.3f} of 67 TFLOP/s fp32; peak memory {peak_gb:.2f} GB; launches "
          f"{launches} (expected {want}) {'ok' if ok else 'FAIL'}; {card}")
    print(f"  one step under the profiler: {idle_line(idle)}")
    for key, ms, count in top:
        print(f"  {ms:9.3f} ms {ms / idle['busy_ms']:6.1%} x{count:<5d} {key[:90]}")
    print("  the port's kernels in the step: " + ", ".join(
        f"{name} {ms:.3f} ms ({ms / idle['busy_ms']:.1%}, x{n})"
        for name, (ms, n) in own.items()))
    out["full"] = dict(params=n_params, losses=res.losses, grad_norms=grad_norms,
                       step_s=step_s, median_step_s=median_s, tokens_per_s=tokens / median_s,
                       flops_share_fp32=share, peak_gb=peak_gb, launches=launches,
                       idle=idle, top_kernels=top, own_kernels=own, run_s=run_s)
    if not ok:
        raise SystemExit(f"train (f) failed: steps {res.steps_run}, finite {finite}, grad "
                         f"norms {grad_norms}, launches {launches} (expected {want})")

    # -- the backward kernels' times at a microbatch's shapes
    B, S, H, KV, hd = TRAIN_ATTN
    sets = []
    for _ in range(4):
        q, k, v = randn((B, S, H, hd), torch.float32), randn((B, S, KV, hd), torch.float32), \
            randn((B, S, KV, hd), torch.float32)
        o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        sets.append((q, k, v, o, lse, randn((B, S, H, hd), torch.float32)))
    t_kernel = cuda_time_ms(torch, lambda *a: flash_attention_bwd_cuda(*a, causal=True),
                            sets, iters=20)
    t_dev, n_dev, parts = device_ms(torch, lambda *a: flash_attention_bwd_cuda(*a, causal=True),
                                    sets)
    by_kernel = ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
    t_plain = cuda_time_ms(torch, lambda *a: ref.flash_attention_bwd_ref(*a, causal=True),
                           sets, iters=5)
    graphs = []
    for q, k, v, _, _, do in sets:
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        graphs.append((F.scaled_dot_product_attention(qs, ks, vs, is_causal=True),
                       (qs, ks, vs), do.transpose(1, 2).contiguous()))
    t_lib = cuda_time_ms(torch, lambda y, xs, dy: torch.autograd.grad(
        y, xs, dy, retain_graph=True), graphs, iters=20)
    del graphs
    pairs = S * (S + 1) // 2
    n_ops = 5 * 2 * B * H * hd * pairs  # S, dP, dV, dK, dQ: 5 products
    n_bytes = 4 * (3 * B * S * H * hd + 2 * B * S * KV * hd + B * H * S  # q, o, dO, k, v, lse
                   + B * S * H * hd + 2 * B * S * KV * hd)               # dq, dk, dv
    (c_ms, c_by), (b_ms, b_by) = bound(n_bytes, n_ops, "float32"), \
        bound(n_bytes, 3 * n_ops, "tf32")
    print(f"time flash_attention_bwd {TRAIN_ATTN} fp32 causal: kernel {t_kernel:.4f} ms "
          f"(device {t_dev:.4f} ms a call over its {n_dev} launches, profiler: {by_kernel}), "
          f"plain {t_plain:.4f} ms, SDPA backward (autograd.grad) {t_lib:.4f} ms, bound 3xTF32 "
          f"tensor cores {b_ms:.4f} ms by {b_by} (the 7 products executed: "
          f"{b_ms * 7 / 5:.4f} ms), bound fp32 CUDA cores {c_ms:.4f} ms by {c_by}")
    rows = [dict(name="flash_attention_bwd", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 replaces="src/repro/kernels/flash_attention.py:123",
                 gradient_of="flash_attention", launches=launches["flash_attention_bwd"],
                 max_abs_err=main_err["flash_attention_bwd"], ms=t_kernel, device_ms=t_dev,
                 plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib)]
    del sets
    # the same shape in bf16: 2 products where fp32 takes 3, 1 where both
    # operands are bf16 (S, dP): 10 products' worth against fp32's 21
    sets = []
    for _ in range(4):
        q, k, v = (randn((B, S, n, hd), torch.bfloat16) for n in (H, KV, KV))
        o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        sets.append((q, k, v, o, lse, randn((B, S, H, hd), torch.bfloat16)))
    t_bf16 = cuda_time_ms(torch, lambda *a: flash_attention_bwd_cuda(*a, causal=True), sets,
                          iters=20)
    t_bf16_dev, _, _ = device_ms(torch, lambda *a: flash_attention_bwd_cuda(*a, causal=True),
                                 sets)
    del sets
    print(f"time flash_attention_bwd {TRAIN_ATTN} bf16 causal: kernel {t_bf16:.4f} ms (device "
          f"{t_bf16_dev:.4f} ms a call)")
    out["bf16_bwd"] = dict(ms=t_bf16, device_ms=t_bf16_dev)
    # off the main path: yi-9b's grouped queries (G = 8), where B * KV * S / 64
    # = 64 dK/dV key blocks would share 132 SMs, each over G * S = 4096
    # folded rows: the kernel splits each one's rows between 5 blocks
    B, S, H, KV, hd = TRAIN_GQA_ATTN
    sets = []
    for _ in range(4):
        q, k, v = randn((B, S, H, hd), torch.float32), randn((B, S, KV, hd), torch.float32), \
            randn((B, S, KV, hd), torch.float32)
        o, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        sets.append((q, k, v, o, lse, randn((B, S, H, hd), torch.float32)))
    t_gqa = cuda_time_ms(torch, lambda *a: flash_attention_bwd_cuda(*a, causal=True), sets,
                         iters=20)
    graphs = []
    for q, k, v, _, _, do in sets:
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        graphs.append((F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                      enable_gqa=True),
                       (qs, ks, vs), do.transpose(1, 2).contiguous()))
    t_gqa_lib = cuda_time_ms(torch, lambda y, xs, dy: torch.autograd.grad(
        y, xs, dy, retain_graph=True), graphs, iters=20)
    del graphs, sets
    print(f"time flash_attention_bwd yi-9b GQA {TRAIN_GQA_ATTN} fp32 causal (off the main "
          f"path): kernel {t_gqa:.4f} ms, SDPA backward (autograd.grad) {t_gqa_lib:.4f} ms")
    out["gqa_bwd"] = dict(shape=TRAIN_GQA_ATTN, ms=t_gqa, library_ms=t_gqa_lib)

    rows_n, d = TRAIN_NORM
    sets = [(randn((rows_n, d), torch.float32), randn((d,), torch.float32),
             randn((rows_n, d), torch.float32)) for _ in range(4)]
    t_kernel = cuda_time_ms(torch, lambda x, s, dy: rmsnorm_bwd_cuda(x, s, dy), sets)
    t_host = host_us(torch, lambda x, s, dy: rmsnorm_bwd_cuda(x, s, dy), sets)
    t_dev, n_dev, parts = device_ms(torch, lambda x, s, dy: rmsnorm_bwd_cuda(x, s, dy), sets,
                                    iters=100)
    by_kernel = ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
    t_plain = cuda_time_ms(torch, lambda x, s, dy: ref.rmsnorm_bwd_ref(x, s, dy), sets)
    graphs = []
    for x, s, dy in sets:
        xs, ss = x.clone().requires_grad_(), s.clone().requires_grad_()
        graphs.append((F.rms_norm(xs, (d,), weight=ss, eps=1e-5), (xs, ss), dy))

    def lib_grad(y, xs, dy):
        return torch.autograd.grad(y, xs, dy, retain_graph=True)

    t_lib = cuda_time_ms(torch, lib_grad, graphs)
    t_lib_host = host_us(torch, lib_grad, graphs)
    t_lib_dev, n_lib_dev, _ = device_ms(torch, lib_grad, graphs, iters=100)
    del graphs
    b_ms, b_by = bound(4 * (3 * rows_n * d + 2 * d), 11 * rows_n * d, "float32")
    print(f"time rmsnorm_bwd {TRAIN_NORM} fp32: kernel {t_kernel:.4f} ms (device "
          f"{t_dev:.4f} ms a call over its {n_dev} launches, profiler: {by_kernel}; host "
          f"{t_host:.1f} us a call), plain {t_plain:.4f} ms, F.rms_norm backward "
          f"(autograd.grad) {t_lib:.4f} ms "
          f"(device {t_lib_dev:.4f} ms over {n_lib_dev} device ops; host {t_lib_host:.1f} us), "
          f"bound {b_ms:.4f} ms by {b_by}")
    rows.append(dict(name="rmsnorm_bwd", route="cuda",
                     source="src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                     replaces="src/repro/kernels/rmsnorm.py:35", gradient_of="rmsnorm",
                     launches=launches["rmsnorm_bwd"], max_abs_err=main_err["rmsnorm_bwd"],
                     ms=t_kernel, device_ms=t_dev, host_us=t_host, plain_ms=t_plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
                     library_device_ms=t_lib_dev))
    del sets
    torch.cuda.empty_cache()

    out["launches"] = launches
    out["rows"] = rows
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train: phase {out['phase_s']:.1f} s")
    return out


def chaos_phase(artifact_id):
    """``adaptive_serve`` on the card under the JAX package's committed fault
    plan (``benchmarks/data/chaos_faults.json``, read only), at the settings
    of ``benchmarks/data/BENCH_resilience_smoke.json``: vecadd, dotprod and
    mvmult, 400 requests, ``host-threads``, window 4, 2 engine workers,
    watchdog 0.25 s, with the autotune phase's artifact.  Gated as that
    benchmark gates it: no crash, and every request terminal; and no
    request may fail for a reason the plan did not inject (an error that
    is not an ``InjectedFault``, or a timeout)."""
    import collections

    from repro_torch.launch.serve import adaptive_serve
    from repro_torch.serving import TelemetryLog

    plan = os.path.join(ROOT, "benchmarks", "data", "chaos_faults.json")
    work = os.path.join(ROOT, "build", "chip_smoke")
    met, tele = os.path.join(work, "chaos_metrics.json"), os.path.join(work, "chaos.jsonl")
    os.makedirs(work, exist_ok=True)
    if os.path.exists(tele):
        os.remove(tele)
    n = 400
    t0 = time.perf_counter()
    crashes, summary, error = 0, {}, None
    try:
        summary = adaptive_serve(("vecadd", "dotprod", "mvmult"), n_requests=n,
                                 backend="host-threads", window=4, workers=2,
                                 watchdog_ms=250.0, fault_plan=plan, model=artifact_id,
                                 model_dir=os.path.join(ROOT, "build", "models"),
                                 telemetry_path=tele, metrics_out=met, verbose=False,
                                 device="cuda")
    except Exception as e:  # noqa: BLE001 — a crash is the gated outcome
        crashes, error = 1, f"{type(e).__name__}: {e}"
    wall = time.perf_counter() - t0
    by_status = summary.get("by_status", {})
    terminal = sum(v for k, v in by_status.items()
                   if k in ("ok", "degraded", "failed", "timeout"))
    injected = sum(v["value"] for v in summary.get("metrics", {}).get(
        "serving.faults.injected", {}).get("values", []))
    errors = collections.Counter(
        (s.error or "").split(":")[0] for s in (TelemetryLog.read(tele) if not crashes else [])
        if s.status in ("failed", "timeout"))
    foreign = sum(v for k, v in errors.items() if k != "InjectedFault")
    out = dict(requests=n, crashes=crashes, terminal_fraction=terminal / n,
               by_status=by_status, faults_injected=injected, failure_errors=dict(errors),
               wall_s=wall)
    print(f"chaos: adaptive_serve under {os.path.relpath(plan, ROOT)}: {n} requests, "
          f"host-threads, window 4, 2 workers, watchdog 0.25 s: statuses {by_status}, "
          f"{injected} faults injected, failures by error {dict(errors)}, crashes {crashes}, "
          f"terminal fraction {terminal / n:.4f}, {wall:.2f} s"
          + (f"; {error}" if error else ""))
    if crashes or terminal != n or foreign:
        raise SystemExit(f"chaos phase failed: {out}")
    return out


def autotune_phase(torch, dev):
    """The paper's loop on the card: every workload against the port on the
    CPU, backend equivalence, the 6-program corpus profiled, leave-one-
    program-out (LOO) evaluation of the MLP trained on the card, and a
    published artifact read back.  Returns the summary it prints."""
    import numpy as np

    from repro_torch.core.modeling import dataset as ds
    from repro_torch.core.modeling.evaluate import evaluate_model, geomean
    from repro_torch.core.modeling.heuristic import OverlapHeuristicModel
    from repro_torch.core.modeling.registry import ModelRegistry
    from repro_torch.core.stream_config import SINGLE_STREAM, StreamConfig
    from repro_torch.core.streams import StreamedRunner
    from repro_torch.core.workloads import get_workload, list_workloads
    from repro_torch.launch.train_model import (DEFAULT_TRAIN_PROGRAMS,
                                                train_and_publish)

    t_phase = time.perf_counter()
    print("autotune: the 39 workloads, card against the port on the CPU")
    n_ok, bad = 0, []
    for name in list_workloads():
        wl = get_workload(name)
        rtol, atol = WL_TOL.get(name, (WL_RTOL, WL_ATOL))
        worst, ok = [], True
        for scale in (wl.datasets[0], wl.datasets[-1]):
            chunked, shared = wl.make_data(scale, np.random.default_rng(0))
            got, want = (
                StreamedRunner(wl, chunked, shared, device=d)
                .dispatch(SINGLE_STREAM)[0].cpu().numpy() for d in (dev, "cpu"))
            err = np.abs(got - want)
            ok &= bool(got.dtype == want.dtype == np.float32
                       and got.shape == want.shape and np.isfinite(got).all()
                       and (err <= atol + rtol * np.abs(want)).all())
            worst.append(f"@{scale} abs {err.max():.2e} over max |x| "
                         f"{np.abs(want).max():.1e}, worst err/tol "
                         f"{(err / (atol + rtol * np.abs(want))).max():.3f}")
        n_ok += ok
        if not ok:
            bad.append(name)
        print(f"  {name:13s} {'; '.join(worst)}  rtol {rtol:g} atol {atol:g} "
              f"{'ok' if ok else 'FAIL'}")
    if bad:
        raise SystemExit(f"workloads whose card and CPU results differ: {bad}")

    print("autotune: backend equivalence on the card, largest scale")
    configs = [SINGLE_STREAM, StreamConfig(1, 4), StreamConfig(2, 2),
               StreamConfig(4, 8), StreamConfig(32, 64)]
    for name in ("vecadd", "sgemm", "mvmult"):
        wl = get_workload(name)
        chunked, shared = wl.make_data(wl.datasets[-1], np.random.default_rng(0))
        ref = torch.cat(StreamedRunner(wl, chunked, shared, device=dev)
                        .dispatch(SINGLE_STREAM)).cpu().numpy()
        for backend in ("host-sync", "host-pipelined"):
            runner = StreamedRunner(wl, chunked, shared, device=dev,
                                    backend=backend)
            for c in configs:
                outs = runner.dispatch(c)
                got = torch.cat(outs).cpu().numpy()
                err = np.abs(got - ref).max()
                if (len(outs) != c.partitions * c.tasks
                        or not np.allclose(got, ref, rtol=WL_RTOL, atol=WL_ATOL)):
                    raise SystemExit(f"{backend} {name} {c.as_tuple()}: "
                                     f"max abs err {err:.3e} against host-sync 1x1")
            print(f"  {name}@{wl.datasets[-1]} {backend:14s} "
                  f"{[c.as_tuple() for c in configs]} ok (max abs err {err:.2e} "
                  f"at (32, 64))")

    # D2H of every slice is inside every timed run: its cost at (32, 64)
    wl = get_workload("vecadd")
    chunked, shared = wl.make_data(wl.datasets[-1], np.random.default_rng(0))
    runner = StreamedRunner(wl, chunked, shared, device=dev)
    wide = StreamConfig(32, 64)
    runner.warmup(wide)
    no_d2h = []
    for _ in range(5):
        t0 = time.perf_counter()
        runner.issue(wide)
        runner.ctx.wait()
        no_d2h.append(time.perf_counter() - t0)
    with_d2h = runner.run(wide, reps=5, warmed=True)
    d2h_us = (with_d2h - min(no_d2h)) / (wide.partitions * wide.tasks) * 1e6
    print(f"autotune: vecadd@{wl.datasets[-1]} at (32, 64): {with_d2h * 1e3:.3f} ms "
          f"with the 2048 D2H copies, {min(no_d2h) * 1e3:.3f} ms without: "
          f"{d2h_us:.2f} us per slice")

    binomial = get_workload("binomial")
    b_runner = StreamedRunner(binomial, *binomial.make_data(
        binomial.datasets[-1], np.random.default_rng(0)), device=dev)
    b_runner.warmup(SINGLE_STREAM)
    for i, (label, r, c) in enumerate((
            (f"vecadd@{wl.datasets[-1]}", runner, SINGLE_STREAM),
            (f"vecadd@{wl.datasets[-1]}", runner, wide),
            (f"binomial@{binomial.datasets[-1]}", b_runner, SINGLE_STREAM))):
        _, idle, _ = device_idle(torch, lambda: r.run(c, reps=1, warmed=True),
                                 os.path.join(ROOT, "build", "chip_smoke", f"profile_runner_{i}.json"))
        print(f"autotune: profile {label} {c.as_tuple()}: {idle_line(idle)}")

    print("autotune: train_model on the card (profile, LOO, train, publish)")
    cache = CORPUS_CACHE
    if os.path.exists(cache):
        os.remove(cache)

    class Recording(ModelRegistry):
        def publish(self, model, **kw):
            self.model = model
            return super().publish(model, **kw)

    registry = Recording(os.path.join(ROOT, "build", "models"))
    summary = train_and_publish(DEFAULT_TRAIN_PROGRAMS, datasets_per_program=2,
                                reps=2, epochs=600, cache_path=cache,
                                registry=registry, device=dev)
    cv = summary["cv"]
    samples = ds.generate(DEFAULT_TRAIN_PROGRAMS, datasets_per_program=2,
                          cache_path=cache, verbose=False, device=dev)
    if len(samples) != 12 or summary["n_samples"] != 12:
        raise SystemExit(f"corpus has {len(samples)} cells, expected 12")
    cells = []
    print("  cell               t_single ms  best     oracle  sync@best ms  "
          "pipelined@best ms")
    for s in samples:
        wl = get_workload(s.program)
        chunked, shared = wl.make_data(s.scale, np.random.default_rng(s.scale))
        best = s.best_config
        t_pipe = StreamedRunner(wl, chunked, shared, device=dev,
                                backend="host-pipelined").run(best, reps=2)
        cells.append(dict(cell=f"{s.program}@{s.scale}", t_single_ms=s.t_single * 1e3,
                          best=list(best.as_tuple()), oracle=s.oracle_speedup,
                          sync_best_ms=s.times[best.as_tuple()] * 1e3,
                          pipelined_best_ms=t_pipe * 1e3))
        print(f"  {cells[-1]['cell']:18s} {s.t_single * 1e3:11.4f}  "
              f"{str(best.as_tuple()):8s} {s.oracle_speedup:6.3f}  "
              f"{cells[-1]['sync_best_ms']:12.4f}  {t_pipe * 1e3:17.4f}")
    oracle = geomean(s.oracle_speedup for s in samples)
    heur = evaluate_model(OverlapHeuristicModel(), samples)
    vs_heur = cv["mean_achieved"] / heur["mean_speedup"]
    print(f"autotune: geomean oracle speedup over single stream {oracle:.4f} over "
          f"12 cells; profiling {summary['profile_s']:.1f} s")
    print(f"autotune: LOO with the MLP on the card: frac_of_oracle "
          f"{cv['frac_of_oracle']:.4f}, mean_achieved {cv['mean_achieved']:.4f}, "
          f"mean_oracle {cv['mean_oracle']:.4f}; heuristic {heur['mean_speedup']:.4f} "
          f"(frac {heur['frac_of_oracle']:.4f}), vs_heuristic {vs_heur:.4f}; "
          f"LOO {summary['cv_s']:.1f} s, train {summary['train_s']:.1f} s")
    for prog, r in sorted(cv["per_program"].items()):
        print(f"  loo {prog:13s} achieved {r['achieved']:.4f} oracle "
              f"{r['oracle']:.4f} frac {r['frac_of_oracle']:.4f}")

    loaded, manifest = ModelRegistry(registry.root).load(summary["artifact_id"])
    X, _ = ds.training_matrix(samples)
    same = np.array_equal(loaded.to(dev).predict(X), registry.model.predict(X))
    print(f"autotune: published {summary['artifact_id']} to {registry.root}; "
          f"reloaded predictions identical: {same}")
    if not same or manifest["cv"] != cv:
        raise SystemExit("the published artifact does not reload as trained")
    phase_s = time.perf_counter() - t_phase
    print(f"autotune: phase {phase_s:.1f} s")
    return dict(workloads_ok=n_ok, scales=2, backends_equivalent=True,
                d2h_us_per_slice=d2h_us, cells=cells, geomean_oracle=oracle,
                profile_s=summary["profile_s"],
                loo=dict(frac_of_oracle=cv["frac_of_oracle"],
                         mean_achieved=cv["mean_achieved"],
                         mean_oracle=cv["mean_oracle"], s=summary["cv_s"]),
                heuristic_mean=heur["mean_speedup"], vs_heuristic=vs_heur,
                artifact_id=summary["artifact_id"], phase_s=phase_s)


def serving_phase(torch, dev, artifact_id):
    """Adaptive serving on ``dev``: bootstrap from an empty registry, the
    checked serial runs at every program's largest registered dataset,
    the window-4 runs, the poison drill and the ``adaptive_serve`` entry
    point.  Returns the summary it prints; every failed check raises."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core.autotuner import TuningCache
    from repro_torch.core.backends import base as backend_base
    from repro_torch.core.modeling.search import search_best
    from repro_torch.core.stream_config import SINGLE_STREAM
    from repro_torch.core.streams import StreamedRunner, probe_host_capacity
    from repro_torch.core.workloads import get_workload
    from repro_torch.launch.serve import resolve_serving_model
    from repro_torch.launch.train_model import DEFAULT_TRAIN_PROGRAMS
    from repro_torch.serving import (AdaptiveScheduler, ConcurrentScheduler,
                                     DriftDetector, Tracer,
                                     aggregate_stage_times, latency_stats,
                                     make_trace)

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke", "serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}

    # -- bootstrap: "latest" in an empty registry trains and publishes one
    empty = tempfile.mkdtemp(dir=work)
    prev = os.environ.get("REPRO_TORCH_PROFILE_CACHE")
    os.environ["REPRO_TORCH_PROFILE_CACHE"] = os.path.join(empty, "profile.json")
    try:
        t0 = time.perf_counter()
        boot, boot_info = resolve_serving_model(
            "latest", os.path.join(empty, "models"), device=dev, verbose=False)
        bootstrap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, again = resolve_serving_model(
            "latest", os.path.join(empty, "models"), device=dev, verbose=False)
        reload_s = time.perf_counter() - t0
    finally:
        if prev is None:
            del os.environ["REPRO_TORCH_PROFILE_CACHE"]
        else:
            os.environ["REPRO_TORCH_PROFILE_CACHE"] = prev
    if (again["artifact_id"] != boot_info["artifact_id"] or boot_info["kind"] != "mlp"
            or boot.device.type != torch.device(dev).type):
        raise SystemExit(f"bootstrap failed: {boot_info}, reloaded {again}")
    print(f"serving: bootstrap from an empty registry published "
          f"{boot_info['artifact_id']} (LOO frac_of_oracle "
          f"{boot_info['cv_frac_of_oracle']:.4f}) in {bootstrap_s:.1f} s; "
          f"reloaded in {reload_s:.3f} s")
    out["bootstrap_s"] = bootstrap_s

    # -- the served model and trace: 6 programs x 4 occurrences, 4 tenants
    model, info = resolve_serving_model(artifact_id, os.path.join(ROOT, "build", "models"),
                                        device=dev, verbose=False)
    programs = DEFAULT_TRAIN_PROGRAMS
    scale_index = max(len(get_workload(p).datasets) for p in programs) - 1
    trace = make_trace(programs, occurrences=4, scale_index=scale_index, tenants=4, seed=0)
    mb = sum(a.nbytes for r in trace for d in (r.chunked, r.shared) for a in d.values()) / 1e6
    print(f"serving: {len(trace)} requests, "
          f"{sorted({f'{r.workload}@{next(iter(r.chunked.values())).shape[0]}' for r in trace})}, "
          f"{mb:.1f} MB of inputs, model {info['artifact_id']}")
    for r in trace:
        if get_workload(r.workload).combine != "concat":
            raise SystemExit(f"{r.workload} does not concatenate its slices")

    def fresh():
        return [dataclasses.replace(r, seq=-1, arrival_s=None, trace_id=None) for r in trace]

    def cat(outs):
        return torch.cat([o.reshape(o.shape[0], -1) for o in outs]).cpu().numpy()

    t0 = time.perf_counter()
    refs = [cat(StreamedRunner(get_workload(r.workload), r.chunked, r.shared, device="cpu")
                .dispatch(SINGLE_STREAM)) for r in trace]
    print(f"serving: CPU references in {time.perf_counter() - t0:.1f} s")
    n_buckets = len({(r.workload, r.tenant) for r in trace})

    # pinning instrumentation: seconds and bytes spent page-locking inputs
    pinned = {"s": 0.0, "bytes": 0}
    orig_host_tensors = backend_base._host_tensors

    def timed_host_tensors(arrs, device):
        t0 = time.perf_counter()
        got = orig_host_tensors(arrs, device)
        pinned["s"] += time.perf_counter() - t0
        pinned["bytes"] += sum(a.nbytes for a in arrs.values())
        return got

    def check(label, results, sched, *, cold):
        """Outputs against the CPU, decision order, cache hits."""
        # the queue numbers requests on, over a scheduler's passes
        first = results[0].request.seq if results else 0
        if [r.request.seq - first for r in results] != list(range(len(trace))):
            raise SystemExit(f"{label}: results not in decision order")
        worst = 0.0
        for i, r in enumerate(results):
            if r.status != "served":
                raise SystemExit(f"{label}: request {i} {r.status}: {r.error}")
            rtol, atol = WL_TOL.get(r.request.workload, (WL_RTOL, WL_ATOL))
            got, want = cat(r.outputs), refs[i]
            tol = atol + rtol * np.abs(want)
            if (len(r.outputs) != r.config.partitions * r.config.tasks
                    or got.shape != want.shape or not np.isfinite(got).all()
                    or not (np.abs(got - want) <= tol).all()):
                raise SystemExit(f"{label}: request {i} ({r.request.workload}) "
                                 f"differs from the CPU: max abs err "
                                 f"{np.abs(got - want).max():.3e}")
            worst = max(worst, float((np.abs(got - want) / tol).max()))
        seen, want_hits = set(), []
        for r in results:
            want_hits.append(r.sample.key in seen if cold else True)
            seen.add(r.sample.key)
        if [r.cache_hit for r in results] != want_hits or len(seen) != n_buckets:
            raise SystemExit(f"{label}: cache hits {[r.cache_hit for r in results]}, "
                             f"expected {want_hits} over {n_buckets} buckets")
        # buckets ranked by the model: one search each on the serial
        # scheduler; the engine ranks a window's cold buckets in one
        # batched search
        st = sched.stats
        searched = (st["model_searches"] - st["batched_searches"]
                    + st["batched_search_programs"])
        if searched != (n_buckets if cold else 0) or (
                cold and isinstance(sched, AdaptiveScheduler)
                and not isinstance(sched, ConcurrentScheduler)
                and st["model_searches"] != n_buckets):
            raise SystemExit(f"{label}: {dict(st)} for {n_buckets} buckets")
        return worst

    def report(label, sched, results, wall, spans, pin):
        lat = latency_stats([r.sample.latency_s for r in results])
        stages = aggregate_stage_times(spans)
        hits = sum(r.cache_hit for r in results)
        configs = {}
        for r in results:
            configs.setdefault(f"{r.request.workload}/{r.request.tenant}",
                               "x".join(map(str, r.config.as_tuple())))
        row = dict(requests=len(results), wall_s=wall, rps=len(results) / wall,
                   p50_ms=lat["p50_s"] * 1e3, p99_ms=lat["p99_s"] * 1e3,
                   stage_s={s: v["wall_s"] for s, v in stages.items()},
                   hit_rate=hits / len(results),
                   model_searches=sched.stats["model_searches"],
                   refinements=sched.stats["refinements"],
                   pin_s=pin[0], pin_mb=pin[1] / 1e6,
                   pin_ms_per_mb=pin[0] * 1e3 / max(pin[1] / 1e6, 1e-9),
                   configs=configs)
        print(f"serving: {label}: {row['requests']} requests in {wall:.3f} s = "
              f"{row['rps']:.1f} requests/s; latency p50 {row['p50_ms']:.2f} ms, p99 "
              f"{row['p99_ms']:.2f} ms; stages " + ", ".join(
                  f"{s} {v:.3f} s" for s, v in row["stage_s"].items())
              + f"; hit rate {row['hit_rate']:.3f}, model searches "
              f"{row['model_searches']}, refinements {row['refinements']}; pinning "
              f"{pin[0]:.3f} s for {row['pin_mb']:.1f} MB ({row['pin_ms_per_mb']:.4f} ms/MB, "
              f"{pin[0] / max(row['stage_s']['decide'], 1e-12):.1%} of decide)")
        print(f"  configs {configs}")
        return row

    def scheduler(backend, window, cache, drift):
        common = dict(device=dev, backend=backend, cache=cache, drift=drift,
                      isolate_tenants=True, model_tag=info["artifact_id"],
                      keep_outputs=True, tracer=Tracer())
        if window > 1:
            return ConcurrentScheduler(model, window=window, workers=window, **common)
        return AdaptiveScheduler(model, **common)

    def serve_pass(sched, profile_to=None):
        n_spans = len(sched.tracer.spans)
        pin0 = (pinned["s"], pinned["bytes"])
        sched.submit_all(fresh())
        if profile_to is None:
            t0 = time.perf_counter()
            results = sched.run()
            wall = time.perf_counter() - t0
            idle = None
        else:
            results, idle, _ = device_idle(torch, sched.run, profile_to)
            wall = idle["wall_ms"] / 1e3
        pin = (pinned["s"] - pin0[0], pinned["bytes"] - pin0[1])
        return results, wall, sched.tracer.spans[n_spans:], pin, idle

    backend_base._host_tensors = timed_host_tensors
    try:
        # serial, cold: the checked runs
        caches = {}
        for backend in ("host-sync", "host-pipelined"):
            label = f"serial {backend}, cold"
            caches[backend] = os.path.join(work, f"cache_{backend}.json")
            with scheduler(backend, 1, TuningCache(caches[backend]),
                           DriftDetector(threshold=4.0)) as sched:
                results, wall, spans, pin, _ = serve_pass(sched)
                worst = check(label, results, sched, cold=True)
                out[label] = report(label, sched, results, wall, spans, pin)
                out[label]["worst_err_over_tol"] = worst
                sched.cache.save()
                if backend == "host-sync":
                    cold_configs = {r.sample.key: sched.cache.peek(r.sample.key).config.as_tuple()
                                    for r in results}

        # warm from the serial cache, drift off so no entry moves: window 1
        # against window 4 on host-sync; pass 1 measures the persisted
        # entries' anchors, pass 2 is timed, pass 3 runs under the profiler
        warm = {}
        for window in (1, 4):
            label = f"window {window} host-sync, warm"
            with scheduler("host-sync", window, TuningCache(caches["host-sync"]),
                           DriftDetector(threshold=float("inf"))) as sched:
                first, *_ = serve_pass(sched)
                check(label + " pass 1", first, sched, cold=False)
                results, wall, spans, pin, _ = serve_pass(sched)
                check(label, results, sched, cold=False)
                got = [r.config.as_tuple() for r in results]
                if got != [cold_configs[r.sample.key] for r in results]:
                    raise SystemExit(f"{label}: configs {got} differ from the serial run's")
                out[label] = report(label, sched, results, wall, spans, pin)
                warm[window] = out[label]
                profiled, _, _, _, idle = serve_pass(
                    sched, os.path.join(work, f"profile_w{window}.json"))
                check(label + " profiled", profiled, sched, cold=False)
                out[label]["device_idle"] = idle
                print(f"  under the profiler: {idle_line(idle)}")
                if window > 1:
                    out["parallel_capacity_4"] = sched.parallel_capacity
                    out["ctx_reuses"] = sched.stats["ctx_reuses"]
        # the engine floors the probe at 1.0; the probe's own reading too
        out["probe_4_raw"] = probe_host_capacity(4, device=dev)
        print(f"serving: window 4 over window 1 (warm, host-sync): "
              f"{warm[4]['rps'] / warm[1]['rps']:.3f}x requests/s; parallel_capacity "
              f"for 4 workers {out['parallel_capacity_4']:.3f} (probe "
              f"{out['probe_4_raw']:.3f} before the engine's floor of 1)")

        # window 4 on host-threads, cold: the batched cold search on a
        # quiesced pool; each pick is the serial search on the same features
        label = "window 4 host-threads, cold"
        with scheduler("host-threads", 4, TuningCache(),
                       DriftDetector(threshold=float("inf"))) as sched:
            results, wall, spans, pin, _ = serve_pass(sched)
            check(label, results, sched, cold=True)
            same_as_serial = 0
            for r in results:
                if r.cache_hit:
                    continue
                n_rows = next(iter(r.request.chunked.values())).shape[0]
                cands = sched._feasible_configs(n_rows)
                # the serial search on the same features, up to the fp32
                # rounding of a batched against a one-program forward pass
                want, preds, _ = search_best(model, sched._feats[r.sample.key], cands)
                got = preds[cands.index(r.config)]
                if got < preds.max() - 1e-5 * abs(preds.max()):
                    raise SystemExit(f"{label}: {r.sample.key} got {r.config} "
                                     f"(predicted {got:.6f}), the serial search on its "
                                     f"features picks {want} ({preds.max():.6f})")
                host_sync_key = r.sample.key.replace("|host-threads|", "|host-sync|")
                same_as_serial += r.config.as_tuple() == cold_configs[host_sync_key]
            out[label] = report(label, sched, results, wall, spans, pin)
            out[label]["picks_equal_serial_host_sync"] = same_as_serial
            print(f"  cold picks equal to the serial host-sync run's: "
                  f"{same_as_serial} of {n_buckets}")
    finally:
        backend_base._host_tensors = orig_host_tensors

    out["host_copies"] = host_copy_scaling(torch, dev, trace)
    out["poison_drill"] = poison_drill(torch, dev)
    out["cli"] = cli_run(dev, artifact_id, work)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serving: phase {out['phase_s']:.1f} s")
    return out


def baselines_phase(dev, autotune):
    """The paper's baselines on the autotune phase's 12-cell card corpus,
    read back from its profile cache (nothing is profiled again): Liu et
    al. and Werkhoven et al. from each cell's measured features (paper
    §5.2, Fig. 12), and the k-NN classifier (k=3) under leave-one-program-
    out (§6.4, Fig. 14).  A pick off the profiled grid is scored at its
    nearest profiled config (``achieved_speedup``).  The MLP's LOO and the
    heuristic come from the autotune phase.  Every pick must be a valid
    ``StreamConfig``; nothing is gated on quality."""
    import numpy as np

    from repro_torch.core.analytical import (liu_config, probe_from_features,
                                             werkhoven_config)
    from repro_torch.core.features import RAW_FEATURE_NAMES
    from repro_torch.core.modeling import KNNClassifier
    from repro_torch.core.modeling import dataset as ds
    from repro_torch.core.modeling.evaluate import achieved_speedup, geomean
    from repro_torch.core.stream_config import StreamConfig
    from repro_torch.launch.train_model import DEFAULT_TRAIN_PROGRAMS

    samples = ds.generate(DEFAULT_TRAIN_PROGRAMS, datasets_per_program=2,
                          cache_path=CORPUS_CACHE, verbose=False, device=dev)
    if len(samples) != 12:
        raise SystemExit(f"baselines: corpus has {len(samples)} cells, expected 12")
    oracle = geomean(s.oracle_speedup for s in samples)
    picks = {"liu": [], "werkhoven": [], "knn_loo": []}
    for s in samples:
        probe = probe_from_features(dict(zip(RAW_FEATURE_NAMES, s.features)))
        picks["liu"].append((s, liu_config(probe)))
        picks["werkhoven"].append((s, werkhoven_config(probe)))
    for prog in sorted({s.program for s in samples}):
        train, test = ds.loo_split(samples, prog)
        clf = KNNClassifier.train(np.stack([s.features for s in train]),
                                  [s.best_config for s in train], k=3)
        picks["knn_loo"] += [(s, clf.predict(s.features)) for s in test]
    out = {"oracle": oracle}
    print(f"baselines: 12 cells, geomean oracle {oracle:.4f}")
    for name, pairs in picks.items():
        for s, c in pairs:
            if not (isinstance(c, StreamConfig) and isinstance(c.partitions, int)
                    and isinstance(c.tasks, int) and c.partitions >= 1 and c.tasks >= 1):
                raise SystemExit(f"baselines: {name} picked {c!r} for {s.program}@{s.scale}")
        ach = geomean(achieved_speedup(s, c) for s, c in pairs)
        off_grid = sum(c.as_tuple() not in s.times for s, c in pairs)
        out[name] = dict(geomean_achieved=ach, frac_of_oracle=ach / oracle,
                         off_grid=off_grid,
                         picks={f"{s.program}@{s.scale}": list(c.as_tuple())
                                for s, c in pairs})
        print(f"  {name:10s} geomean achieved {ach:.4f}, frac_of_oracle "
              f"{ach / oracle:.4f}; {off_grid} of 12 picks off the profiled grid; "
              f"picks {out[name]['picks']}")
    loo = autotune["loo"]
    heur = autotune["heuristic_mean"]
    out["mlp_loo"] = dict(geomean_achieved=loo["mean_achieved"],
                          frac_of_oracle=loo["frac_of_oracle"])
    out["heuristic"] = dict(geomean_achieved=heur, frac_of_oracle=heur / oracle)
    print(f"  {'mlp_loo':10s} geomean achieved {loo['mean_achieved']:.4f}, "
          f"frac_of_oracle {loo['frac_of_oracle']:.4f} (autotune phase)")
    print(f"  {'heuristic':10s} geomean achieved {heur:.4f}, frac_of_oracle "
          f"{heur / oracle:.4f} (autotune phase)")
    return out


REAL_TRACE_PROGRAMS = ("vecadd", "dotprod", "mvmult")


def real_trace_phase(torch, dev, artifact_id):
    """The JAX package's real-trace configuration (``benchmarks/run.py``
    ``serve_real_trace``) on the card: 2,000 requests of
    ``generate_trace`` (seed 0, Poisson, the three programs at dataset
    index 4, no churn, no SLOs), arrival stamps cleared so the engine
    stamps them at submit, served by the ``ConcurrentScheduler`` at window
    4 (4 workers) on ``host-sync`` with the autotune phase's artifact and
    drift off.  The first request of every bucket keeps its outputs and is
    held against the CPU within its workload tolerance."""
    import numpy as np

    from repro_torch.core.stream_config import SINGLE_STREAM
    from repro_torch.core.streams import StreamedRunner
    from repro_torch.core.workloads import get_workload
    from repro_torch.launch.serve import resolve_serving_model
    from repro_torch.serving import (ConcurrentScheduler, DriftDetector,
                                     HotPathProfiler, MetricsRegistry,
                                     TelemetryLog, Tracer)
    from repro_torch.serving.traces import TraceConfig, generate_trace

    t_phase = time.perf_counter()
    model, info = resolve_serving_model(artifact_id, os.path.join(ROOT, "build", "models"),
                                        device=dev, verbose=False)
    cfg = TraceConfig(n_requests=2000, seed=0, arrival="poisson",
                      workloads=REAL_TRACE_PROGRAMS, scale_indices=(4,),
                      churn_prob=0.0, slo_choices=None)
    t0 = time.perf_counter()
    reqs = list(generate_trace(cfg))
    for r in reqs:
        r.arrival_s = None
    gen_s = time.perf_counter() - t0
    cells = sorted({f"{r.workload}@{next(iter(r.chunked.values())).shape[0]}" for r in reqs})
    mb = sum(a.nbytes for r in reqs for d in (r.chunked, r.shared) for a in d.values()) / 1e6
    print(f"real trace: {len(reqs)} requests over {cells}, {mb:.1f} MB of inputs "
          f"in all, generated in {gen_s:.2f} s; model {info['artifact_id']}")

    kept = {}

    class FirstOfBucket(ConcurrentScheduler):
        """Keeps the outputs of each bucket's first retired request."""

        def _retire(self, pending, outs, measured_s):
            if pending.key not in kept:
                kept[pending.key] = (pending.req, list(outs))
            return super()._retire(pending, outs, measured_s)

    tracer, metrics = Tracer(), MetricsRegistry()
    with FirstOfBucket(model, window=4, workers=4, device=dev, backend="host-sync",
                       drift=DriftDetector(threshold=1e9), telemetry=TelemetryLog(),
                       model_tag=info["artifact_id"], keep_outputs=False,
                       tracer=tracer, metrics=metrics) as sched:
        sched.submit_all(reqs)
        prof = HotPathProfiler(tracer)
        with prof:
            results = sched.run()
        report = prof.report()
        summary = sched.telemetry.summary()
        stats = dict(sched.stats)
    torch.cuda.synchronize()
    bad = [r.status for r in results if r.status not in ("served", "degraded")]
    if len(results) != len(reqs) or bad:
        raise SystemExit(f"real trace: {len(results)} results, not served: {bad[:5]}")
    if len(kept) != len(REAL_TRACE_PROGRAMS):
        raise SystemExit(f"real trace: {len(kept)} buckets, expected {len(REAL_TRACE_PROGRAMS)}")
    checked = {}
    for key, (req, outs) in sorted(kept.items()):
        wl = get_workload(req.workload)
        want = torch.cat(StreamedRunner(wl, req.chunked, req.shared, device="cpu")
                         .dispatch(SINGLE_STREAM)).numpy()
        got = torch.cat([o.cpu() for o in outs]).numpy()
        rtol, atol = WL_TOL.get(req.workload, (WL_RTOL, WL_ATOL))
        tol = atol + rtol * np.abs(want)
        if got.shape != want.shape or not (np.abs(got - want) <= tol).all():
            raise SystemExit(f"real trace: first {req.workload} request differs from the "
                             f"CPU: max abs err {np.abs(got - want).max():.3e}")
        checked[req.workload] = float((np.abs(got - want) / tol).max())
    wall = report["wall_s"]
    stages = report["stages"]
    coord_s = stages["decide"]["wall_s"] + stages["retire"]["wall_s"]
    lat = summary["latency"]
    configs = {}
    for r in results:
        configs.setdefault(r.request.workload, "x".join(map(str, r.config.as_tuple())))
    out = dict(requests=len(results), wall_s=wall, rps=len(results) / wall,
               p50_ms=lat["p50_s"] * 1e3, p99_ms=lat["p99_s"] * 1e3,
               hit_rate=summary["hit_rate"], cold_misses=stats.get("cold_misses", 0),
               stage_s={k: v["wall_s"] for k, v in stages.items()},
               kernel_exec_s=sum(r.measured_s for r in results),
               decide_retire_share=coord_s / wall, configs=configs,
               first_of_bucket_err_over_tol=checked)
    print(f"real trace: window 4 host-sync: {len(results)} requests in {wall:.3f} s = "
          f"{out['rps']:.1f} requests/s; latency p50 {out['p50_ms']:.2f} ms, p99 "
          f"{out['p99_ms']:.2f} ms; hit rate {out['hit_rate']:.4f}, cold misses "
          f"{out['cold_misses']}; stages " + ", ".join(
              f"{k} {v:.3f} s" for k, v in out["stage_s"].items())
          + f"; measured {out['kernel_exec_s']:.3f} s; decide+retire {coord_s:.3f} s = "
          f"{out['decide_retire_share']:.4f} of the wall; configs {configs}")
    print(f"real trace: first request of each bucket against the CPU, worst err/tol "
          f"{checked} ok")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"real trace: phase {out['phase_s']:.1f} s")
    return out


FLEET_PROGRAMS = ("vecadd", "dotprod", "mvmult")
# where each checked fleet worker writes its output checks (one file per pid)
FLEET_CHECKS = os.path.join(ROOT, "build", "chip_smoke", "fleet", "checks")
# the long warm windows, each in a router of its own: 50 copies of the 24
# requests (every bucket warm), 6 requests in every task message at every N,
# 2 windows a router
FLEET_LONG_COPIES, FLEET_LONG_CHUNK, FLEET_LONG_WINDOWS = 50, 6, 2


def checked_worker_main(cfg, task_q, conn):
    """The fleet's ``worker_main`` with a scheduler that keeps the outputs of
    the first request of each (workload, tenant) it serves.  When the worker
    stops, it holds them against the port on the CPU within the workload
    tolerance and writes the err/tol of each to ``FLEET_CHECKS/<pid>.json``;
    only numbers cross back, as the fleet's wire carries no outputs.  A
    spawned worker finds this function in the script it re-imports."""
    import numpy as np
    import torch

    import repro_torch.serving as serving
    from repro_torch.core.stream_config import SINGLE_STREAM
    from repro_torch.core.streams import StreamedRunner
    from repro_torch.core.workloads import get_workload
    from repro_torch.serving.fleet.worker import worker_main

    kept = {}

    class FirstOfBucket(serving.ConcurrentScheduler):
        def _retire(self, pending, outs, measured_s):
            kept.setdefault((pending.req.workload, pending.req.tenant),
                            (pending.req, list(outs)))
            return super()._retire(pending, outs, measured_s)

    serving.ConcurrentScheduler = FirstOfBucket     # _build_scheduler's class
    try:
        worker_main(cfg, task_q, conn)
    finally:
        if cfg.device.startswith("cuda"):
            torch.cuda.synchronize()
        checks = {}
        for (workload, tenant), (req, outs) in sorted(kept.items()):
            want = torch.cat(StreamedRunner(get_workload(workload), req.chunked, req.shared,
                                            device="cpu").dispatch(SINGLE_STREAM)).numpy()
            got = torch.cat([o.cpu() for o in outs]).numpy()
            rtol, atol = WL_TOL.get(workload, (WL_RTOL, WL_ATOL))
            checks[f"{workload}/{tenant}"] = (
                float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())
                if got.shape == want.shape else float("inf"))
        os.makedirs(FLEET_CHECKS, exist_ok=True)
        with open(os.path.join(FLEET_CHECKS, f"{os.getpid()}.json"), "w") as f:
            json.dump({"worker": cfg.label, "threads": torch.get_num_threads(),
                       "checks": checks}, f)


def pipe_probe():
    """Seconds to move one message of 2, 12 and 46 MB (one request, a
    6-request and a 24-request task message of the fleet) through a
    ``multiprocessing`` pipe, sent by ``send_bytes`` from a thread: received
    by ``recv_bytes``, as a worker's task queue does, and by ``os.readv``
    into one buffer allocated up front.  Best of 3, within one process."""
    import struct
    import threading
    from multiprocessing import Pipe

    out = {}
    for mb in (2, 12, 46):
        payload = bytes(mb * 10**6)
        row = {}
        for how in ("recv_bytes", "readv"):
            best = float("inf")
            for _ in range(3):
                r, w = Pipe(duplex=False)
                sender = threading.Thread(target=w.send_bytes, args=(payload,))
                t0 = time.perf_counter()
                sender.start()
                if how == "recv_bytes":
                    got = len(r.recv_bytes())
                else:
                    fd, head = r.fileno(), b""
                    while len(head) < 4:
                        head += os.read(fd, 4 - len(head))
                    view = memoryview(bytearray(struct.unpack("!i", head)[0]))
                    got = 0
                    while got < len(view):
                        got += os.readv(fd, [view[got:]])
                best = min(best, time.perf_counter() - t0)
                sender.join()
                r.close()
                w.close()
                if got != len(payload):
                    raise SystemExit(f"pipe probe: {got} bytes of {len(payload)}")
            row[how] = best
        out[f"{mb}MB"] = row
    return out


def fleet_phase(torch, artifact_id):
    """``BENCH_fleet.json``'s configuration on the card, through the fleet
    router: the three programs at dataset index 4, 24 requests over 8
    tenants, window 2 per worker on ``host-sync``, the autotune phase's
    artifact pinned by id; at 1, 2 and 4 worker processes, each its own
    CUDA context, 3 reps in one router (rep 1 cold, reps 2-3 warm), and
    the SIGKILL drill at 2 workers.  Then, in routers of their own with
    drift off, two long warm windows at 1, 2 and 4 workers with the
    router's default intra-op threads, and at 4 workers with every core
    each; and ``fleet_serve`` at 2
    workers with its telemetry and metrics files rendered by the stats
    CLI.  Every request
    must be served by the worker its tenant hashes to; the first request
    of every (workload, tenant) bucket, as its worker served it, must
    agree with the CPU within its workload tolerance; the drill must show
    one death, one respawn and requeued work, and no worker process may
    be left."""
    import dataclasses
    import glob
    import multiprocessing
    import pickle
    import shutil
    from multiprocessing.reduction import ForkingPickler
    from unittest import mock

    import repro_torch.serving.fleet.router as router_mod
    from repro_torch.launch.serve import fleet_serve
    from repro_torch.launch.stats import read_telemetry, render
    from repro_torch.serving import (FleetRouter, WorkerConfig, latency_stats,
                                     make_trace, shard_for)

    t_phase = time.perf_counter()
    n_requests, tenants, reps = 24, 8, 3
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    mps = subprocess.run(["pgrep", "-f", "nvidia-cuda-mps"], capture_output=True,
                         text=True).stdout.split()
    print(f"fleet: compute mode {mode!r}; MPS control daemon "
          f"{'running (pids ' + ' '.join(mps) + ')' if mps else 'not running'}: "
          f"the workers' contexts time-slice the SMs")
    cfg = WorkerConfig(window=2, backend="host-sync", model=artifact_id,
                       model_dir=os.path.join(ROOT, "build", "models"), device="cuda")

    def trace():
        return make_trace(list(FLEET_PROGRAMS), occurrences=-(-n_requests // 3),
                          tenants=tenants, scale_index=4)[:n_requests]

    def gate(label, results, n, expected=n_requests):
        if len(results) != expected:
            raise SystemExit(f"fleet {label}: {len(results)} results of {expected}")
        for r in results:
            worker = r["sample"].get("worker")
            if r["status"] not in ("served", "degraded"):
                raise SystemExit(f"fleet {label}: {r['tenant']} {r['workload']} "
                                 f"{r['status']}: {r['error']}")
            if worker != f"w{shard_for(r['tenant'], n)}":
                raise SystemExit(f"fleet {label}: {r['tenant']} served by {worker}, "
                                 f"shard w{shard_for(r['tenant'], n)}")

    def children():
        return [p for p in multiprocessing.active_children() if p.name.startswith("fleet-")]

    def long_window(router, n):
        """One long warm window: FLEET_LONG_COPIES copies of the 24 requests
        in one run; per worker, engine time and measured dispatch time per
        request, and requests per task message and per result frame (one
        engine run, split at the worker's frame_max)."""
        reqs = [dataclasses.replace(r, seq=-1, trace_id=None, arrival_s=None)
                for r in trace() for _ in range(FLEET_LONG_COPIES)]
        before = dict(router.stats)
        router.submit_all(reqs)
        t0 = time.perf_counter()
        results = router.run()
        wall = time.perf_counter() - t0
        gate(f"N={n} long window", results, n, expected=len(reqs))
        frames = {k: router.stats[k] - before.get(k, 0)
                  for k in ("dispatch_frames", "result_frames")}
        by_worker = {}
        for r in results:
            by_worker.setdefault(r["sample"]["worker"], []).append(r)
        workers = {}
        for label, rs in sorted(by_worker.items()):
            busy = router.last_run["worker_busy_s"].get(label, 0.0)
            workers[label] = dict(requests=len(rs), engine_busy_s=busy,
                                  engine_ms_per_request=busy / len(rs) * 1e3,
                                  measured_ms_per_request=sum(r["measured_s"] for r in rs)
                                  / len(rs) * 1e3,
                                  refinements=sum(bool(r["refined"]) for r in rs))
        row = dict(requests=len(results), wall_s=wall, rps=len(results) / wall,
                   ipc_overhead_fraction=router.last_run["ipc_overhead_fraction"],
                   requests_per_task_message=len(results) / frames["dispatch_frames"],
                   requests_per_result_frame=len(results) / frames["result_frames"],
                   workers=workers)
        print(f"  long warm window: {len(results)} requests in {wall:.3f} s = "
              f"{row['rps']:.1f} requests/s; {row['requests_per_task_message']:.2f} requests per "
              f"task message, {row['requests_per_result_frame']:.2f} per result frame; "
              f"ipc_overhead_fraction {row['ipc_overhead_fraction']:.3f}; " + "; ".join(
                  f"{k}: {w['requests']} requests, engine {w['engine_ms_per_request']:.3f} ms "
                  f"and measured {w['measured_ms_per_request']:.3f} ms per request, "
                  f"{w['refinements']} refinements" for k, w in workers.items()))
        return row

    def read_checks(label):
        """The checks the router's workers wrote on their way out: every
        bucket checked, each within its tolerance."""
        checked, threads = {}, set()
        for path in glob.glob(os.path.join(FLEET_CHECKS, "*.json")):
            with open(path) as f:
                got = json.load(f)
            checked.update(got["checks"])
            threads.add(got["threads"])
            os.remove(path)
        worst = max(checked.values(), default=float("inf"))
        if set(checked) != buckets or not worst <= 1.0:
            raise SystemExit(f"fleet {label}: worker outputs against the CPU: "
                             f"{len(checked)} of {len(buckets)} buckets checked, "
                             f"worst err/tol {worst:.3e}")
        print(f"fleet: {label}: the first request of each of the {len(buckets)} (workload, "
              f"tenant) buckets, as its worker served it, against the CPU: worst err/tol "
              f"{worst:.4f} ok; intra-op threads per worker {sorted(threads)}")
        return dict(worst_err_over_tol=worst, worker_threads=sorted(threads))

    def long_router(n, threads=None):
        """FLEET_LONG_WINDOWS long warm windows in a router of their own:
        FLEET_LONG_CHUNK requests in every task message at every N, drift
        off (threshold 1e9, as the real trace runs: a refinement re-profiles
        for ~0.4 s and would time the refiner, not the serving), each worker
        with ``threads`` torch intra-op threads when given, else the
        router's default share of the host's cores; one cold rep first
        warms every bucket."""
        label = f"N={n}, {f'{threads} intra-op threads' if threads else 'default threads'}"
        router = FleetRouter(n, worker=dataclasses.replace(cfg, drift_threshold=1e9,
                                                           intra_op_threads=threads),
                             dispatch_chunk=FLEET_LONG_CHUNK)
        try:
            router.start()
            pids.update(slot.pid for slot in router._slots)
            reported = [slot.threads for slot in router._slots]
            print(f"fleet: {label}: intra-op threads each worker reported {reported} "
                  f"({os.cpu_count()} cores)")
            router.submit_all(trace())
            gate(f"{label}, rep 1", router.run(), n)
            print(f"fleet: long warm windows, {label}, drift off:")
            rows = [long_window(router, n) for _ in range(FLEET_LONG_WINDOWS)]
        finally:
            router.close()
        out = dict(windows=rows, rps=sum(r["requests"] for r in rows) / sum(r["wall_s"] for r in rows),
                   engine_ms_per_request=sum(w["engine_busy_s"] for r in rows
                                             for w in r["workers"].values())
                   / sum(r["requests"] for r in rows) * 1e3,
                   threads_reported=reported)
        out.update(read_checks(label))
        print(f"fleet: {label}: {out['rps']:.1f} requests/s over the long windows with "
              f"{reported} intra-op threads per worker")
        return out

    def drill(router, n):
        """SIGKILL the worker of tenant-0 as soon as a rep is dispatched,
        while it owes every request of its shard, then serve one more rep:
        the death is handled and the seat respawned within the killed run,
        and its un-acked work requeued.  (A worker returns its whole task
        message in one result frame, so a kill planned after a quarter of
        the rep's results found an idle victim, with nothing to requeue,
        whenever the victim's frame happened to come first.)"""
        victim = shard_for("tenant-0", n)
        base = dict(router.stats)
        router.submit_all(trace())
        router.inject_kill(victim, after_results=0)
        results = router.run()
        gate("SIGKILL drill", results, n)
        in_run = router.stats.get("worker_deaths", 0) - base.get("worker_deaths", 0)
        router.submit_all(trace())
        results = router.run()
        gate("SIGKILL drill, next rep", results, n)
        out = {k: router.stats.get(k, 0) - base.get(k, 0)
               for k in ("injected_kills", "worker_deaths", "worker_respawns",
                         "requeued_requests", "duplicate_results")}
        out["victim"] = f"w{victim}"
        out["death_seen_in_the_killed_run"] = bool(in_run)
        print(f"fleet: SIGKILL drill at N=2: {out}; every request of both reps "
              f"terminal and served by its shard")
        if (out["worker_deaths"] != 1 or out["worker_respawns"] != 1
                or out["requeued_requests"] < 1 or not in_run):
            raise SystemExit(f"fleet SIGKILL drill failed: {out}")
        return out

    out = {"compute_mode": mode, "mps": bool(mps)}
    # what the router's queue feeder and a worker do to one rep's requests
    # at N=1 (one task message), without the pipe: best of 3
    batch = [(f"r{i:06d}", r) for i, r in enumerate(trace())]
    dumps_s = loads_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        blob = ForkingPickler.dumps(("serve", batch))
        dumps_s = min(dumps_s, time.perf_counter() - t0)
        t0 = time.perf_counter()
        pickle.loads(blob)
        loads_s = min(loads_s, time.perf_counter() - t0)
    out["pickle"] = dict(mb=len(blob) / 1e6, dumps_s=dumps_s, loads_s=loads_s)
    print(f"fleet: one rep's {n_requests} requests as one task message: "
          f"{len(blob) / 1e6:.1f} MB, pickled in {dumps_s * 1e3:.1f} ms, unpickled in "
          f"{loads_s * 1e3:.1f} ms (in this process, no pipe)")
    del batch, blob
    probe = pipe_probe()
    out["pipe_probe"] = probe
    print("fleet: one message through a pipe (send_bytes in a thread, best of 3): "
          + "; ".join(f"{k} recv_bytes {v['recv_bytes'] * 1e3:.1f} ms, readv into one buffer "
                      f"{v['readv'] * 1e3:.1f} ms" for k, v in probe.items()))
    shutil.rmtree(FLEET_CHECKS, ignore_errors=True)
    buckets = {f"{w}/{t}" for w in FLEET_PROGRAMS for t in (f"tenant-{i}" for i in range(tenants))}
    pids = set()
    # every worker of the measured routers is the checked worker: the first
    # request of each (workload, tenant) it serves is held against the CPU
    with mock.patch.object(router_mod, "worker_main", checked_worker_main):
        for n in (1, 2, 4):
            free0 = torch.cuda.mem_get_info()[0]
            t0 = time.perf_counter()
            router = FleetRouter(n, worker=cfg)
            try:
                router.start()
                spawn_s = time.perf_counter() - t0
                # device memory the workers' contexts took, from the card's
                # free memory (nvidia-smi lists no process inside a container)
                used_mb = (free0 - torch.cuda.mem_get_info()[0]) / 2**20
                pids.update(slot.pid for slot in router._slots)
                rows, lats = [], []
                for rep in range(reps):
                    router.submit_all(trace())
                    t0 = time.perf_counter()
                    results = router.run()
                    t_end = time.perf_counter()
                    wall = t_end - t0
                    gate(f"N={n} rep {rep + 1}", results, n)
                    lats += [r["sample"]["latency_s"] for r in results]
                    # where the run's wall goes, on the one monotonic clock the
                    # router and its workers share: until the first request is
                    # decided in a worker, while workers decide and retire, and
                    # after the last retire until run() returns
                    first = min(r["sample"]["t_decide_s"] for r in results)
                    last = max(r["sample"]["t_retire_s"] for r in results)
                    rows.append(dict(wall_s=wall, rps=n_requests / wall,
                                     ipc_overhead_fraction=router.last_run["ipc_overhead_fraction"],
                                     worker_busy_s=router.last_run["worker_busy_s"],
                                     to_first_decide_s=first - t0, in_workers_s=last - first,
                                     after_last_retire_s=t_end - last,
                                     refinements=sum(bool(r["refined"]) for r in results)))
                per_worker = router.summary()["per_worker"]
                lstats = latency_stats(lats)
                warm = max(rows[1:], key=lambda r: r["rps"])
                out[f"n{n}"] = dict(spawn_s=spawn_s, device_mib_per_worker=used_mb / n,
                                    reps=rows,
                                    cold_rps=rows[0]["rps"], warm_rps=warm["rps"],
                                    warm_ipc_overhead_fraction=warm["ipc_overhead_fraction"],
                                    p50_ms=lstats["p50_s"] * 1e3, p99_ms=lstats["p99_s"] * 1e3,
                                    per_worker=per_worker)
                print(f"fleet: N={n}: spawned and ready in {spawn_s:.2f} s; device memory "
                      f"{used_mb:.0f} MiB for all {n} workers ({used_mb / n:.0f} per worker); "
                      f"cold {rows[0]['rps']:.1f} requests/s, warm "
                      + ", ".join(f"{r['rps']:.1f}" for r in rows[1:])
                      + " requests/s; ipc_overhead_fraction "
                      + ", ".join(f"{r['ipc_overhead_fraction']:.3f}" for r in rows)
                      + f"; latency p50 {out[f'n{n}']['p50_ms']:.2f} ms, p99 "
                      f"{out[f'n{n}']['p99_ms']:.2f} ms")
                print("  wall by rep: " + "; ".join(
                    f"{r['wall_s'] * 1e3:.1f} ms = {r['to_first_decide_s'] * 1e3:.1f} to the "
                    f"first decide + {r['in_workers_s'] * 1e3:.1f} in workers + "
                    f"{r['after_last_retire_s'] * 1e3:.1f} after the last retire, "
                    f"{r['refinements']} refinements" for r in rows))
                for label, w in per_worker.items():
                    busy = [r["worker_busy_s"].get(label, 0.0) for r in rows]
                    print(f"  {label}: {w['requests']} requests, {w['cache_hits']} hits, "
                          f"{w['refinements']} refinements, {w['failed']} failed; engine busy "
                          + ", ".join(f"{b * 1e3:.2f}" for b in busy) + " ms by rep")
                if n == 2:
                    out["drill"] = drill(router, n)
                    pids.update(slot.pid for slot in router._slots)
            finally:
                router.close()
            out[f"n{n}"].update(read_checks(f"N={n}"))
        # the long windows with the router's default intra-op threads (an
        # even share of the host's cores a worker) at N = 1, 2, 4, and at
        # N=4 with every core in every worker (torch's own default, the
        # fleet's setting before the share)
        long = {f"n{n}": long_router(n) for n in (1, 2, 4)}
        long["n4_all_cores"] = long_router(4, os.cpu_count())
    out["long"] = long
    out["speedup_warm"] = {f"n{n}": out[f"n{n}"]["warm_rps"] / out["n1"]["warm_rps"]
                           for n in (2, 4)}
    out["speedup_long"] = {k: long[k]["rps"] / long["n1"]["rps"]
                           for k in ("n2", "n4", "n4_all_cores")}
    print(f"fleet: warm requests/s over N=1: N=2 {out['speedup_warm']['n2']:.3f}x, "
          f"N=4 {out['speedup_warm']['n4']:.3f}x (24-request reps); long windows, drift "
          f"off: N=2 {out['speedup_long']['n2']:.3f}x, N=4 {out['speedup_long']['n4']:.3f}x "
          f"(threads per worker {long['n2']['threads_reported']}, "
          f"{long['n4']['threads_reported']}); every core in each of 4 workers "
          f"{out['speedup_long']['n4_all_cores']:.3f}x; engine ms per request " + ", ".join(
              f"{k} {v['engine_ms_per_request']:.3f}" for k, v in long.items()))

    # the user's entry point, with its telemetry and metrics files, and the
    # stats CLI's rendering of them
    work = os.path.join(ROOT, "build", "chip_smoke", "fleet")
    os.makedirs(work, exist_ok=True)
    tele, met = os.path.join(work, "telemetry.jsonl"), os.path.join(work, "metrics.json")
    for path in (tele, met):
        if os.path.exists(path):
            os.remove(path)
    summary = fleet_serve(FLEET_PROGRAMS, n_requests=n_requests, worker_procs=2, window=2,
                          tenants=tenants, model=artifact_id,
                          model_dir=os.path.join(ROOT, "build", "models"),
                          telemetry_path=tele, metrics_out=met, verbose=False,
                          device="cuda")
    samples = read_telemetry(tele)
    with open(met) as f:
        metrics = json.load(f)
    if (summary["requests"] != n_requests or set(summary["by_status"]) - {"ok", "degraded"}
            or set(summary["per_worker"]) != {"w0", "w1"} or summary["worker_deaths"]
            or len(samples) != n_requests or not metrics):
        raise SystemExit(f"fleet_serve failed: {summary}")
    out["fleet_serve"] = dict(requests=summary["requests"], rps=summary["throughput_rps"],
                              wall_s=summary["wall_s"],
                              ipc_overhead_fraction=summary["ipc_overhead_fraction"])
    print(f"fleet: fleet_serve(worker_procs=2, window 2, 8 tenants, dataset index 0): "
          f"{summary['requests']} requests in {summary['wall_s']:.2f} s with spawn and "
          f"shutdown, ipc_overhead_fraction {summary['ipc_overhead_fraction']:.3f}; "
          f"python -m repro_torch.launch.stats --telemetry {tele} --metrics {met}:")
    print(render(samples, metrics))

    left = children()
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if left or alive:
        raise SystemExit(f"fleet: processes left behind: {left} {alive}")
    print(f"fleet: no worker process left ({len(pids)} pids of the measured routers "
          f"gone, no live fleet child)")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet: phase {out['phase_s']:.1f} s")
    return out


# the sharding phase: yi-9b decoded sharded and local on a one-rank mesh,
# stablelm-3b's parameters resharded onto the card, the four examples
SHARD_DECODE = dict(arch="yi-9b", batch=4, prompt_len=512, gen_len=16)
SHARD_LOGIT_TOL = 1e-4
SHARD_CACHE_TOL = 1e-6
RESHARD_ARCH = "stablelm-3b"
EXAMPLES = ("quickstart", "serve_batched", "autotune_workloads", "fault_tolerant_train")
EXAMPLE_TIMEOUT_S = 420


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharding_phase(torch, dev, card):
    """The sharding layer and the examples on the card.

    (a) A one-rank process group (``nccl`` on the card) and
    ``make_test_mesh(1, 1)``; yi-9b at full width and depth, fp32, prefilled
    at 4 x 512 tokens, then 16 greedy decode steps, once with
    ``decode_attn="sharded"`` (``decode_attention_sharded``: its all-reduces
    over the mesh's ``model`` group) and once ``"local"``: gated on equal
    tokens, every step's logits within 1e-4 and the caches within 1e-6,
    with exact kernel launch counts; prints decode ms a step both ways.
    (b) stablelm-3b's full-width parameters, made on the host with numpy,
    distributed onto the card mesh by their logical axes under
    ``AxisRules.pod()`` through ``reshard_tree``: bitwise equal on readback,
    with the rate; then ``Checkpointer.restore(shardings=...)`` of a reduced
    tree onto the card, bitwise equal.  (c) The four ``examples/torch/``
    scripts, each a child process with ``--device cuda``: exit 0 and their
    own checks.  Returns the summary it prints."""
    import shutil

    import numpy as np
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.elastic import reshard_tree
    from repro_torch.launch.mesh import dp_axes_of, make_test_mesh
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import RunConfig
    from repro_torch.parallel.sharding_rules import AxisRules, tree_shardings

    t_phase = time.perf_counter()
    out, failures = {}, []
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", world_size=1, rank=0)
    try:
        mesh = make_test_mesh(1, 1, device=dev)
        print(f"sharding: {dist.get_backend()} process group of 1 rank, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}")

        # -- (a) sharded decode at full width ------------------------------------
        arch, B, S, G = (SHARD_DECODE[k] for k in ("arch", "batch", "prompt_len", "gen_len"))
        cfg = get_arch(arch)
        rcfg_sharded = RunConfig(decode_attn="sharded", mesh=mesh, dp_axes=dp_axes_of(mesh))
        models = {"sharded": build_model(arch, rcfg_sharded, device=dev),
                  "local": build_model(arch, RunConfig(), device=dev)}
        params = models["local"].init(torch.Generator(device=dev).manual_seed(0))
        prompts = torch.from_numpy(_prompts(cfg.vocab_size, (B, S))).to(dev)
        calls = [0]
        sharded_fn = attn_lib.decode_attention_sharded

        def counted(*a, **k):
            calls[0] += 1
            return sharded_fn(*a, **k)

        attn_lib.decode_attention_sharded = counted
        ops.reset_launch_counts()
        runs = {}
        try:
            with torch.inference_mode():
                logits, filled = models["local"].prefill(params, {"tokens": prompts})
                for name, model in models.items():
                    cache = model.decode_cache(filled, S + G)
                    toks, tokens, step_logits, step_s = logits.argmax(-1), [], [], []
                    for i in range(G):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        lg, cache = model.decode_step(params, {"tokens": toks[:, None]},
                                                      cache, S + i)
                        toks = lg.argmax(-1)
                        torch.cuda.synchronize()
                        step_s.append(time.perf_counter() - t0)
                        tokens.append(toks)
                        step_logits.append(lg)
                    runs[name] = (torch.stack(tokens), torch.stack(step_logits), cache, step_s)
        finally:
            attn_lib.decode_attention_sharded = sharded_fn
        launches = ops.launch_counts()
        del filled, params
        want = launch_dict(flash_attention=cfg.num_layers,
                           rmsnorm=(1 + 2 * G) * _norms_per_forward(cfg))
        (tok_s, lg_s, cache_s, ms_s), (tok_l, lg_l, cache_l, ms_l) = runs["sharded"], runs["local"]
        same_tokens = bool(torch.equal(tok_s, tok_l))
        logit_err = (lg_s - lg_l).abs().max().item()
        cache_err = max((a[k] - b[k]).abs().max().item()
                        for a, b in zip(cache_s, cache_l) for k in ("k", "v"))
        finite = bool(torch.isfinite(lg_s).all())
        step = {name: sorted(r[3])[len(r[3]) // 2] * 1e3 for name, r in runs.items()}
        ok = (same_tokens and logit_err <= SHARD_LOGIT_TOL and cache_err <= SHARD_CACHE_TOL
              and finite and launches == want and calls[0] == G * cfg.num_layers)
        print(f"sharding (a): {arch} full width and depth, fp32, prefill {B} x {S}, {G} greedy "
              f"decode steps each way: tokens equal {same_tokens}, logits max_abs_err "
              f"{logit_err:.3e} (tol {SHARD_LOGIT_TOL:g}), caches max_abs_err {cache_err:.3e} "
              f"(tol {SHARD_CACHE_TOL:g}), finite {finite}; decode_attention_sharded calls "
              f"{calls[0]} (expected {G * cfg.num_layers}); launches {launches} (expected "
              f"{want}) {'ok' if ok else 'FAIL'}")
        print(f"sharding (a): decode ms a step (median of {G}): sharded {step['sharded']:.3f}, "
              f"local {step['local']:.3f}, difference {step['sharded'] - step['local']:.3f} "
              f"(the {dist.get_backend()} path at world size 1; {card})")
        # what a sharded step adds, a call at a time: each layer's decode
        # attention both ways at this run's shapes (one layer's cache),
        # and in the sharded one the all-reduce of the row max (B, KV, G)
        # and the mesh lookups
        group = mesh.get_group("model")
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        m = torch.zeros((B, KV, cfg.num_heads // KV), device=dev)
        qa, kn, vn = (torch.randn(shape, device=dev)
                      for shape in ((B, 1, cfg.num_heads, hd), (B, 1, KV, hd), (B, 1, KV, hd)))
        kc, vc = cache_l[0]["k"], cache_l[0]["v"]
        with torch.inference_mode():  # the caches are inference tensors
            us = {name: cuda_time_ms(torch, fn, [()], iters=100) * 1e3 for name, fn in (
                ("local_attention", lambda: attn_lib.decode_attention_local(
                    qa, kn, vn, kc, vc, S + G - 1)),
                ("sharded_attention", lambda: attn_lib.decode_attention_sharded(
                    qa, kn, vn, kc, vc, S + G - 1, mesh=mesh, dp_axes=dp_axes_of(mesh))),
                ("all_reduce", lambda: dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)),
                ("mesh_lookups", lambda: (mesh.get_group("model"),
                                          mesh.get_local_rank("model"))))}
        print(f"sharding (a): us a call: decode attention local {us['local_attention']:.1f}, "
              f"sharded {us['sharded_attention']:.1f} (one layer, {(B, S + G, KV, hd)} cache), "
              f"of which dist.all_reduce on the model group {us['all_reduce']:.1f} (x2), "
              f"mesh.get_group + get_local_rank {us['mesh_lookups']:.1f}; a step makes "
              f"{cfg.num_layers} such calls")
        if not ok:
            failures.append("sharded decode")
        out["decode"] = dict(arch=arch, batch=B, prompt_len=S, decode_steps=G,
                             **{f"{name}_us": v for name, v in us.items()},
                             tokens_equal=same_tokens, logit_max_abs_err=logit_err,
                             cache_max_abs_err=cache_err, sharded_calls=calls[0],
                             sharded_step_ms=step["sharded"], local_step_ms=step["local"],
                             sharded_steps_ms=[s * 1e3 for s in ms_s],
                             local_steps_ms=[s * 1e3 for s in ms_l])
        out["launches"] = launches
        del runs, tok_s, lg_s, cache_s, tok_l, lg_l, cache_l, logits
        torch.cuda.empty_cache()

        # -- (b) elastic reshard at full width ------------------------------------
        model = build_model(RESHARD_ARCH, device=dev)
        shapes, axes = model.abstract_params()
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        host = tree_lib.map(lambda m: rng.random(tuple(m.shape), dtype=np.float32), shapes)
        gen_s = time.perf_counter() - t0
        n_params = sum(a.size for a in tree_lib.leaves(host))
        n_bytes = sum(a.nbytes for a in tree_lib.leaves(host))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = reshard_tree(host, axes, mesh, AxisRules.pod())
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        on_card = all(d.to_local().device.type == dev.type for d in tree_lib.leaves(tree))
        equal = all(np.array_equal(d.full_tensor().cpu().numpy().view(np.uint32),
                                   h.view(np.uint32))
                    for d, h in zip(tree_lib.leaves(tree), tree_lib.leaves(host)))
        placements = sorted({str(d.placements) for d in tree_lib.leaves(tree)})
        ok = equal and on_card
        print(f"sharding (b): {RESHARD_ARCH} full width, {n_params / 1e9:.3f} B parameters, "
              f"{n_bytes / 1e9:.2f} GB fp32 from numpy ({gen_s:.1f} s to make): reshard_tree "
              f"onto the card in {put_s:.3f} s, {n_bytes / put_s / 1e9:.2f} GB/s; placements "
              f"{placements}; bitwise equal on readback {equal} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("reshard_tree")
        out["reshard"] = dict(arch=RESHARD_ARCH, params=n_params, bytes=n_bytes,
                              seconds=put_s, gb_per_s=n_bytes / put_s / 1e9, bitwise_equal=equal)
        del tree, host
        torch.cuda.empty_cache()

        small = build_model(RESHARD_ARCH, reduced=True, device="cpu")
        small_params = small.init(torch.Generator().manual_seed(0))
        ckpt_dir = os.path.join(ROOT, "build", "chip_smoke", "sharding_ckpt")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        Checkpointer(ckpt_dir, async_save=False).save(7, small_params)
        step_no, restored = Checkpointer(ckpt_dir).restore(
            shardings=tree_shardings(small.abstract_params()[1], AxisRules.pod(), mesh))
        got, want_leaves = tree_lib.leaves(restored), tree_lib.leaves(small_params)
        equal = (step_no == 7 and len(got) == len(want_leaves)
                 and all(d.to_local().device.type == dev.type
                         and torch.equal(d.full_tensor().cpu(), w)
                         for d, w in zip(got, want_leaves)))
        shutil.rmtree(ckpt_dir)
        print(f"sharding (b): Checkpointer.restore(shardings=...) of reduced {RESHARD_ARCH} "
              f"({len(got)} leaves) onto the card: bitwise equal {equal} "
              f"{'ok' if equal else 'FAIL'}")
        if not equal:
            failures.append("Checkpointer.restore(shardings=...)")
        out["restore_bitwise_equal"] = equal
    finally:
        dist.destroy_process_group()
        for k in ("MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)

    # -- (c) the four examples ---------------------------------------------------
    ex_dir = os.path.join(ROOT, "build", "chip_smoke", "examples")
    shutil.rmtree(ex_dir, ignore_errors=True)
    os.makedirs(ex_dir)
    shutil.rmtree(os.path.join(ROOT, "build", "examples"), ignore_errors=True)  # quickstart cold
    profile = os.path.join(ex_dir, "profile_cache_cuda.json")
    if os.path.exists(CORPUS_CACHE):  # the cells phase 5 profiled are read back
        shutil.copy(CORPUS_CACHE, profile)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_PROFILE_CACHE=profile)
    out["examples"] = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "torch",
                                                            f"{name}.py"), "--device", "cuda"],
                              cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=EXAMPLE_TIMEOUT_S)
        secs = time.perf_counter() - t0
        with open(os.path.join(ex_dir, f"{name}.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        headline = lines[-1] if lines else ""
        ok = proc.returncode == 0
        if name == "quickstart":
            ok &= "warm hit: cached=True, same config=True" in proc.stdout
        if name == "fault_tolerant_train":
            ok &= headline.startswith("resumed from step")
        print(f"sharding (c): examples/torch/{name}.py --device cuda: exit {proc.returncode} "
              f"in {secs:.1f} s; {headline!r} {'ok' if ok else 'FAIL'}")
        if not ok:
            print(proc.stdout[-3000:] + proc.stderr[-3000:])
            failures.append(f"examples/torch/{name}.py")
        out["examples"][name] = dict(exit=proc.returncode, seconds=secs, headline=headline)

    out["phase_s"] = time.perf_counter() - t_phase
    print(f"sharding: phase {out['phase_s']:.1f} s")
    if failures:
        raise SystemExit("sharding phase failed: " + ", ".join(failures))
    return out


def host_copy_scaling(torch, dev, trace):
    """The two host copies every served request makes — pinning its
    inputs in decide, the pageable ``.cpu()`` of its outputs in dispatch
    — in GB/s, over the trace's 16-25 MB inputs issued from 1 thread and
    from 4 at once (each thread on its own stream; best of 3): whether
    the host's copy path scales with the window."""
    from repro_torch.core.backends import WindowedPool

    arrays = [a for r in trace for a in r.chunked.values() if a.nbytes >= 8e6][:8]
    tensors = [torch.from_numpy(a).to(dev) for a in arrays]
    torch.cuda.synchronize()
    n_bytes = sum(a.nbytes for a in arrays)

    def pin(i):
        torch.from_numpy(arrays[i]).pin_memory()

    pool = WindowedPool(4, 4, name="host-copies")

    def read(i):
        with torch.cuda.stream(pool.thread_stream(tensors[i].device)):
            tensors[i].cpu()

    out = {}
    try:
        for name, fn in (("pin", pin), ("readback", read)):
            for threads in (1, 4):
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    if threads == 1:
                        for i in range(len(arrays)):
                            fn(i)
                    else:
                        list(pool.executor().map(fn, range(len(arrays))))
                    best = min(best, time.perf_counter() - t0)
                out[f"{name}_gbps_{threads}"] = n_bytes / best / 1e9
    finally:
        pool.shutdown()
    print(f"serving: host copies over {len(arrays)} arrays, {n_bytes / 1e6:.1f} MB: pinning "
          f"{out['pin_gbps_1']:.2f} GB/s from 1 thread, {out['pin_gbps_4']:.2f} from 4; "
          f"pageable readback {out['readback_gbps_1']:.2f} GB/s from 1 thread, "
          f"{out['readback_gbps_4']:.2f} from 4")
    return out


class _CalibratedStub:
    """Speedup 1.0 for every config, with a recording refit: the search
    picks single-stream and predicted runtime is the profiled anchor."""

    def __init__(self):
        self.refits = 0

    def predict_configs(self, feats, candidates):
        import numpy as np

        F = np.asarray(feats)
        preds = np.ones((np.atleast_2d(F).shape[0], len(candidates)))
        return preds[0] if F.ndim == 1 else preds

    def refit(self, X, y, **kw):
        self.refits += 1
        return 0.0


def poison_drill(torch, dev):
    """``tests/test_serving.py``'s end-to-end drill on ``dev``: measured
    times pinned to the bucket's anchor, one entry's predicted speedup
    inflated 40x, six more requests of that bucket: exactly one
    refinement, then warm hits of the refined entry."""
    import dataclasses

    import numpy as np

    from repro_torch.core.stream_config import SINGLE_STREAM
    from repro_torch.core.streams import StreamedRunner
    from repro_torch.core.workloads import get_workload
    from repro_torch.serving import (AdaptiveScheduler, DriftDetector,
                                     WorkloadRequest, make_trace)

    class Pinned(AdaptiveScheduler):
        def _execute(self, pending):
            outs, measured = super()._execute(pending)
            return outs, self._t_single.get(pending.key, measured)

    stub = _CalibratedStub()
    sched = Pinned(stub, device=dev, backend="host-sync",
                   drift=DriftDetector(window=8, threshold=6.0, min_samples=2, cooldown=2))
    trace = make_trace(["vecadd", "dotprod", "mvmult"], occurrences=2, seed=0)
    sched.submit_all(trace)
    first = sched.run()
    if ([r.cache_hit for r in first] != [False] * 3 + [True] * 3
            or sched.stats["model_searches"] != 3 or sched.stats["refinements"] != 0):
        raise SystemExit(f"poison drill: first pass {[r.cache_hit for r in first]}, "
                         f"{dict(sched.stats)}")
    key = sched.cache.key("vecadd", trace[0].chunked, trace[0].shared, "host-sync", "")
    entry = sched.cache.get(key)
    sched.cache.put(key, dataclasses.replace(
        entry, predicted_speedup=entry.predicted_speedup * 40.0))
    wl = get_workload("vecadd")
    rows = next(iter(trace[0].chunked.values())).shape[0]  # the poisoned bucket's
    for seed in range(10, 16):
        chunked, shared = wl.make_data(rows, np.random.default_rng(seed))
        sched.submit(WorkloadRequest(workload="vecadd", chunked=chunked, shared=shared))
    post = sched.run()
    refined = [i for i, r in enumerate(post) if r.refined]
    after = post[refined[0] + 1:] if refined else []
    ok = (sched.stats["refinements"] == 1 and len(refined) == 1 and stub.refits == 1
          and after and all(r.cache_hit and r.sample.source == "refined" for r in after))
    for r in first + post:
        want = StreamedRunner(get_workload(r.request.workload), r.request.chunked,
                              r.request.shared, device="cpu").dispatch(SINGLE_STREAM)[0]
        got = torch.cat([o.cpu() for o in r.outputs])
        ok &= bool(np.allclose(got.numpy(), want.numpy(), rtol=WL_RTOL, atol=WL_ATOL))
    errs = [round(r.sample.rel_error, 4) for r in post]
    print(f"serving: poison drill on the card: refinements {sched.stats['refinements']} "
          f"(at post request {refined}), refits {stub.refits}, post rel errors {errs}, "
          f"sources {[r.sample.source for r in post]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("poison drill failed")
    return dict(refinements=1, refined_at=refined[0], rel_errors=errs)


def cli_run(dev, artifact_id, work):
    """``adaptive_serve`` through its public signature, with span tracing
    and metrics written under build/."""
    from repro_torch.launch.serve import adaptive_serve
    from repro_torch.launch.train_model import DEFAULT_TRAIN_PROGRAMS

    trace_out = os.path.join(work, "serve_trace.json")
    metrics_out = os.path.join(work, "serve_metrics.json")
    summary = adaptive_serve(DEFAULT_TRAIN_PROGRAMS, n_requests=12, backend="host-threads",
                             window=4, tenants=4, model=artifact_id,
                             model_dir=os.path.join(ROOT, "build", "models"),
                             trace_out=trace_out, metrics_out=metrics_out,
                             verbose=False, device=dev)
    with open(trace_out) as f:
        events = json.load(f)["traceEvents"]
    with open(trace_out[:-5] + ".jsonl") as f:
        spans = [json.loads(line) for line in f if line.strip()]
    with open(metrics_out) as f:
        metrics = json.load(f)
    ok = (summary["requests"] == 12 and summary["by_status"] == {"ok": 12}
          and len(spans) > 0 and len(events) >= len(spans)
          and "serving.requests" in metrics)
    print(f"serving: adaptive_serve(window=4, host-threads, 4 tenants): "
          f"{summary['requests']} requests, {summary['throughput_rps']:.1f} requests/s, "
          f"hit rate {summary['hit_rate']:.3f}; {len(spans)} spans -> {trace_out}, "
          f"{len(metrics)} metric families -> {metrics_out} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"adaptive_serve failed: {summary}")
    return dict(requests=summary["requests"], rps=summary["throughput_rps"],
                hit_rate=summary["hit_rate"], spans=len(spans), metrics=len(metrics))


def device_idle(torch, fn, path):
    """``fn()`` under torch.profiler (device activity only; the trace goes
    to ``path``): its wall time, the device's busy time as the union of
    its kernel, copy and memset intervals on every stream (overlapping
    streams count once), kernels and copies each summed apart, and the
    idle share.  A trace of a few milliseconds has come back with no
    device event at all (a 4-op runner run that other card runs traced):
    then ``fn`` runs once more under a new profiler, and a second empty
    trace raises.  Returns ``(fn's result, stats, the profiler)``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    for attempt in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["cat"]) for e in events
                       if e.get("ph") == "X"
                       and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
        if spans:
            break
        print(f"{path}: the profiler saw no device work (attempt {attempt} of 2)")
    else:
        raise SystemExit(f"{path}: the profiler saw no device work in 2 attempts")
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    wall_ms, busy_ms = wall * 1e3, busy_us / 1e3
    return result, dict(
        wall_ms=wall_ms, busy_ms=busy_ms, n_ops=len(spans),
        kernels_ms=sum(b - a for a, b, c in spans if c == "kernel") / 1e3,
        copies_ms=sum(b - a for a, b, c in spans if c == "gpu_memcpy") / 1e3,
        idle_share=1 - busy_ms / wall_ms), prof


def idle_line(idle):
    return (f"wall {idle['wall_ms']:.3f} ms under the profiler, device busy "
            f"{idle['busy_ms']:.3f} ms (union over streams; kernels {idle['kernels_ms']:.3f}, "
            f"copies {idle['copies_ms']:.3f}; {idle['n_ops']} device ops), "
            f"idle share {idle['idle_share']:.3f}")


def decode_device_us(torch, dev, randn, rmsnorm_cuda, F):
    """Device time per launch at the RMSNorm decode shape, of the kernel and
    of F.rms_norm, from torch.profiler over 200 launches each; and the host
    cost of the two ways to read the current stream."""
    from torch.profiler import ProfilerActivity, profile

    d = YI_NORM_DECODE[-1]
    x, s = randn(YI_NORM_DECODE, torch.float32), randn((d,), torch.float32)
    for label, fn in (("kernel", lambda: rmsnorm_cuda(x, s)),
                      ("F.rms_norm", lambda: F.rms_norm(x, (d,), weight=s, eps=1e-5))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                 for e in ev)
        n = sum(e.count for e in ev)
        print(f"device time rmsnorm decode {YI_NORM_DECODE} fp32, {label}: "
              f"{us / max(n, 1):.3f} us per launch over {n} launches")
    index = torch.cuda.current_device()
    for label, fn in (("torch.cuda.current_stream().cuda_stream",
                       lambda: torch.cuda.current_stream(dev).cuda_stream),
                      ("torch._C._cuda_getCurrentRawStream",
                       lambda: torch._C._cuda_getCurrentRawStream(index))):
        t0 = time.perf_counter()
        for _ in range(20000):
            fn()
        print(f"host time {label}: {(time.perf_counter() - t0) / 20000 * 1e6:.3f} us per call")


def norm_threads_us(torch):
    """Device time per launch of the RMSNorm kernel with its own cap of 256
    threads per row and with 1024 (one 16-byte access per thread at d=4096),
    at the yi-9b decode and prefill shapes, from torch.profiler over 100
    launches each: the measurement behind the one cap.  The library is
    called directly, with the cap forced, so these launches are not counted
    as the wrapper's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import rmsnorm

    lib = rmsnorm._lib or rmsnorm._load()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, shape in (("decode", YI_NORM_DECODE), ("prefill", YI_NORM_PREFILL)):
        d = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda")
        s = torch.randn((d,), generator=gen, device="cuda")
        out = torch.empty_like(x)
        want = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * s
        row = []
        for cap in (1024, 256):
            def launch():
                stream = torch._C._cuda_getCurrentRawStream(x.device.index)
                err = lib.rmsnorm_fwd(x.data_ptr(), s.data_ptr(), out.data_ptr(),
                                      x.numel() // d, d, 1e-5, 0, cap,
                                      stream)
                if err:
                    raise RuntimeError(f"rmsnorm launch with {cap} threads failed: {err}")

            launch()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if err > NORM_TOL["float32"]:
                raise SystemExit(f"rmsnorm {label} with {cap} threads: max_abs_err {err:.3e}")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(100):
                    launch()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                     for e in ev)
            n = sum(e.count for e in ev)
            row.append(f"{cap} threads {us / max(n, 1):.3f} us (err {err:.1e})")
        print(f"device time rmsnorm {label} {shape} fp32 per launch by thread cap: "
              + ", ".join(row))


def profile_main_path(torch, dev, build_model, cfg):
    """Device time by kernel for one full-width prefill (4 x 512) and one
    decode step, under torch.profiler."""
    model = build_model("yi-9b", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(_prompts(cfg.vocab_size, (4, 512))).to(dev)
    with torch.inference_mode():
        logits, filled = model.prefill(params, {"tokens": toks})
        cache = model.init_cache(4, 528)
        for layer, layer_filled in zip(cache, filled):
            for kv in ("k", "v"):
                layer[kv][:, :512] = layer_filled[kv]
        del filled
        nxt = {"tokens": logits.argmax(dim=-1)[:, None]}
        model.decode_step(params, nxt, cache, 512)
        torch.cuda.synchronize()
        for label, fn in (("prefill 4x512", lambda: model.prefill(params, {"tokens": toks})),
                          ("decode step", lambda: model.decode_step(params, nxt, cache, 513))):
            _, idle, prof = device_idle(
                torch, fn, os.path.join(ROOT, "build", "chip_smoke",
                                        f"profile_{label.split()[0]}.json"))
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]

            def dev_us(e):
                return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

            busy_ms = idle["busy_ms"]
            print(f"profile {label}: {idle_line(idle)}")
            for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
                print(f"  {dev_us(e) / 1e3:9.3f} ms {dev_us(e) / 1e3 / busy_ms:6.1%} "
                      f"x{e.count:<5d} {e.key[:90]}")
    del params, cache
    torch.cuda.empty_cache()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _prompts(vocab, shape):
    import numpy as np

    return np.random.default_rng(1).integers(0, vocab, shape).astype(np.int32)


if __name__ == "__main__":
    sys.exit(main())
