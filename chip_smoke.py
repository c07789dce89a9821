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
   finite;
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
   and the device's idle share;
7. prints an ``{"autotune": {...}}`` line, a ``{"serving": {...}}`` line,
   a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

Any failure raises and exits non-zero.  Without CUDA, or without this
checkout's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): HBM bytes/s, fp32 CUDA-core, TF32 and
# bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}

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
    want_launches = {"flash_attention": n_batches * cfg.num_layers,
                     "rmsnorm": n_forwards * (2 * cfg.num_layers + 1)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = serve("yi-9b", reduced=False, n_requests=n_req, batch_slots=slots,
                prompt_len=prompt_len, gen_len=gen_len, device="cuda")
    launches = ops.launch_counts()
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
    want_sl = {"flash_attention": layers, "rmsnorm": gen_len * (2 * layers + 1)}
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

    # -- 4. times at the main-path shapes --------------------------------------
    def time_ms(fn, sets, iters=50):
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

    def bound(n_bytes, n_ops, dtype):
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = n_ops / PEAK_OPS_PER_S[dtype]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

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
    lib_err = (F.scaled_dot_product_attention(*sdpa_sets[0], is_causal=True, enable_gqa=True)
               .transpose(1, 2) - ref.flash_attention_ref(q0, k0, v0)).abs().max().item()
    del attn_sets, sdpa_sets
    (c_ms, c_by), (b_ms, b_by) = attn_bounds(*YI_ATTN)
    print(f"time flash_attention {YI_ATTN} fp32 causal: kernel {t_kernel:.4f} ms, "
          f"plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms (sdpa vs plain "
          f"max_abs_err {lib_err:.1e}), bound 3xTF32 tensor cores {b_ms:.4f} ms by "
          f"{b_by}, bound fp32 CUDA cores {c_ms:.4f} ms by {c_by}")
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:123",
        launches=launches["flash_attention"], max_abs_err=main_err["flash_attention"],
        ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib))
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
        norm_times[label] = (t_kernel, t_plain, t_lib, b_ms, b_by)
        # A copy moves the same bytes (x read, y written): what the card's
        # memory reaches for this mix, beside the bound.
        t_copy = time_ms(lambda x, s: torch.empty_like(x).copy_(x), sets)
        print(f"time rmsnorm {label} {shape} fp32: kernel {t_kernel:.4f} ms (rounds "
              f"{min(rounds['kernel']):.4f}-{max(rounds['kernel']):.4f}), plain "
              f"{t_plain:.4f} ms, F.rms_norm {t_lib:.4f} ms (rounds "
              f"{min(rounds['F.rms_norm']):.4f}-{max(rounds['F.rms_norm']):.4f}), copy of x "
              f"{t_copy:.4f} ms, bound {b_ms:.6f} ms by {b_by}")
    decode_device_us(torch, dev, randn, rmsnorm_cuda, F)
    norm_threads_us(torch)
    t_kernel, t_plain, t_lib, b_ms, b_by = norm_times["prefill"]
    rows.append(dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:35", launches=launches["rmsnorm"],
        max_abs_err=main_err["rmsnorm"], ms=t_kernel, plain_ms=t_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=t_lib))

    profile_main_path(torch, dev, build_model, cfg)

    # -- 5. the streamed-autotuning loop ---------------------------------------
    autotune = autotune_phase(torch, dev)

    # -- 6. adaptive serving ---------------------------------------------------
    serving = serving_phase(torch, dev, autotune["artifact_id"])

    # -- 7. result -------------------------------------------------------------
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"autotune": autotune}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    cache = os.path.join(ROOT, "build", "chip_smoke", "profile_cache_cuda.json")
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
    idle share.  Raises when the trace holds no device event.  Returns
    ``(fn's result, stats, the profiler)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["cat"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        raise SystemExit(f"{path}: the profiler saw no device work")
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
