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
6. prints an ``{"autotune": {...}}`` line, a ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, ...}``.

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

    # -- 6. result -------------------------------------------------------------
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"autotune": autotune}))
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
        runner.dispatch(wide)
        torch.cuda.synchronize(dev)
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
    for label, r, c in ((f"vecadd@{wl.datasets[-1]}", runner, SINGLE_STREAM),
                        (f"vecadd@{wl.datasets[-1]}", runner, wide),
                        (f"binomial@{binomial.datasets[-1]}", b_runner, SINGLE_STREAM)):
        device_share(torch, f"{label} {c.as_tuple()}",
                     lambda: r.run(c, reps=1, warmed=True))

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


def device_share(torch, label, fn):
    """One timed runner call under torch.profiler: wall time, the device's
    busy time split into copies and kernels, and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {"copies": 0.0, "kernels": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            ms["copies" if "Memcpy" in e.key else "kernels"] += us / 1e3
            launches += e.count
    busy = ms["copies"] + ms["kernels"]
    print(f"autotune: profile {label}: wall {wall_ms:.3f} ms under the profiler, "
          f"device busy {busy:.3f} ms (copies {ms['copies']:.3f}, kernels "
          f"{ms['kernels']:.3f}; {launches} device ops), idle share "
          f"{1 - busy / wall_ms:.3f}")


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
    from torch.profiler import ProfilerActivity, profile

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
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]

            def dev_us(e):
                return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

            busy_ms = sum(dev_us(e) for e in kernels) / 1e3
            print(f"profile {label}: wall {wall_ms:.3f} ms under the profiler, device "
                  f"busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
                  f"{sum(e.count for e in kernels)} kernel launches")
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
