"""Batched LM serving: prefill, then greedy decode over a KV cache.

Requests are batched in fixed slots (``batch_slots`` sequences per batch,
the last batch may be short).  Each batch is prefilled in one forward pass;
its k/v are copied into a cache preallocated at ``prompt_len + gen_len``,
and then every step decodes one token per sequence against that cache,
which the step updates in place.  Prompts come from
``np.random.default_rng(seed)`` exactly as in the JAX ``serve``, so both
packages serve the same tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b
"""
from __future__ import annotations

import argparse
import dataclasses
import time

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
            cache = model.init_cache(B, max_seq)
            for layer, layer_filled in zip(cache, filled):
                for kv in ("k", "v"):
                    layer[kv][:, :prompt_len] = layer_filled[kv]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    args = ap.parse_args()
    res = serve(args.arch, n_requests=args.requests, batch_slots=args.slots,
                prompt_len=args.prompt_len, gen_len=args.gen_len)
    print(f"{res.tokens_generated} tokens in {res.wall_s:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s)")


if __name__ == "__main__":
    main()
