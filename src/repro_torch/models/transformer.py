"""Decoder: attention, mamba, sLSTM and mLSTM blocks, each with an optional
dense or MoE FFN, stacked by ``ArchConfig.layer_pattern``.

The JAX package scans over stacked pattern repeats (``jax.lax.scan``); here
the blocks are a Python list, one dict per layer, applied in a loop.  Layer
``l`` has block type ``layer_pattern[l % len(layer_pattern)]``, the order
the scan visits them in.  The decode cache is a list of the same length:
k/v for an attention layer, the recurrent state for the others.  One code
path serves all ten architectures of ``repro_torch.configs``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.parallel.sharding_rules import AxisRules
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs orthogonal to the architecture.

    ``rules`` maps logical axes to mesh axes (``AxisRules.null()``: no
    sharding).  The models lay their activations out by it at the JAX
    package's 17 ``rules.constrain`` sites: on DTensor activations each is
    a redistribute, and a plain tensor, or any tensor under disabled rules,
    passes unchanged.  ``attn_expand_kv`` repeats k/v to the query heads
    before the attention kernel (the JAX ``gqa_grouped=False``), so that a
    head dim split over ``model`` stays local.  ``decode_attn="sharded"``
    decodes through ``attention.decode_attention_sharded`` over ``mesh``
    (a ``DeviceMesh`` with a ``model`` dim), each rank holding its own
    batch rows (split over ``dp_axes``) and its sequence slab of every
    attention layer's cache."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    cache_dtype: torch.dtype = torch.float32
    rules: AxisRules = dataclasses.field(default_factory=AxisRules.null)
    q_block: int = 512
    kv_block: int = 512
    remat: str = "none"           # none | full | dots
    capacity_factor: float = 1.25
    decode_attn: str = "local"    # local | sharded
    mesh: Any = None              # required for decode_attn == "sharded"
    dp_axes: tuple = ("data",)
    moe_aux_weight: float = 0.01
    moe_group_size: int = 512
    attn_expand_kv: bool = False  # True on the pod path (see attention.expand_kv)


# ---------------------------------------------------------------------------
# Per-block init
# ---------------------------------------------------------------------------


def _has_ffn(cfg: ArchConfig, pos: int) -> bool:
    b = cfg.layer_pattern[pos]
    if cfg.ffn_on == "none":
        return False
    if cfg.ffn_on == "attn" and b != "attn":
        return False
    return cfg.d_ff > 0 or cfg.moe is not None


def _is_moe(cfg: ArchConfig, pos: int) -> bool:
    if cfg.moe is None or not _has_ffn(cfg, pos):
        return False
    moe_set = set(cfg.moe_layer_indices)
    return (not moe_set) or (pos in moe_set)


def _attn_init(gen, cfg: ArchConfig, kw) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": layers.dense_init(gen, (d, H, hd), ("embed", "heads", "head_dim"), **kw),
        "wk": layers.dense_init(gen, (d, KV, hd), ("embed", "kv_heads", "head_dim"), **kw),
        "wv": layers.dense_init(gen, (d, KV, hd), ("embed", "kv_heads", "head_dim"), **kw),
        "wo": layers.dense_init(gen, (H, hd, d), ("heads", "head_dim", "embed"),
                                fan_in=H * hd, **kw),
    }


def _block_init(gen, cfg: ArchConfig, pos: int, kw) -> dict:
    btype = cfg.layer_pattern[pos]
    p: dict = {"norm1": layers.rmsnorm_init(gen, cfg.d_model, **kw)}
    if btype == "attn":
        p["attn"] = _attn_init(gen, cfg, kw)
    elif btype == "mamba":
        p["mamba"] = mamba_lib.mamba_init(gen, cfg.d_model, cfg.ssm, **kw)
    elif btype == "slstm":
        p["cell"] = xlstm_lib.slstm_init(gen, cfg.d_model, cfg.num_heads, cfg.xlstm, **kw)
    elif btype == "mlstm":
        p["cell"] = xlstm_lib.mlstm_init(gen, cfg.d_model, cfg.num_heads, cfg.xlstm, **kw)
    else:
        raise ValueError(btype)
    if _has_ffn(cfg, pos):
        p["norm2"] = layers.rmsnorm_init(gen, cfg.d_model, **kw)
        if _is_moe(cfg, pos):
            p["ffn"] = moe_lib.moe_init(gen, cfg.d_model, cfg.moe, gated=cfg.gated_mlp, **kw)
        else:
            p["ffn"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                       gated=cfg.gated_mlp, **kw)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, rcfg: RunConfig, *,
                device="cpu") -> dict:
    """Random parameters from ``gen`` (which must live on ``device``), with
    the JAX package's distributions and layouts.  ``gen=None`` with
    ``device="meta"`` gives shapes and dtypes and allocates nothing;
    ``gen=layers.AXES`` gives the logical axes (``param_logical_axes``)."""
    kw = dict(dtype=rcfg.param_dtype, device=device)
    params: dict = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model, **kw),
        "final_norm": layers.rmsnorm_init(gen, cfg.d_model, **kw),
        "lm_head": layers.dense_init(gen, (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                                     fan_in=cfg.d_model, **kw),
    }
    if cfg.frontend:
        params["frontend_proj"] = layers.dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), (None, "embed"),
            fan_in=cfg.frontend_dim, **kw)
    P = len(cfg.layer_pattern)
    params["blocks"] = [_block_init(gen, cfg, l % P, kw)
                        for l in range(cfg.num_layers)]
    return params


def param_logical_axes(cfg: ArchConfig, rcfg: RunConfig) -> dict:
    """The logical axes of every parameter: ``init_params``' tree with a
    tuple of axis names (or None) per dim in place of each tensor.  The JAX
    package stacks the blocks over pattern repeats and prefixes their axes
    with ``"layers"``; here each layer's dict has its own."""
    return init_params(layers.AXES, cfg, rcfg, device="meta")


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, rcfg: RunConfig, batch: int, max_seq: int, *,
               device="cpu") -> list:
    """One state dict per layer: k/v of (batch, max_seq, KV, hd) zeros in
    ``cache_dtype`` for an attention layer; for mamba the fp32 SSM state
    and the conv state in ``cache_dtype``; the sLSTM and mLSTM states in
    fp32 (``m`` at -1e30)."""
    P = len(cfg.layer_pattern)
    cache = []
    for l in range(cfg.num_layers):
        b = cfg.layer_pattern[l % P]
        if b == "attn":
            shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
            cache.append({"k": torch.zeros(shape, dtype=rcfg.cache_dtype, device=device),
                          "v": torch.zeros(shape, dtype=rcfg.cache_dtype, device=device)})
        elif b == "mamba":
            sh = mamba_lib.mamba_state_shapes(batch, cfg.d_model, cfg.ssm)
            cache.append({
                "ssm": torch.zeros(sh["ssm"], dtype=torch.float32, device=device),
                "conv": torch.zeros(sh["conv"], dtype=rcfg.cache_dtype, device=device)})
        elif b == "slstm":
            cache.append(xlstm_lib.slstm_init_state(batch, cfg.d_model, device=device))
        elif b == "mlstm":
            E = xlstm_lib._round64(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
            cache.append(xlstm_lib.mlstm_init_state(batch, cfg.num_heads,
                                                    E // cfg.num_heads, device=device))
        else:
            raise ValueError(b)
    return cache


def cache_logical_axes(cfg: ArchConfig) -> list:
    """Logical axes of ``init_cache``'s tree (for sharding specs): per
    layer, the JAX package's axes without its leading ``"layers"``."""
    P = len(cfg.layer_pattern)
    axes: list = []
    for l in range(cfg.num_layers):
        b = cfg.layer_pattern[l % P]
        if b == "attn":
            a = ("cache_batch", "cache_seq", "cache_heads", None)
            axes.append({"k": a, "v": a})
        elif b == "mamba":
            axes.append({"ssm": ("cache_batch", "inner", None),
                         "conv": ("cache_batch", None, "inner")})
        elif b == "slstm":
            a = ("cache_batch", None)
            axes.append({"c": a, "n": a, "h": a, "m": a})
        elif b == "mlstm":
            axes.append({"C": ("cache_batch", "heads", None, None),
                         "n": ("cache_batch", "heads", None),
                         "m": ("cache_batch", "heads")})
        else:
            raise ValueError(b)
    return axes


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _project(x, w, rules: AxisRules, heads_axis: str):
    """x (B,S,d) by w (d,h,k) -> (B,S,h,k), laid out (batch, seq,
    ``heads_axis``, head_dim).  The product runs over the flattened (h*k)
    columns, as ``einsum`` runs it, and the columns (of the weight, and so
    of its gradient) are laid out by the heads axis before they are split
    into heads: DTensor cannot split a dim that its shards cut across (4 KV
    heads over 16 ranks)."""
    B, S, d = x.shape
    _, h, k = w.shape
    w2 = rules.constrain(w.reshape(d, h * k), "embed", heads_axis)
    y = rules.constrain(x @ w2, "batch", "seq", heads_axis)
    return rules.constrain(y.view(B, S, h, k), "batch", "seq", heads_axis, "head_dim")


def _unproject(o, w, rules: AxisRules):
    """o (B,S,h,k) by w (h,k,d) -> (B,S,d), the product over the flattened
    (h*k) rows, laid out by the heads as ``_project``'s columns (einsum's
    own views of a gradient split over 16 ranks fail where 24 or 56 heads
    do not divide)."""
    B, S, h, k = o.shape
    o2 = rules.constrain(o.reshape(B, S, h * k), "batch", "seq", "heads")
    return o2 @ rules.constrain(w.reshape(h * k, w.shape[-1]), "heads", "embed")


def _attn_apply(p, x, cfg: ArchConfig, rcfg: RunConfig, *, positions,
                cache=None, t=None, build_cache=False):
    rules = rcfg.rules
    q = _project(x, p["wq"], rules, "heads")
    k = _project(x, p["wk"], rules, "kv_heads")
    v = _project(x, p["wv"], rules, "kv_heads")
    if cfg.rope:
        q = attn_lib.apply_rope(q, positions, cfg.rope_theta)
        k = attn_lib.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None:
        qk, qv = k, v
        if rcfg.attn_expand_kv:
            # laid out by the query heads: a head split over 'model' keeps
            # its own k/v heads (JAX's gqa_grouped=False)
            qk, qv = (rules.constrain(attn_lib.expand_kv(a, cfg.num_heads),
                                      "batch", "seq", "heads", "head_dim") for a in (k, v))
        o = attn_lib.flash_attention(q, qk, qv, causal=True, q_block=rcfg.q_block,
                                     kv_block=rcfg.kv_block)
        if build_cache:
            new_cache = {"k": k.to(rcfg.cache_dtype), "v": v.to(rcfg.cache_dtype)}
    else:
        if x.shape[1] != 1 or t is None:
            raise ValueError(f"decode takes one token per sequence at a position "
                             f"t; got {x.shape[1]} tokens, t={t}")
        kc, vc = cache["k"], cache["v"]
        kn, vn = k.to(kc.dtype), v.to(vc.dtype)
        with span("attn.decode"):
            if rcfg.decode_attn == "sharded":
                o, kc, vc = attn_lib.decode_attention_sharded(
                    q, kn, vn, kc, vc, t, mesh=rcfg.mesh, dp_axes=rcfg.dp_axes)
            elif rcfg.decode_attn == "local":
                o, kc, vc = attn_lib.decode_attention_local(q, kn, vn, kc, vc, t)
            else:
                raise ValueError(f"decode_attn must be local or sharded; "
                                 f"got {rcfg.decode_attn!r}")
        new_cache = {"k": kc, "v": vc}
    out = _unproject(o.to(x.dtype), p["wo"], rules)
    return rules.constrain(out, "batch", "seq", "embed_act"), new_cache


def _block_apply(p, x, cfg: ArchConfig, rcfg: RunConfig, pos: int, *,
                 positions, cache=None, t=None, build_cache=False):
    """Returns (x, aux_loss, new_cache)."""
    btype = cfg.layer_pattern[pos]
    # in an arch with blocks that loop over the sequence, every block takes
    # the residual and hands it (and its gradient) on in one layout, so what
    # a block costs does not depend on its neighbours (graph_cost.stack_cost
    # composes the stack from blocks traced apart, in stacks of other block
    # kinds, and extrapolates the recurrent ones in the length); other archs
    # compose exactly without these two redistributes a block, which cost a
    # DTensor step host time
    edge = cfg.ssm is not None or cfg.xlstm is not None
    if edge:
        x = rcfg.rules.constrain(x, "batch", "seq", "embed_act", grad=True)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    xn = layers.rmsnorm_apply(p["norm1"], x, eps=cfg.norm_eps)
    decode = cache is not None
    want_state = decode or build_cache
    new_cache = None
    if btype == "attn":
        h, new_cache = _attn_apply(p["attn"], xn, cfg, rcfg, positions=positions,
                                   cache=cache, t=t, build_cache=build_cache)
    elif btype == "mamba":
        with span("mamba.mixer"):
            if want_state:
                h, ssm, conv = mamba_lib.mamba_apply(
                    p["mamba"], xn, cfg.ssm, rcfg.rules,
                    ssm_state=cache["ssm"] if decode else None,
                    conv_state=cache["conv"] if decode else None, return_state=True,
                    norm_eps=cfg.norm_eps)
                new_cache = {"ssm": ssm, "conv": conv}
            else:
                h = mamba_lib.mamba_apply(p["mamba"], xn, cfg.ssm, rcfg.rules,
                                          norm_eps=cfg.norm_eps)
    elif btype == "slstm":
        if want_state:
            h, new_cache = xlstm_lib.slstm_apply(
                p["cell"], xn, cfg.num_heads, rcfg.rules, state=cache if decode else None,
                return_state=True)
        else:
            h = xlstm_lib.slstm_apply(p["cell"], xn, cfg.num_heads, rcfg.rules)
    elif btype == "mlstm":
        if want_state:
            h, new_cache = xlstm_lib.mlstm_apply(
                p["cell"], xn, cfg.num_heads, cfg.xlstm, rcfg.rules,
                state=cache if decode else None, return_state=True)
        else:
            h = xlstm_lib.mlstm_apply(p["cell"], xn, cfg.num_heads, cfg.xlstm, rcfg.rules)
    else:
        raise ValueError(btype)
    x = x + h
    if _has_ffn(cfg, pos):
        xn2 = layers.rmsnorm_apply(p["norm2"], x, eps=cfg.norm_eps)
        if _is_moe(cfg, pos):
            with span("moe.ffn"):
                y, aux = moe_lib.moe_apply(p["ffn"], xn2, cfg.moe, rcfg.rules,
                                           capacity_factor=rcfg.capacity_factor,
                                           group_size=rcfg.moe_group_size)
        else:
            y = layers.mlp_apply(p["ffn"], xn2, rcfg.rules)
        x = x + y
    if edge:
        x = rcfg.rules.constrain(x, "batch", "seq", "embed_act", grad=True)
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# Rematerialisation (training)
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products with no batch dimensions (``mm``,
    ``addmm``, and ``bmm`` over a batch of one, which is how ``einsum``
    runs a projection); recompute everything else.  The counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    if op in _DOTS or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _group_apply(group_params, x, cfg: ArchConfig, rcfg: RunConfig, positions):
    """One pattern group (``len(cfg.layer_pattern)`` consecutive layers) of
    the training forward: returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pos, bp in enumerate(group_params):
        x, aux_l, _ = _block_apply(bp, x, cfg, rcfg, pos, positions=positions)
        aux = aux + aux_l
    return x, aux


def _remat_layers(blocks, x, cfg: ArchConfig, rcfg: RunConfig, positions):
    """The layers of a training forward under ``rcfg.remat``, checkpointed
    per pattern group as the JAX package checkpoints its scanned group:
    ``full`` keeps only each group's input and recomputes the group in the
    backward; ``dots`` keeps the matrix products' outputs too.  Under
    either, the group's kernels run again in the backward."""
    if rcfg.remat == "full":
        kw = {}
    elif rcfg.remat == "dots":
        kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                              _dots_policy)}
    else:
        raise ValueError(f"remat must be none, full or dots; got {rcfg.remat!r}")
    P = len(cfg.layer_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g0 in range(0, len(blocks), P):
        x, aux_g = checkpoint(_group_apply, blocks[g0:g0 + P], x, cfg, rcfg, positions,
                              use_reentrant=False, **kw)
        aux = aux + aux_g
    return x, aux


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch, cfg: ArchConfig, rcfg: RunConfig):
    x = layers.embedding_lookup(params["embed"], batch["tokens"], rcfg.rules)
    if cfg.frontend:
        # laid out as the embedding: DTensor would leave the projection a
        # partial sum, which the first RMSNorm reduce-scatters over the
        # sequence, and the next product flattens into a strided shard
        fe = rcfg.rules.constrain(torch.einsum("bsf,fd->bsd", batch["embeds"].to(x.dtype),
                                               params["frontend_proj"]),
                                  "batch", "seq", "embed_act")
        x = x + fe
    return x.to(rcfg.compute_dtype)


def forward(params, batch, cfg: ArchConfig, rcfg: RunConfig, *,
            cache=None, t=None, build_cache=False, last_only=False):
    """Full forward.  ``cache`` None => prefill/train over (B, S); else a
    one-step decode at position ``t``: attention layers update their k/v
    in place, recurrent layers return new states.  ``build_cache`` makes
    the full-sequence pass also return each layer's decode state (serving
    prefill: k/v over the prompt, the recurrent state after it).
    ``last_only`` applies the final norm and LM head to the last position
    only, which is all prefill needs.  Returns (logits, aux_loss,
    new_cache); aux_loss sums the MoE load-balance losses."""
    x = _embed_inputs(params, batch, cfg, rcfg)
    S = x.shape[1]
    if cache is None:
        positions = torch.arange(S, device=x.device)
    else:
        positions = t + torch.arange(1, device=x.device)

    P = len(cfg.layer_pattern)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [] if (cache is not None or build_cache) else None
    if rcfg.remat != "none" and caches is None and torch.is_grad_enabled():
        x, aux = _remat_layers(params["blocks"], x, cfg, rcfg, positions)
    else:
        for l, bp in enumerate(params["blocks"]):
            c = cache[l] if cache is not None else None
            x, aux_l, nc = _block_apply(bp, x, cfg, rcfg, l % P, positions=positions,
                                        cache=c, t=t, build_cache=build_cache)
            aux = aux + aux_l
            if caches is not None:
                caches.append(nc)

    if last_only:
        x = x[:, -1:]
    x = layers.rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    logits = layers.lm_head_apply(params["lm_head"], x, rcfg.rules)
    return logits, aux, caches


def loss_fn(params, batch, cfg: ArchConfig, rcfg: RunConfig):
    """Next-token cross-entropy on ``batch["labels"]`` (masked by
    ``batch["mask"]`` when given) plus the weighted MoE aux loss.
    Returns (loss, {"ce", "moe_aux"})."""
    logits, aux, _ = forward(params, batch, cfg, rcfg)
    ce = layers.softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + rcfg.moe_aux_weight * aux, {"ce": ce, "moe_aux": aux}
