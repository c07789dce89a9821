"""Public kernel entry points, with the signatures of the JAX package's
``kernels/ops.py``.

For a CUDA tensor each one launches its hand-written kernel or raises; for
a CPU tensor it computes the plain PyTorch version in ``kernels.ref``.
Nothing falls back from one to the other.

Where autograd needs a gradient (grad mode on and an input that requires
one), the call goes through a ``torch.autograd.Function`` whose forward
launches the forward kernel (for attention with its row log-sum-exp) and
whose backward launches the hand-written backward kernel; on the CPU the
same Function runs the plain forward and the plain backward.  Otherwise
(serving, ``torch.no_grad``) the forward is called directly, as before.

The four kernels are also registered ops, ``torch.ops.repro_torch.*``
(``flash_attention`` with its lse output, ``flash_attention_bwd``,
``rmsnorm``, ``rmsnorm_bwd``): the CUDA implementation launches the same
hand-written kernel through the same wrapper, the CPU one computes the
plain version, the fake one gives shapes and dtypes (``meta`` and fake
tensors: ``make_fx`` traces each kernel as one node), a DTensor rule lets
a DTensor input call the kernel on its local shard, and the registered
autograd makes the backward op a node of a traced training step.  Only
DTensor, ``meta`` and fake tensors take that route; a plain CPU or CUDA
tensor takes the direct path above, which adds no dispatcher time to the
eager steps: hybrid and MoE decode, a cache's first dense decode step and
its capture (later dense steps replay CUDA graphs), prefill, training.

``decode_attention`` (one decode step against a preallocated k/v cache) has
no Pallas counterpart: the JAX package's is plain jnp.  A plain CUDA tensor
launches the hand-written flash-decode kernel or raises.  Only tensors that
do no work on the card compute the plain version,
``kernels.ref.decode_attention_ref``, op by op: CPU tensors (a DTensor over
CPU shards too), ``meta`` tensors and fake tensors of a trace.  Any other
tensor on the card, such as a DTensor over CUDA shards, raises: it has no
sharding rule, and its caller runs the kernel on the local shards.  It is
not a registered op: the roofline walker and the dry-run
(``launch/dryrun.py``, ``make_fx`` on ``meta`` tensors) keep costing the
plain ops, as XLA costs the JAX package's jnp decode, so their counts do not
change.

``decode_proj`` (a decode step's weight products: few rows against a large
fp32 weight) has no Pallas counterpart either.  The models ask
``takes_decode_proj`` first and keep their plain ``@`` wherever it says no,
so it decides from what it can observe which products the weight-streaming
kernel runs: plain CUDA fp32 tensors, laid out as the kernel reads them,
at most ``decode_proj.MAX_ROWS`` rows, and no gradient wanted.  Prefill,
training, DTensor and mesh runs, ``meta`` and fake tensors, the CPU and
other dtypes keep ``@``.  It is not a registered op, for the same reason.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import decode_proj as _dp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels.ref import (decode_attention_ref, decode_proj_ref,
                                     flash_attention_bwd_ref,
                                     flash_attention_lse_ref, flash_attention_ref,
                                     rmsnorm_bwd_ref, rmsnorm_ref)


def _route(t: torch.Tensor, what: str) -> str:
    """``"cpu"`` or ``"cuda"`` for a plain tensor there (the direct path),
    ``"op"`` for a ``meta`` tensor or a tensor subclass (DTensor, a fake
    tensor of a trace): the registered op."""
    if type(t) is torch.Tensor:
        dev = t.device.type
        if dev == "cpu" or dev == "cuda":
            return dev
        if dev == "meta":
            return "op"
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return "op"


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cuda":
            # the tensors the kernel read, so the backward reads the same
            q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
            o, lse = _fa.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        else:
            o = flash_attention_ref(q, k, v, causal=causal)
            lse = flash_attention_lse_ref(q, k, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()  # e.g. from the einsum of the output projection
        if q.device.type == "cuda":
            dq, dk, dv = _fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      causal=ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=ctx.causal)
        return dq, dk, dv, None


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        if x.device.type == "cuda":
            y = _rms.rmsnorm_cuda(x, scale, eps=eps)
        else:
            y = rmsnorm_ref(x, scale, eps=eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cuda":
            dx, dscale = _rms.rmsnorm_bwd_cuda(x, scale, dy, eps=ctx.eps)
        else:
            dx, dscale = rmsnorm_bwd_ref(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 128,
                    kv_block: int = 128):
    """GQA attention (B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd).

    ``q_block`` and ``kv_block`` are the TPU kernel's tile sizes, kept so
    callers are interchangeable.  The Hopper kernel tiles by its own design
    (16 folded query rows per warp, 32-key tiles) and takes any Sq and Sk,
    and the result does not depend on the block sizes beyond rounding.
    """
    if q_block < 1 or kv_block < 1:
        raise ValueError(f"block sizes must be positive: {q_block}, {kv_block}")
    route = _route(q, "flash_attention")
    if route == "op":
        ensure_sharding_rules()
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, q_block, kv_block)[0]
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    if route == "cuda":
        return _fa.flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)


def rmsnorm(x, scale, *, eps: float = 1e-5, row_block: int = 256):
    """RMSNorm of x (..., d) with scale (d,).  ``row_block`` is the TPU
    kernel's row tile, kept for the same reason; the Hopper kernel normalises
    one row per thread block."""
    if row_block < 1:
        raise ValueError(f"row_block must be positive: {row_block}")
    route = _route(x, "rmsnorm")
    if route == "op":
        ensure_sharding_rules()
        return torch.ops.repro_torch.rmsnorm(x, scale, eps)
    if _wants_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    if route == "cuda":
        return _rms.rmsnorm_cuda(x, scale, eps=eps)
    return rmsnorm_ref(x, scale, eps=eps)


def decode_attention(q, k_new, v_new, k_cache, v_cache, t: int, *, t_device=None):
    """One decode step of q (B,1,H,hd) against caches (B,S,KV,hd): k_new and
    v_new (B,1,KV,hd) written into the caches at position ``t`` in place,
    positions ``<= t`` attended.  Returns (out (B,1,H,hd), k_cache,
    v_cache).  The kernel for a plain CUDA tensor, the plain version for a
    tensor that does no work on the card; raises on any other.
    ``t_device`` (a one-element int64 tensor holding ``t``) is where the
    kernel reads t (``decode_attention_cuda``); the plain version, which
    launches nothing, takes ``t``."""
    tensors = (q, k_new, v_new, k_cache, v_cache)
    if _route(q, "decode_attention") == "cuda":
        return _da.decode_attention_cuda(*tensors, t, t_device=t_device)
    for x in tensors:
        if x.device.type == "cuda" and not is_fake(x):
            raise ValueError(f"decode_attention: no kernel for a {type(x).__name__} on "
                             f"{x.device}; call it on the local shards")
    return decode_attention_ref(*tensors, t)


def takes_decode_proj(x, *ws, transposed: bool = False) -> bool:
    """Whether the weight-streaming kernel takes ``x @ w`` for each weight
    (``x @ w.T`` where ``transposed``; ``kernels.decode_proj`` says how a
    weight is read): every tensor a plain fp32 CUDA tensor on one device,
    contiguous, each weight on the 16-byte grid, K and each N multiples of
    4, 1 to ``MAX_ROWS`` rows of x, and no gradient wanted."""
    if _route(x, "decode_proj") != "cuda" or x.dtype != torch.float32 or x.dim() < 1:
        return False
    K = x.shape[-1]
    if K < 4 or K % 4 or not 1 <= x.numel() // K <= _dp.MAX_ROWS or not x.is_contiguous():
        return False
    for w in ws:
        if (_route(w, "decode_proj") != "cuda" or w.dtype != torch.float32
                or w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16):
            return False
        n = _dp.matrix_cols(w, K, transposed)
        if not n or n % 4:
            return False
    return not _wants_grad(x, *ws)


def decode_proj(x, *ws, transposed: bool = False, gated: bool = False) -> tuple:
    """``x @ w`` for each of 1-3 weights in one launch, or, where ``gated``,
    ``silu(x @ w_gate) * (x @ w_in)`` for ``ws = (w_in, w_gate)``; each
    output (..., N) (``kernels.decode_proj.decode_proj_cuda``).  A plain CUDA
    tensor launches the kernel or raises; any other computes the plain
    version.  Callers ask ``takes_decode_proj`` first."""
    if _route(x, "decode_proj") == "cuda":
        return _dp.decode_proj_cuda(x, *ws, transposed=transposed, gated=gated)
    return decode_proj_ref(x, *ws, transposed=transposed, gated=gated)


# ---------------------------------------------------------------------------
# The registered ops
# ---------------------------------------------------------------------------
#
# ``q_block`` and ``kv_block`` ride along in the attention ops' signatures
# although the kernel ignores them: the roofline walker pads the sequence
# lengths to them, as the JAX model's blocked attention computes its
# masked blocks (``roofline/graph_cost.py``).


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        q_block: int, kv_block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (B,Sq,H,hd) in q's dtype, lse (B,H,Sq) fp32)."""
    if q.device.type == "cuda":
        return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                        causal=causal, return_lse=True)
    # contiguous, as the kernel writes them (DTensor views its local
    # results by the fake implementation's strides)
    return (flash_attention_ref(q, k, v, causal=causal).contiguous(),
            flash_attention_lse_ref(q, k, causal=causal).contiguous())


@_flash_attention_op.register_fake
def _(q, k, v, causal, q_block, kv_block):
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                            causal: bool, q_block: int, kv_block: int
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each in its input's dtype."""
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    if q.device.type == "cuda":
        return _fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    return tuple(t.contiguous() for t in flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                                causal=causal))


@_flash_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, q_block, kv_block):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, q_block, kv_block = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = (causal, q_block, kv_block)


def _flash_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, lse, do, *ctx.args)
    return dq, dk, dv, None, None, None


_flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cuda":
        return _rms.rmsnorm_cuda(x.contiguous(), scale, eps=eps)
    return rmsnorm_ref(x, scale, eps=eps).contiguous()


@_rmsnorm_op.register_fake
def _(x, scale, eps):
    return x.new_empty(x.shape)


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def _rmsnorm_bwd_op(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale in scale's)."""
    x, dy = x.contiguous(), dy.contiguous()
    if x.device.type == "cuda":
        return _rms.rmsnorm_bwd_cuda(x, scale, dy, eps=eps)
    return tuple(t.contiguous() for t in rmsnorm_bwd_ref(x, scale, dy, eps=eps))


@_rmsnorm_bwd_op.register_fake
def _(x, scale, dy, eps):
    return x.new_empty(x.shape), scale.new_empty(scale.shape)


def _rmsnorm_setup(ctx, inputs, output):
    x, scale, eps = inputs
    ctx.save_for_backward(x, scale)
    ctx.eps = eps


def _rmsnorm_backward(ctx, dy):
    x, scale = ctx.saved_tensors
    dx, dscale = torch.ops.repro_torch.rmsnorm_bwd(x, scale, dy, ctx.eps)
    return dx, dscale, None


_rmsnorm_op.register_autograd(_rmsnorm_backward, setup_context=_rmsnorm_setup)


def _register_sharding() -> None:
    """DTensor rules, one mesh dim at a time (DTensor expands them over
    the mesh): attention on the batch dim, or on the heads when q and k/v
    have as many heads (``RunConfig.attn_expand_kv``: then every shard of
    query heads holds its own k/v heads); RMSNorm on any dim but the last,
    its dscale a partial sum over the row shards.  Every other layout is
    replicated first.  Importing ``torch.distributed.tensor`` costs about
    a second, so this runs when the first DTensor reaches an op."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R = Replicate()

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, q_block, kv_block):
        rules = [([R, R], [R, R, R, None, None, None]),
                 ([Shard(0), Shard(0)], [Shard(0)] * 3 + [None] * 3)]
        if q.shape[2] == k.shape[2]:
            rules.append(([Shard(2), Shard(1)], [Shard(2)] * 3 + [None] * 3))
        return rules

    @register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
    def _(q, k, v, o, lse, do, causal, q_block, kv_block):
        rules = [([R] * 3, [R] * 6 + [None] * 3),
                 ([Shard(0)] * 3, [Shard(0)] * 6 + [None] * 3)]
        if q.shape[2] == k.shape[2]:
            rules.append(([Shard(2)] * 3, [Shard(2)] * 4 + [Shard(1), Shard(2)] + [None] * 3))
        return rules

    @register_sharding(torch.ops.repro_torch.rmsnorm.default)
    def _(x, scale, eps):
        return [([R], [R, R, None])] + [([Shard(d)], [Shard(d), R, None])
                                        for d in range(x.ndim - 1)]

    @register_sharding(torch.ops.repro_torch.rmsnorm_bwd.default)
    def _(x, scale, dy, eps):
        return [([R, R], [R, R, R, None])] + [([Shard(d), Partial()], [Shard(d), R, Shard(d), None])
                                              for d in range(x.ndim - 1)]


def ensure_sharding_rules() -> None:
    """Register the DTensor rules of the four ops (once; idempotent)."""
    global _SHARDING_REGISTERED
    if not _SHARDING_REGISTERED:
        _register_sharding()
        _SHARDING_REGISTERED = True


_SHARDING_REGISTERED = False


def launch_counts() -> dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    _build.LAUNCHES.update(dict.fromkeys(_build.LAUNCHES, 0))
