"""Architecture configuration system.

Every assigned architecture is expressed as an ``ArchConfig``: a composable
decoder specification built from a repeating ``layer_pattern`` of block types
(``attn`` / ``mamba`` / ``slstm`` / ``mlstm``) with an optional MoE FFN.  The
port's model zoo (``repro_torch.models.model_zoo``) consumes this config to
build params + apply functions.

This is the port's own copy of the JAX package's ``configs/base.py`` (pure
data, no framework import); the two stay identical so both packages build
the same architectures, ``reduced()`` included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM-family arch is paired with all four.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

ALL_SHAPES: tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    # Which layers (index within the layer_pattern repeat group) carry MoE.
    # None => every FFN is MoE.
    dense_residual: bool = False  # arctic: dense MLP residual alongside MoE
    dense_d_ff: int = 0
    # "ep": shard expert dim over the model axis (experts % model_axis == 0)
    # "tp": shard each expert's d_ff over the model axis (few experts)
    sharding: str = "ep"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM block parameters."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """sLSTM/mLSTM block parameters (xLSTM, arXiv:2405.04517)."""

    proj_factor_slstm: float = 4.0 / 3.0
    proj_factor_mlstm: float = 2.0
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # Repeating pattern of block types; tiled to num_layers.
    # e.g. dense transformer: ("attn",); jamba: 1 attn : 7 mamba.
    layer_pattern: Sequence[str] = ("attn",)
    # Which pattern positions have an MoE FFN (indices into layer_pattern).
    moe_layer_indices: Sequence[int] = ()
    # FFN placement: "attn" = after attention blocks only (dense decoders);
    # "all" = after every block (jamba-style); "none" = blocks self-contained.
    ffn_on: str = "attn"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    head_dim: int = 0  # 0 => d_model // num_heads
    gated_mlp: bool = True  # SwiGLU (3 mats) vs classic up/down GELU (2 mats)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # vlm/audio: the modality frontend is a stub — inputs are precomputed
    # patch/frame embeddings of shape (B, S, frontend_dim).
    frontend: Optional[str] = None  # None | "vision_patches" | "audio_frames"
    frontend_dim: int = 0
    # True if attention is full/quadratic everywhere (=> skip long_500k).
    subquadratic: bool = False
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        assert self.num_layers % len(self.layer_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"pattern length {len(self.layer_pattern)}"
        )

    # -- derived quantities -------------------------------------------------

    @property
    def num_pattern_repeats(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def attn_layers(self) -> int:
        per = sum(1 for b in self.layer_pattern if b == "attn")
        return per * self.num_pattern_repeats

    def block_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for b in self.layer_pattern:
            out[b] = out.get(b, 0) + self.num_pattern_repeats
        return out

    def shapes(self) -> tuple[InputShape, ...]:
        """Input shapes applicable to this architecture."""
        out = []
        for s in ALL_SHAPES:
            if s is LONG_500K and not self.subquadratic:
                continue  # full-attention arch: 500k dense KV cache non-goal
            out.append(s)
        return tuple(out)

    def skipped_shapes(self) -> tuple[InputShape, ...]:
        return tuple(s for s in ALL_SHAPES if s not in self.shapes())

    # -- parameter counting (used for MODEL_FLOPS and roofline) -------------

    def param_counts(self) -> dict[str, float]:
        """Total and active (per-token) parameter counts."""
        d, hd = self.d_model, self.head_dim
        q_heads, kv_heads = self.num_heads, self.num_kv_heads
        per_block_total = {}
        per_block_active = {}
        for b in set(self.layer_pattern):
            if b == "attn":
                n = d * (q_heads * hd) + 2 * d * (kv_heads * hd) + (q_heads * hd) * d
                per_block_total[b] = per_block_active[b] = n + 2 * d  # + norms
            elif b == "mamba":
                assert self.ssm is not None
                e = self.ssm.expand * d
                dtr = self.ssm.dt_rank or -(-d // 16)
                n = (
                    d * 2 * e  # in_proj (x and z branches)
                    + e * self.ssm.conv_width  # depthwise conv
                    + e * (dtr + 2 * self.ssm.state_dim)  # x -> dt, B, C
                    + dtr * e  # dt_proj
                    + e * self.ssm.state_dim  # A
                    + e  # D
                    + e * d  # out_proj
                    + d  # norm
                )
                per_block_total[b] = per_block_active[b] = n
            elif b in ("slstm", "mlstm"):
                assert self.xlstm is not None
                if b == "mlstm":
                    e = int(self.xlstm.proj_factor_mlstm * d)
                    n = d * 2 * e + 3 * e * e // max(self.num_heads, 1) + e * d + 2 * d
                else:
                    e = int(self.xlstm.proj_factor_slstm * d)
                    n = 4 * d * d + 4 * d * d // max(self.num_heads, 1) + d * e + e * d + 2 * d
                per_block_total[b] = per_block_active[b] = n
            else:
                raise ValueError(b)
        # FFN (attached to attn blocks only, per decoder convention)
        moe_set = set(self.moe_layer_indices)
        ffn_total = ffn_active = 0.0
        for i, b in enumerate(self.layer_pattern):
            if self.ffn_on == "none":
                continue
            if self.ffn_on == "attn" and b != "attn":
                continue  # block embeds its own FFN-equivalent
            nmat = 3 if self.gated_mlp else 2
            if self.moe is not None and (not moe_set or i in moe_set):
                m = self.moe
                e_params = nmat * d * m.expert_d_ff
                ffn_total += m.num_experts * e_params + d * m.num_experts
                ffn_active += m.top_k * e_params + d * m.num_experts
                if m.dense_residual:
                    dn = nmat * d * (m.dense_d_ff or self.d_ff)
                    ffn_total += dn
                    ffn_active += dn
            elif self.d_ff > 0:
                n = nmat * d * self.d_ff
                ffn_total += n
                ffn_active += n
        reps = self.num_pattern_repeats
        total = reps * (
            sum(per_block_total[b] for b in self.layer_pattern) + ffn_total
        )
        active = reps * (
            sum(per_block_active[b] for b in self.layer_pattern) + ffn_active
        )
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += embed + d
        active += embed + d
        return {"total": float(total), "active": float(active)}

    def model_flops(self, shape: InputShape) -> float:
        """Useful model FLOPs for a step of the given shape.

        train: 6 * N_active * tokens ; prefill: 2 * N_active * tokens ;
        decode: 2 * N_active * batch (one token per sequence).
        """
        n_active = self.param_counts()["active"]
        if shape.kind == "train":
            return 6.0 * n_active * shape.seq_len * shape.global_batch
        if shape.kind == "prefill":
            return 2.0 * n_active * shape.seq_len * shape.global_batch
        return 2.0 * n_active * shape.global_batch

    # -- reduced config for CPU smoke tests ---------------------------------

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        pat = tuple(self.layer_pattern)
        n_layers = len(pat) if len(pat) > 1 else 2
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(2, self.moe.top_k),
                expert_d_ff=64, dense_d_ff=64 if self.moe.dense_residual else 0,
            )
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64 // heads if 64 % heads == 0 else 16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            moe=moe,
            frontend_dim=64 if self.frontend else 0,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # Import the per-arch modules for their registration side effects.
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        codeqwen15_7b,
        grok1_314b,
        jamba15_large_398b,
        musicgen_medium,
        pixtral_12b,
        stablelm_3b,
        starcoder2_15b,
        xlstm_350m,
        yi_9b,
    )
