"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

One 8-layer period holds 1 attention + 7 Mamba blocks; every other layer's
FFN is MoE (16 experts, top-2), the rest are dense MLPs — 9 periods = 72
layers.  Params check out at ~398B total / ~95B active (see configs/base.py
param_counts and tests/test_configs.py).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

JAMBA15_LARGE_398B = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        layer_pattern=(
            "mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba",
        ),
        ffn_on="all",
        moe_layer_indices=(1, 3, 5, 7),
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            expert_d_ff=24576,
            sharding="ep",  # 16 experts / 16-way model axis = 1 per group
        ),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
        subquadratic=True,  # 1:7 attn:mamba => long_500k cell runs
        source="arXiv:2403.19887",
    )
)
