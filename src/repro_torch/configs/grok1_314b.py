"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

8 experts < 16-way model axis, so expert-parallelism over 'model' is not
divisible: each expert's d_ff is tensor-parallel-sharded instead
(``sharding="tp"``; see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

GROK1_314B = register(
    ArchConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            expert_d_ff=32768,
            sharding="tp",
        ),
        source="hf:xai-org/grok-1",
    )
)
