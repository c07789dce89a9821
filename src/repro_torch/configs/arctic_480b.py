"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

ARCTIC_480B = register(
    ArchConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        moe=MoEConfig(
            num_experts=128,
            top_k=2,
            expert_d_ff=4864,
            dense_residual=True,
            dense_d_ff=4864,
            sharding="ep",  # 128 experts / 16-way model axis = 8 per group
        ),
        source="hf:Snowflake/snowflake-arctic-base",
    )
)
