"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

The vision frontend is a stub per assignment: ``input_specs()`` provides
precomputed patch embeddings of shape (B, S, frontend_dim); the backbone
(specified here) projects and decodes them.
"""
from repro_torch.configs.base import ArchConfig, register

PIXTRAL_12B = register(
    ArchConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        frontend="vision_patches",
        frontend_dim=1024,  # pixtral ViT hidden size
        rope_theta=1_000_000_000.0,
        source="hf:mistralai/Pixtral-12B-2409",
    )
)
