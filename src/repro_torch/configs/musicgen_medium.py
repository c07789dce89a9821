"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

The EnCodec frontend is a STUB per assignment: ``input_specs()`` provides
precomputed frame embeddings (B, S, frontend_dim) — the sum of codebook
embeddings in the real system.  vocab_size=2048 is the codebook size the
output head predicts over.
"""
from repro_torch.configs.base import ArchConfig, register

MUSICGEN_MEDIUM = register(
    ArchConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        gated_mlp=False,
        frontend="audio_frames",
        frontend_dim=1536,
        source="arXiv:2306.05284",
    )
)
