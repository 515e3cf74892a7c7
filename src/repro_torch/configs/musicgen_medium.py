"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf]  Assigned spec: 48L d_model=1536 24H (GQA kv=24 = MHA)
d_ff=6144 vocab=2048.  The EnCodec frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings; the 4-codebook delay
pattern is collapsed to a single stream with one 2048-way head (DESIGN.md)."""
import dataclasses

from ..models.config import ModelConfig

ARCH_ID = "musicgen-medium"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
        d_ff=6144, vocab_size=2048,
        layer_pattern=("full",), mlp_type="gelu",
        input_mode="embeddings", tie_embeddings=False,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, q_chunk=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
