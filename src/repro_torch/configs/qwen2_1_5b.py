"""qwen2-1.5b [dense] — GQA with QKV bias.

[arXiv:2407.10671; hf]  Assigned spec: 28L d_model=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936.  Pure full attention => long_500k skipped (DESIGN.md
§Arch-applicability)."""
import dataclasses

from ..models.config import ModelConfig

ARCH_ID = "qwen2-1.5b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151936,
        layer_pattern=("full",), qkv_bias=True,
        rope_theta=1_000_000.0, tie_embeddings=True, mlp_type="glu",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, q_chunk=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
