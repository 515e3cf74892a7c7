"""gemma3-12b [dense] — 5:1 local:global interleave, 128k context.

[hf:google/gemma-3-1b-pt family; unverified]  Assigned spec: 48L d_model=3840
16H (GQA kv=8) d_ff=15360 vocab=262144.  head_dim=256 per the public gemma3
configs (3840/16=240 is not MXU-lane aligned; noted in DESIGN.md)."""
import dataclasses

from ..models.config import ModelConfig

ARCH_ID = "gemma3-12b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=15360, vocab_size=262144,
        layer_pattern=("local", "local", "local", "local", "local", "full"),
        sliding_window=1024, rope_theta=1_000_000.0,
        embed_scale=True, tie_embeddings=True, mlp_type="glu",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, sliding_window=16, q_chunk=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
