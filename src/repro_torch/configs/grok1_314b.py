"""grok-1-314b [moe] — 8 experts top-2.

[hf:xai-org/grok-1; unverified]  Assigned spec: 64L d_model=6144 48H (GQA
kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.  Expert count (8) does not divide
the 16-way model axis, so experts tensor-shard their d_ff instead
(shard_mode='ff'; DESIGN.md §5)."""
import dataclasses

from ..models.config import ModelConfig, MoEConfig

ARCH_ID = "grok-1-314b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=32768, vocab_size=131072,
        layer_pattern=("full",), attn_logit_softcap=30.0,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768,
                      shard_mode="ff"),
        tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, q_chunk=32,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                      shard_mode="ff", capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32", remat="none")
