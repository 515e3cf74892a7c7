"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  Assigned spec: 48L d_model=2048 16H
(GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.  DeepSeek-style shared
experts (2) kept; the first-layer-dense variant is simplified to uniform MoE
(DESIGN.md).  64 experts shard over the 16-way model axis (4/device)."""
import dataclasses

from ..models.config import ModelConfig, MoEConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        layer_pattern=("full",),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared_experts=2, shard_mode="expert"),
        tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=512, q_chunk=32,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared_experts=1, shard_mode="expert",
                      capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32", remat="none")
