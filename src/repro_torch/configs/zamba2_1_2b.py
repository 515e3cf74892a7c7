"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention block.

[arXiv:2411.15242; hf]  Assigned spec: 38L d_model=2048 32H (GQA kv=32 = MHA)
d_ff=8192 vocab=32000, ssm_state=64.  The shared transformer block (attention
+ MLP, one set of weights) is applied after every 6 SSM layers, per the Zamba2
scheme; the per-invocation LoRA deltas are omitted (DESIGN.md)."""
import dataclasses

from ..models.config import ModelConfig, SSMConfig

ARCH_ID = "zamba2-1.2b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        layer_pattern=("ssm",) * 6, shared_attn_every=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, layer_pattern=("ssm",) * 6,
        shared_attn_every=6, q_chunk=32,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        param_dtype="float32", compute_dtype="float32", remat="none")
