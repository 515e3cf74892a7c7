"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  Assigned spec: 24L d_model=3840 32H (GQA kv=8)
d_ff=10240 vocab=32000, SWA."""
import dataclasses

from ..models.config import ModelConfig

ARCH_ID = "h2o-danube-3-4b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        d_ff=10240, vocab_size=32000,
        layer_pattern=("local",), sliding_window=4096,
        rope_theta=10000.0, tie_embeddings=False, mlp_type="glu",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, sliding_window=16, q_chunk=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
