"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  Assigned spec: 48L d_model=1024 (attn-free)
d_ff=0 vocab=50280, ssm_state=128."""
import dataclasses

from ..models.config import ModelConfig, SSMConfig

ARCH_ID = "mamba2-370m"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=48, d_model=1024, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=50280,
        layer_pattern=("ssm",),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
        tie_embeddings=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        param_dtype="float32", compute_dtype="float32", remat="none")
