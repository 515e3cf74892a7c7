"""chameleon-34b [vlm] — early-fusion, unified text+VQ-image vocabulary.

[arXiv:2405.09818; unverified]  Assigned spec: 48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536.  QK-norm per the public config (training-stability
fix).  The VQ image tokenizer is a STUB: inputs are token ids in the unified
vocab (image patches pre-tokenized by ``input_specs()``)."""
import dataclasses

from ..models.config import ModelConfig

ARCH_ID = "chameleon-34b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=65536,
        layer_pattern=("full",), qk_norm=True,
        tie_embeddings=False,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, q_chunk=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
