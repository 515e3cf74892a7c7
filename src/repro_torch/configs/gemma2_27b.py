"""gemma2-27b [dense] — local/global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]  Assigned spec: 46L d_model=4608 32H (GQA kv=16)
d_ff=36864 vocab=256000.  head_dim=128 per the public config; attn softcap
50.0, final softcap 30.0."""
import dataclasses

from ..models.config import ModelConfig

ARCH_ID = "gemma2-27b"


def full_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=36864, vocab_size=256000,
        layer_pattern=("local", "full"), sliding_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        embed_scale=True, tie_embeddings=True, mlp_type="glu",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        full_config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, sliding_window=16, q_chunk=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
