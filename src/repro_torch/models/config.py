"""Model configuration for every assigned architecture family (the
reference's dataclasses; the dtypes are torch's)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # sharding strategy: 'expert' shards the expert dim over the model axis
    # (needs num_experts % axis == 0), 'ff' tensor-shards inside each expert
    shard_mode: str = "expert"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64           # Mamba2 P (channels per SSM head)
    chunk: int = 128             # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | hybrid | moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // num_heads
    # layer pattern, repeated to cover num_layers: entries 'full' | 'local' | 'ssm'
    layer_pattern: tuple = ("full",)
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mlp_type: str = "glu"                     # 'glu' (SwiGLU) | 'gelu'
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0                # zamba2: shared block period
    input_mode: str = "tokens"                # 'tokens' | 'embeddings'
    tie_embeddings: bool = True
    embed_scale: bool = False                 # gemma-style sqrt(d) scaling
    rms_eps: float = 1e-6
    # precision policy
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # attention chunking (memory-bounded prefill/training)
    q_chunk: int = 1024
    # remat policy: 'none' | 'block' (checkpoint each layer block)
    remat: str = "block"
    # which shapes support sub-quadratic long context (DESIGN.md table)
    supports_long_context: bool = False

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pattern_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def num_params_estimate(self) -> int:
        """Analytic parameter count (for 6ND roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd()
        n_attn_layers = sum(
            1 for i in range(self.num_layers)
            if self.pattern_for_layer(i) != "ssm")
        n_ssm_layers = self.num_layers - n_attn_layers
        attn = n_attn_layers * (
            d * hd * (self.num_heads + 2 * self.num_kv_heads)  # qkv
            + self.num_heads * hd * d)                          # out
        if self.moe:
            e = self.moe
            per_layer = (e.num_experts + e.num_shared_experts) \
                * 3 * d * e.d_ff_expert + d * e.num_experts
            mlp = self.num_layers * per_layer
        else:
            mult = 3 if self.mlp_type == "glu" else 2
            mlp = n_attn_layers * mult * d * self.d_ff
        if self.ssm:
            s = self.ssm
            d_in = s.expand * d
            per = (d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim)
                   + d_in * d)
            ssm = n_ssm_layers * per
        else:
            ssm = 0
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        norms = 2 * self.num_layers * d + d
        if self.shared_attn_every:
            shared = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d + (3 * d * self.d_ff if self.d_ff else 0)
        else:
            shared = 0
        return attn + mlp + ssm + embed + norms + shared

    def active_params_estimate(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.num_params_estimate()
        e = self.moe
        total = self.num_params_estimate()
        all_expert = self.num_layers * e.num_experts * 3 * self.d_model \
            * e.d_ff_expert
        active_expert = self.num_layers * (e.top_k + e.num_shared_experts) \
            * 3 * self.d_model * e.d_ff_expert
        return total - all_expert + active_expert
