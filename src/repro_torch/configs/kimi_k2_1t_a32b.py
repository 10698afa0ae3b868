"""kimi-k2-1t-a32b — trillion-param MoE, 384e top-8 [arXiv:2501.kimi2].

Note: the real K2 uses one dense first layer; we model all 61 layers as
MoE (noted in DESIGN.md). head_dim=128 (64 heads project 7168->8192).
"""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    num_experts=384, num_experts_per_tok=8, capacity_factor=1.25,
    layer_pattern=(LayerKind("attn", "moe"),),
    tie_embeddings=False,
    skip_shapes=(("long_500k", "pure full attention; 500k decode assigned "
                  "only to sub-quadratic archs"),),
)
