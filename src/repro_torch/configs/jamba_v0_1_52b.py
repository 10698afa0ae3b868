"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  Period of 8: attention at slot 4, MoE on odd slots.
"""
from .base import LayerKind, ModelConfig

_PERIOD = tuple(
    LayerKind("attn" if i == 4 else "mamba",
              "moe" if i % 2 == 1 else "mlp")
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    num_experts=16, num_experts_per_tok=2, capacity_factor=1.25,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256, ssm_conv=4,
    layer_pattern=_PERIOD,
    tie_embeddings=False,
    # hybrid: long_500k runs (mamba layers O(1); 4 attn layers read paged KV)
)
