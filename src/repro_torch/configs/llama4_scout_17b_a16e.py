"""llama4-scout-17b-16e — MoE top-1, early fusion [hf:meta-llama]."""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=16, num_experts_per_tok=1, capacity_factor=1.25,
    layer_pattern=(LayerKind("attn", "moe"),),
    tie_embeddings=False,
    skip_shapes=(("long_500k", "full attention (iRoPE chunking not "
                  "modelled); 500k decode assigned to sub-quadratic archs"),),
)
