"""qwen3-4b — the paper's default evaluation model (§7.1): 32 query
heads, 8 KV heads, head_dim 128."""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936,
    layer_pattern=(LayerKind("attn", "mlp"),),
    tie_embeddings=True,
    skip_shapes=(("long_500k", "pure full attention; 500k decode assigned "
                  "to sub-quadratic archs"),),
)
