"""qwen2.5-14b — GQA kv=8, QKV bias [hf:Qwen]."""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064,
    qkv_bias=True,
    layer_pattern=(LayerKind("attn", "mlp"),),
    tie_embeddings=False,
    skip_shapes=(("long_500k", "pure full attention; 500k decode assigned "
                  "to sub-quadratic archs"),),
)
