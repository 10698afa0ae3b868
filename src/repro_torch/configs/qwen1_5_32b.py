"""qwen1.5-32b — MHA with QKV bias [hf:Qwen]."""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True,
    layer_pattern=(LayerKind("attn", "mlp"),),
    tie_embeddings=False,
    skip_shapes=(("long_500k", "pure full attention; 500k decode assigned "
                  "to sub-quadratic archs"),),
)
