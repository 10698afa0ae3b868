"""llava-next-34b — VLM backbone, anyres vision frontend stubbed
[hf:llava-hf].  input_specs() supplies 576 precomputed patch embeddings
prepended to the token sequence.
"""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    frontend="vision", frontend_seq=576,
    layer_pattern=(LayerKind("attn", "mlp"),),
    tie_embeddings=False,
    skip_shapes=(("long_500k", "pure full attention; 500k decode assigned "
                  "to sub-quadratic archs"),),
)
