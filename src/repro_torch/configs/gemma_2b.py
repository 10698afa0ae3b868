"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295]."""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    mlp_act="geglu", embed_scale=True,
    layer_pattern=(LayerKind("attn", "mlp"),),
    tie_embeddings=True,
    skip_shapes=(("long_500k", "pure full attention; 500k decode assigned "
                  "to sub-quadratic archs"),),
)
