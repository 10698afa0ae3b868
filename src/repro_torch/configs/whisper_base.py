"""whisper-base — encoder-decoder with audio frontend stub
[arXiv:2212.04356].  6 encoder + 6 decoder layers; the conv/mel frontend
is stubbed: input_specs() supplies 1500 precomputed frame embeddings.
"""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    encoder_layers=6, cross_attention=True,
    frontend="audio", frontend_seq=1500,
    pos_embedding="absolute", norm="layer", mlp_act="gelu",
    layer_pattern=(LayerKind("attn", "mlp"),),
    tie_embeddings=True,
    skip_shapes=(("long_500k", "pure full attention decoder; 500k decode "
                  "assigned to sub-quadratic archs"),),
)
