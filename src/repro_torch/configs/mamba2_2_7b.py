"""mamba2-2.7b — SSD, attention-free [arXiv:2405.21060]."""
from .base import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256, ssm_conv=4,
    layer_pattern=(LayerKind("mamba", "none"),),
    tie_embeddings=True,
    # attention-free: every shape runs; decode is an O(1) state update.
)
