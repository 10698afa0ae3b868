"""gemma3-1b — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt].  Period of 6: five local layers then one
global; window 512.  26 layers = 4 periods + 2 local remainder.
"""
from .base import LayerKind, ModelConfig

_PERIOD = tuple(LayerKind("attn_local" if i < 5 else "attn", "mlp")
                for i in range(6))

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    sliding_window=512, mlp_act="geglu", embed_scale=True,
    layer_pattern=_PERIOD,
    tie_embeddings=True,
    # long_500k runs: local layers cap KV at the 512-token window; the
    # 1-in-6 global layers read the sequence-sharded 500k KV (decode is
    # linear in context, and window pruning drops 5/6 of the reads).
)
