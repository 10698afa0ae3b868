"""Model/config schema (the port's own copy of ``repro.configs.base``).

A config fully determines the model graph; ``layer_pattern`` describes one
repeating *period* of heterogeneous layers.  The PyTorch port builds every
decoder of attention (global or sliding-window) with a dense or MoE FFN,
and whisper's encoder; Mamba mixers load as configs only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LayerKind:
    """One sub-layer slot in the repeating period."""
    mixer: str = "attn"       # attn | attn_local | mamba
    ffn: str = "mlp"          # mlp | moe | none (mamba blocks carry no FFN in mamba2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0           # tokens; used by attn_local layers
    attn_logit_softcap: float = 0.0
    pos_embedding: str = "rope"       # rope | absolute

    # ffn
    mlp_act: str = "silu"             # silu (SwiGLU) | geglu | gelu (plain)

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    # dispatch groups (GShard-style): 1 = global dispatch; set to the
    # data-parallel shard count so routing/scatter stays shard-local and
    # only the expert einsum crosses devices (all-to-all, not all-gather)
    moe_groups: int = 1

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # layer pattern: one period of sub-layers; model = pattern tiled over
    # num_layers (remainder layers reuse the pattern prefix)
    layer_pattern: Tuple[LayerKind, ...] = (LayerKind(),)

    # encoder-decoder / frontends
    encoder_layers: int = 0
    cross_attention: bool = False
    frontend: str = "none"            # none | audio | vision
    frontend_seq: int = 0             # stub frames/patches per example

    # misc
    tie_embeddings: bool = True
    norm: str = "rms"                 # rms | layer
    norm_eps: float = 1e-6
    embed_scale: bool = False         # gemma-style sqrt(d) embedding scale
    dtype: str = "bfloat16"

    # which assigned input shapes do not apply (with reason)
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    # ------------------------------------------------------------------ #
    @property
    def n_q(self) -> int:
        return self.num_heads

    @property
    def group(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def remainder_layers(self) -> int:
        return self.num_layers - self.num_periods * self.period

    def layer_kind(self, i: int) -> LayerKind:
        return self.layer_pattern[i % self.period]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        hd = self.head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        gate = 2 if self.mlp_act in ("silu", "geglu") else 1
        mlp = d * ff * gate + ff * d
        moe = (d * self.num_experts
               + self.num_experts * (d * ff * gate + ff * d))
        G = 1
        mamba = (d * (2 * self.d_inner + 2 * G * self.ssm_state + self.ssm_heads)
                 + self.d_inner * d
                 + self.ssm_conv * (self.d_inner + 2 * G * self.ssm_state)
                 + 3 * self.ssm_heads + self.d_inner)
        for i in range(self.num_layers):
            k = self.layer_kind(i)
            if k.mixer in ("attn", "attn_local"):
                total += attn
            elif k.mixer == "mamba":
                total += mamba
            if k.ffn == "mlp":
                total += mlp
            elif k.ffn == "moe":
                total += moe
            total += 2 * d  # norms
        if self.cross_attention:
            total += self.num_layers * attn
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        gate = 2 if self.mlp_act in ("silu", "geglu") else 1
        per_expert = d * ff * gate + ff * d
        inactive = 0
        for i in range(self.num_layers):
            if self.layer_kind(i).ffn == "moe":
                inactive += (self.num_experts - self.num_experts_per_tok) * per_expert
        return self.param_count() - inactive
