"""Decoder LM stack (port of ``repro.models.transformer``) for every
attention config of ``repro``: dense, GQA and MQA attention with QKV bias,
sliding-window layers and softcap; SwiGLU, GeGLU and GELU FFNs and top-k
MoE; RMS or layer norm; embedding scale, absolute positions and untied
heads; whisper's encoder with cross attention and a VLM's prefix
embeddings; Mamba-2 mixers (``models/mamba.py``) alone (mamba2) or
interleaved with attention and MoE (jamba).

``Transformer`` holds the embedding, one ``DecoderLayer`` per layer in the
order ``repro.serving.engine.flat_layers`` flattens them (period-major,
then the remainder layers), the final norm, the untied head where the
config has one, and the encoder.  ``forward`` is the full-sequence
(prefill) pass; the decode engine calls ``embed_tokens``, the layers and
``unembed`` itself.  ``init_cache``, ``prefill`` and ``decode_step`` run a
dense head-major KV cache (and a Mamba layer's ``conv``/``ssm`` states):
the oracle the paged engine is held to.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import LayerKind, ModelConfig
from . import layers as L
from . import mamba as M

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Cache = List[Dict[str, torch.Tensor]]


def torch_dtype(cfg: ModelConfig, override=None) -> torch.dtype:
    if override is not None:
        return override
    return _DTYPES[cfg.dtype]


def _is_attn(kind: LayerKind) -> bool:
    return kind.mixer in ("attn", "attn_local")


class DecoderLayer(nn.Module):
    """One sub-layer: ``ln`` + attention (+ ``ln_x`` and ``xattn`` with
    cross attention) or the Mamba-2 mixer ``mamba``, then ``ln2`` + the
    FFN unless the kind has none."""

    def __init__(self, cfg: ModelConfig, kind: LayerKind, device=None,
                 dtype=None):
        super().__init__()
        self.kind = kind
        self.window = (cfg.sliding_window if kind.mixer == "attn_local"
                       else 0)
        kw = dict(device=device, dtype=dtype)
        self.ln = L.Norm(cfg.d_model, cfg, **kw)
        if _is_attn(kind):
            self.attn = L.Attention(cfg, **kw)
            if cfg.cross_attention:
                self.ln_x = L.Norm(cfg.d_model, cfg, **kw)
                self.xattn = L.Attention(cfg, **kw)
        elif kind.mixer == "mamba":
            self.mamba = M.Mamba2(cfg, **kw)
        if kind.ffn != "none":
            self.ln2 = L.Norm(cfg.d_model, cfg, **kw)
            self.ffn = (L.MoE(cfg, **kw) if kind.ffn == "moe"
                        else L.MLP(cfg, **kw))


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, LayerKind("attn", "mlp"), device=device,
                         dtype=dtype)
            for _ in range(cfg.encoder_layers))
        self.final_norm = L.Norm(cfg.d_model, cfg, device=device,
                                 dtype=dtype)


def embed_multiplier(cfg: ModelConfig, dtype: torch.dtype) -> float:
    """``sqrt(d_model)`` rounded to the weight dtype first, as ``repro``
    multiplies by ``jnp.asarray(np.sqrt(d), x.dtype)`` (at bf16, d = 1152
    gives 34.0, not 33.94)."""
    return float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg, dtype)
        kw = dict(device=device, dtype=dtype)
        self.embed = L._param((cfg.vocab_size, cfg.d_model), device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, cfg.layer_kind(i), **kw)
            for i in range(cfg.num_layers))
        self.final_norm = L.Norm(cfg.d_model, cfg, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        L._param((cfg.d_model, cfg.vocab_size), device,
                                 dtype))
        self.encoder = (Encoder(cfg, **kw) if cfg.encoder_layers else None)

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig,
                        state: Dict[str, torch.Tensor]) -> "Transformer":
        """Wrap existing tensors (no copy): the model lives where they do."""
        model = cls(cfg, device="meta", dtype=state["embed"].dtype)
        model.load_state_dict(state, assign=True)
        return model

    def embed_tokens(self, tokens: torch.Tensor,
                     positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Token embeddings, times ``sqrt(d_model)`` with ``embed_scale``,
        plus sinusoidal positions with absolute position embeddings."""
        cfg = self.cfg
        x = self.embed[tokens]
        if cfg.embed_scale:
            x = x * embed_multiplier(cfg, x.dtype)
        if cfg.pos_embedding == "absolute":
            half = cfg.d_model // 2
            freq = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                             device=x.device) / half)
            ang = positions[..., None].float() * freq
            pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
            x = x + pe.to(x.dtype)
        return x

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + the tied or untied head -> float32 logits."""
        x = L.apply_norm(self.final_norm, x, self.cfg)
        w = self.embed.T if self.lm_head is None else self.lm_head
        return (x @ w).float()

    def encode(self, encoder_embeds: torch.Tensor) -> torch.Tensor:
        """Bidirectional encoder over stubbed frontend embeddings."""
        cfg = self.cfg
        x = encoder_embeds.to(self.embed.dtype)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for lp in self.encoder.layers:
            h = L.apply_norm(lp.ln, x, cfg)
            y, _, _ = L.attn_full(lp.attn, cfg, h, positions, causal=False)
            x = x + y
            x = x + L.apply_mlp(lp.ffn, cfg, L.apply_norm(lp.ln2, x, cfg))
        return L.apply_norm(self.encoder.final_norm, x, cfg)

    def run(self, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            encoder_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False, collect_cache: bool = False,
            remat: bool = False,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
        """The full-sequence pass: ``(logits, moe_aux, cache | None)``.

        ``prefix_embeds`` (VLM stub) are prepended; logits cover only the
        token positions (``last_only``: the final position alone).
        ``encoder_embeds`` (audio stub) feed the encoder for cross
        attention.  ``cache``: per layer, its ``k``/``v`` (B, T, Hkv, hd)
        and, with cross attention, ``xk``/``xv``; a Mamba layer's
        ``conv``/``ssm`` states.  ``remat`` (training) recomputes each
        period of layers in the backward pass instead of keeping its
        activations, as ``repro`` checkpoints its scanned period; the
        remainder layers keep theirs."""
        cfg = self.cfg
        B, T = tokens.shape
        n_prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
        total = T + n_prefix
        dev = tokens.device
        positions = torch.arange(total, device=dev)[None].expand(B, total)
        x = self.embed_tokens(tokens, positions[:, n_prefix:])
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], 1)
        enc_out = (self.encode(encoder_embeds)
                   if self.encoder is not None and encoder_embeds is not None
                   else None)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        caches: Cache = []

        def period(x, aux, lo, hi):
            for layer in self.layers[lo:hi]:
                x, a, c = self._layer(layer, x, positions, enc_out)
                aux = aux + a
                if collect_cache:
                    caches.append(c)
            return x, aux

        P = cfg.period
        stacked = cfg.num_periods * P
        assert not (remat and collect_cache)
        for lo in range(0, stacked, P):
            if remat:
                x, aux = checkpoint(period, x, aux, lo, lo + P,
                                    use_reentrant=False)
            else:
                x, aux = period(x, aux, lo, lo + P)
        x, aux = period(x, aux, stacked, len(self.layers))
        x_out = x[:, -1:] if last_only else x[:, n_prefix:]
        return (self.unembed(x_out), aux,
                caches if collect_cache else None)

    def _layer(self, layer: DecoderLayer, x: torch.Tensor,
               positions: torch.Tensor, enc_out: Optional[torch.Tensor],
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """One sub-layer over the full sequence: ``(x, moe_aux, cache)``."""
        cfg = self.cfg
        c: Dict[str, torch.Tensor] = {}
        h = L.apply_norm(layer.ln, x, cfg)
        if layer.kind.mixer == "mamba":
            y, (c["conv"], c["ssm"]) = M.mamba_forward(layer.mamba, cfg, h)
        else:
            y, c["k"], c["v"] = L.attn_full(layer.attn, cfg, h, positions,
                                            causal=True, window=layer.window)
        x = x + y
        if (_is_attn(layer.kind) and cfg.cross_attention
                and enc_out is not None):
            hx = L.apply_norm(layer.ln_x, x, cfg)
            ek, ev = L.cross_kv(layer.xattn, cfg, enc_out)
            x = x + L.cross_attn_full(layer.xattn, cfg, hx, ek, ev)
            c["xk"], c["xv"] = ek, ev
        x, a = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)
        return x, a, c

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                encoder_embeds: Optional[torch.Tensor] = None,
                last_only: bool = False) -> torch.Tensor:
        """Full-sequence causal pass. tokens (B, T) -> logits (B, T, V)."""
        return self.run(tokens, prefix_embeds, encoder_embeds,
                        last_only)[0]


# --------------------------------------------------------------------- #
# dense decode cache (the paged engine's oracle)
# --------------------------------------------------------------------- #
def init_cache(model: Transformer, batch: int, max_len: int,
               enc_len: int = 0) -> Cache:
    """A zero dense cache in the weights' dtype, one dict a layer:
    head-major ``k``/``v`` (B, Hkv, max_len, hd) and, with cross
    attention, ``xk``/``xv``; a Mamba layer's float32 ``conv`` (B, K-1,
    conv_dim) and ``ssm`` (B, H, P, S) instead."""
    cfg = model.cfg
    dtype = model.embed.dtype
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    xshape = (batch, cfg.num_kv_heads, enc_len, cfg.head_dim)
    kw = dict(dtype=dtype, device=model.embed.device)
    cache: Cache = []
    for layer in model.layers:
        if layer.kind.mixer == "mamba":
            conv, ssm = M.zero_state(cfg, batch, model.embed.device)
            cache.append({"conv": conv, "ssm": ssm})
            continue
        c = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
        if cfg.cross_attention:
            c["xk"] = torch.zeros(xshape, **kw)
            c["xv"] = torch.zeros(xshape, **kw)
        cache.append(c)
    return cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, max_len: int,
            prefix_embeds=None, encoder_embeds=None,
            ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Process the full prompt; returns ``(last_logits, cache,
    cache_len)``."""
    B, T = tokens.shape
    logits, _, col = model.run(tokens, prefix_embeds, encoder_embeds,
                               collect_cache=True)
    enc_len = encoder_embeds.shape[1] if encoder_embeds is not None else 0
    cache = init_cache(model, B, max_len, enc_len)
    total = T + (0 if prefix_embeds is None else prefix_embeds.shape[1])
    for dst, src in zip(cache, col):
        if "ssm" in dst:
            for key in ("conv", "ssm"):
                dst[key] = src[key].to(dst[key].dtype)
            continue
        for key in ("k", "v"):
            dst[key][:, :, :total] = src[key].transpose(1, 2).to(
                dst[key].dtype)
        for key in ("xk", "xv"):
            if key in dst and key in src:
                dst[key] = src[key].transpose(1, 2).to(dst[key].dtype)
    cache_len = torch.full((B,), total, dtype=torch.int64,
                           device=tokens.device)
    return logits[:, -1], cache, cache_len


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor, cache: Cache,
                cache_len: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens: (B, 1); cache_len: (B,) tokens already
    cached (the new token's KV is written at index cache_len, in place;
    a Mamba layer's states are replaced by the stepped ones).
    Returns ``(logits (B, V), cache)``."""
    cfg = model.cfg
    B = tokens.shape[0]
    pos = cache_len[:, None]
    x = model.embed_tokens(tokens, pos)
    bidx = torch.arange(B, device=tokens.device)
    for layer, c in zip(model.layers, cache):
        h = L.apply_norm(layer.ln, x, cfg)
        if layer.kind.mixer == "mamba":
            y, (c["conv"], c["ssm"]) = M.mamba_decode(
                layer.mamba, cfg, h, c["conv"], c["ssm"])
            x, _ = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x + y)
            continue
        q, k_new, v_new = L.attn_project(layer.attn, cfg, h, pos)
        c["k"][bidx, :, cache_len] = k_new[:, 0].to(c["k"].dtype)
        c["v"][bidx, :, cache_len] = v_new[:, 0].to(c["v"].dtype)
        Lc = c["k"].shape[2]
        kv_pos = torch.arange(Lc, device=x.device)[None].expand(B, Lc)
        o = L.mha(q, c["k"], c["v"], causal=True, window=layer.window,
                  softcap=cfg.attn_logit_softcap, q_positions=pos,
                  kv_positions=kv_pos, kv_valid=kv_pos <= pos, q_chunk=1,
                  kv_layout="bhld")
        x = x + L.dense(layer.attn.wo,
                        o.reshape(B, 1, cfg.num_heads * cfg.head_dim))
        if cfg.cross_attention and "xk" in c:
            hx = L.apply_norm(layer.ln_x, x, cfg)
            x = x + L.cross_attn_full(layer.xattn, cfg, hx, c["xk"],
                                      c["xv"], kv_layout="bhld")
        x, _ = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)
    return model.unembed(x)[:, 0], cache


# --------------------------------------------------------------------- #
# random weights
# --------------------------------------------------------------------- #
def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                      str]]:
    """Every parameter's shape and initialiser, by state-dict name:
    ``"normal"`` (``N(0, 1/fan_in)`` with fan_in = ``shape[0]``, as
    ``repro``'s ``_init`` takes it, so E for the expert weights),
    ``"embed"`` (``N(0, 1/d_model)``), ``"router"`` (normal, float32),
    ``"ones"`` or ``"zeros"`` (``"ones32"``/``"zeros32"``: float32 at
    any weight dtype, a Mamba mixer's ``A_log``, ``D`` and ``dt_bias``)."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    gate = L._gate(cfg)
    E, ff = cfg.num_experts, cfg.d_ff
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def norm(pre):
        out[pre + "scale"] = ((d,), "ones")
        if cfg.norm == "layer":
            out[pre + "bias"] = ((d,), "zeros")

    def attn(pre):
        for w, n_out in (("wq", hq * hd), ("wk", hkv * hd),
                         ("wv", hkv * hd)):
            out[pre + f"{w}.w"] = ((d, n_out), "normal")
            if cfg.qkv_bias:
                out[pre + f"{w}.b"] = ((n_out,), "zeros")
        out[pre + "wo.w"] = ((hq * hd, d), "normal")

    def mamba(pre):
        d_in, S, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = d_in + 2 * S
        out[pre + "in_proj.w"] = ((d, 2 * d_in + 2 * S + H), "normal")
        out[pre + "conv_w"] = ((cfg.ssm_conv, conv_dim), "normal")
        out[pre + "conv_b"] = ((conv_dim,), "zeros")
        out[pre + "A_log"] = ((H,), "zeros32")
        out[pre + "D"] = ((H,), "ones32")
        out[pre + "dt_bias"] = ((H,), "zeros32")
        out[pre + "norm"] = ((d_in,), "ones")
        out[pre + "out_proj.w"] = ((d_in, d), "normal")

    def sublayer(pre, kind):
        norm(pre + "ln.")
        if kind.mixer == "mamba":
            mamba(pre + "mamba.")
        if _is_attn(kind):
            attn(pre + "attn.")
            if cfg.cross_attention:
                norm(pre + "ln_x.")
                attn(pre + "xattn.")
        if kind.ffn == "none":
            return
        norm(pre + "ln2.")
        if kind.ffn == "moe":
            out[pre + "ffn.router"] = ((d, E), "router")
            out[pre + "ffn.wi"] = ((E, d, gate * ff), "normal")
            out[pre + "ffn.wo"] = ((E, ff, d), "normal")
        else:
            out[pre + "ffn.wi.w"] = ((d, gate * ff), "normal")
            out[pre + "ffn.wo.w"] = ((ff, d), "normal")

    out["embed"] = ((cfg.vocab_size, d), "embed")
    norm("final_norm.")
    for i in range(cfg.num_layers):
        sublayer(f"layers.{i}.", cfg.layer_kind(i))
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.vocab_size), "normal")
    for i in range(cfg.encoder_layers):
        sublayer(f"encoder.layers.{i}.", LayerKind("attn", "mlp"))
    if cfg.encoder_layers:
        norm("encoder.final_norm.")
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> Dict[str, torch.Tensor]:
    """Random weights with ``repro.models.transformer.init_params``'s
    distributions (``param_shapes``), drawn in float32 from ``generator``
    (which must live on ``device``), then cast; the router stays float32.
    The two packages draw different numbers from one seed; tests share
    weights through ``weights.py``."""
    dtype = torch_dtype(cfg, dtype)
    state = {}
    for name, (shape, kind) in param_shapes(cfg).items():
        if kind in ("ones", "zeros", "ones32", "zeros32"):
            fill = torch.ones if kind.startswith("ones") else torch.zeros
            state[name] = fill(shape, device=device,
                               dtype=(torch.float32 if kind.endswith("32")
                                      else dtype))
            continue
        scale = (cfg.d_model ** -0.5 if kind == "embed"
                 else 1.0 / math.sqrt(shape[0]))
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        x.mul_(scale)
        state[name] = x if kind == "router" else x.to(dtype)
        del x
    return state


def build_model(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """A ``Transformer`` with seeded random weights, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return Transformer.from_state_dict(
        cfg, init_params(cfg, gen, device=device, dtype=dtype))
