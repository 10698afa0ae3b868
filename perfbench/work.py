"""The work of a decode step, counted from the traffic's own bookkeeping and
the configuration's widths, never from the program's plan: any
implementation is read against the same work.

A step decodes one token for each of its rows.  Row ``r`` sits on
document ``doc[r]`` (or none) and attends over ``ctx[r]`` positions: the
document, its own prompt tokens and its tokens so far, the new one
included.

* Attention bytes: every KV position the rows attend to, read once: a
  document once however many rows share it, and each row's own positions;
  the queries read and the outputs written, in the activation dtype; the
  new token's K and V written.  FLOPs: ``4 * heads * head_dim`` a row and
  context position.
* The whole step adds its weights, read once (the head whole, and with an
  untied head the embedding rows used), and ``2`` FLOPs a weight and row.

The least time is ``max(FLOPs / peak FLOP/s, bytes / peak bytes/s)``.  The
compute peak is bf16's dense rate, the highest a lossless implementation
could use, so a faster kernel cannot read above 100%.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

ACT_BYTES = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.flops + o.flops, self.bytes + o.bytes)

    def seconds(self, peak: dict) -> float:
        return max(self.flops / peak["bf16_flops"],
                   self.bytes / peak["hbm_bytes_per_s"])

    def bound_by(self, peak: dict) -> str:
        return ("compute" if self.flops / peak["bf16_flops"]
                > self.bytes / peak["hbm_bytes_per_s"] else "bandwidth")


def attention(cfg: dict, doc_lengths: Sequence[int],
              docs: Sequence[Optional[int]], ctx: Sequence[int]) -> Work:
    """The attention work of one step over every layer."""
    L = cfg["num_hidden_layers"]
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    kv = ACT_BYTES[cfg["serving"]["kv_dtype"]]
    act = ACT_BYTES[cfg["torch_dtype"]]
    shared = sum(doc_lengths[d] for d in {d for d in docs if d is not None})
    own = sum(c - (doc_lengths[d] if d is not None else 0)
              for d, c in zip(docs, ctx))
    rows = len(ctx)
    per_pos = 2 * hkv * hd * kv
    nbytes = L * ((shared + own) * per_pos          # K and V read
                  + rows * per_pos                  # the new K and V
                  + 2 * rows * hq * hd * act)       # q read, o written
    flops = L * 4 * hq * hd * sum(ctx)
    return Work(float(flops), float(nbytes))


def weights(cfg: dict) -> Dict[str, int]:
    """Weights a decode row reads: ``matrices`` (the layers' and the
    head's, 2 FLOPs a weight and row), ``vectors`` (biases and norm
    scales) and the embedding's size."""
    d, ff, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    L = cfg["num_hidden_layers"]
    vec = 2 * d + (hd * (hq + 2 * hkv) if cfg["attention_bias"] else 0)
    return {"matrices": L * (d * hd * (hq + 2 * hkv) + hq * hd * d
                             + 3 * d * ff) + d * V,
            "vectors": L * vec + d, "embed": V * d}


def step(cfg: dict, doc_lengths: Sequence[int],
         docs: Sequence[Optional[int]], ctx: Sequence[int]) -> Work:
    """The whole decode step's work."""
    act = ACT_BYTES[cfg["torch_dtype"]]
    w = weights(cfg)
    rows = len(ctx)
    nbytes = (w["matrices"] + w["vectors"]) * act
    if not cfg["tie_word_embeddings"]:
        nbytes += rows * cfg["hidden_size"] * act    # embedding rows used
    return attention(cfg, doc_lengths, docs, ctx) + Work(
        float(2 * w["matrices"] * rows), float(nbytes))
