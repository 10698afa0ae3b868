"""Weights of a dense decoder, made by the benchmark on the device from the
seed, and handed alike to the program and to the reference.

The tensors are named as the port's ``Transformer`` state dict names them
(``layers.{i}.attn.wq.w``: ``(d_in, d_out)``, ``y = x @ w``; ``ffn.wi.w``
holds the gate's columns, then the up projection's).  Leaves of one
distribution are views into one flat buffer drawn by one call, so a
14.8 B-parameter model takes a handful of ``randn`` calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# norm scales are 1 + N(0, NORM_STD^2), biases N(0, BIAS_STD^2): not the
# published constants, so that a norm or bias read from the wrong place
# changes the logits
NORM_STD = 0.1
BIAS_STD = 0.1


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, group) of every weight: group ``"std:<s>"`` is
    N(0, s^2), ``"norm"`` 1 + N(0, NORM_STD^2), ``"bias"`` N(0,
    BIAS_STD^2)."""
    d = cfg["hidden_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, ff = cfg["head_dim"], cfg["intermediate_size"]
    vocab = cfg["vocab_size"]

    def normal(fan_in):
        return f"std:{1.0 / math.sqrt(fan_in)!r}"

    out = [("embed", (vocab, d), normal(d)), ("final_norm.scale", (d,),
                                              "norm")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out.append((p + "ln.scale", (d,), "norm"))
        for w, n in (("wq", hq * hd), ("wk", hkv * hd), ("wv", hkv * hd)):
            out.append((p + f"attn.{w}.w", (d, n), normal(d)))
            if cfg["attention_bias"]:
                out.append((p + f"attn.{w}.b", (n,), "bias"))
        out.append((p + "attn.wo.w", (hq * hd, d), normal(hq * hd)))
        out.append((p + "ln2.scale", (d,), "norm"))
        out.append((p + "ffn.wi.w", (d, 2 * ff), normal(d)))
        out.append((p + "ffn.wo.w", (ff, d), normal(ff)))
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, vocab), normal(d)))
    return out


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of ``cfg``, drawn from ``seed`` by a generator on
    ``device`` in the served dtype (``torch_dtype``)."""
    dtype = DTYPES[cfg["torch_dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups: Dict[str, List[Tuple[str, Tuple[int, ...]]]] = {}
    for name, shape, group in leaves(cfg):
        groups.setdefault(group, []).append((name, shape))
    out: Dict[str, torch.Tensor] = {}
    for group in sorted(groups):
        members = groups[group]
        total = sum(math.prod(s) for _, s in members)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        if group == "norm":
            flat.mul_(NORM_STD).add_(1.0)
        elif group == "bias":
            flat.mul_(BIAS_STD)
        else:
            flat.mul_(float(group.split(":", 1)[1]))
        off = 0
        for name, shape in members:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            off += n
    return out
