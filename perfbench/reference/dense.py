"""Plain PyTorch reference of a dense decoder with grouped-query attention
(Qwen2 / Qwen3 as the port runs them: RMS norm, half-split RoPE, q/k/v
projections with optional bias, SwiGLU, a tied or untied head), in
float32 with TF32 off.

It imports nothing of the program.  It takes the weights the benchmark
made (bfloat16, upcast here leaf by leaf as each layer runs, so it fits
beside them) and the token ids, and works out every key and value itself.
Departures from the published models are the configuration file's
``departures``: this reference follows the configuration as it is run.

``quantize="fp8"`` is the control, every product computed in float8 e4m3,
the step below the configuration's bfloat16: each weight matrix (the
embedding and the head too) rounded with one scale an output column, and
each product's activations with one scale a row (token), as an fp8
deployment runs its GEMMs; attention and the norms stay float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch

# rows of queries a block of attention scores holds, against the keys'
# length and the heads: about 2^28 float32 scores (1 GiB) a block
_SCORE_ELEMS = 1 << 28
# rows a block of the FFN and the head takes
_ROWS = 2048


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32, restored on exit."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """``w`` (d_in, d_out) rounded to float8 e4m3 with one scale a column,
    returned in float32."""
    w = w.float()
    scale = w.abs().amax(0, keepdim=True).clamp(min=1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (n, d) rounded to float8 e4m3 with one scale a row."""
    return fp8_columns(x.T).T


class Dense:
    """The model of ``cfg`` (a configuration file's dict) over ``weights``
    (named as ``perfbench/weights.py`` names them)."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 quantize: Optional[str] = None):
        if quantize not in (None, "fp8"):
            raise ValueError(f"unknown quantize {quantize!r}")
        self.cfg = cfg
        self.w = weights
        self.quantize = quantize
        self.d = cfg["hidden_size"]
        self.hq = cfg["num_attention_heads"]
        self.hkv = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.ff = cfg["intermediate_size"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.device = weights["embed"].device

    # ---- weights ---------------------------------------------------- #
    def mat(self, name: str) -> torch.Tensor:
        w = self.w[name]
        return fp8_columns(w) if self.quantize else w.float()

    def vec(self, name: str) -> Optional[torch.Tensor]:
        w = self.w.get(name)
        return None if w is None else w.float()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w``; the control rounds ``x`` too (``w`` is rounded by
        ``mat``)."""
        return (fp8_rows(x) if self.quantize else x) @ w

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.quantize:   # the embedding's rows are its output columns
            return fp8_columns(self.w["embed"][tokens].T).T
        return self.w["embed"][tokens].float()

    def head(self) -> torch.Tensor:
        if self.cfg["tie_word_embeddings"]:
            e = self.w["embed"]
            return fp8_columns(e.T) if self.quantize else e.float().T
        return self.mat("lm_head")

    # ---- pieces ------------------------------------------------------ #
    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        rms = torch.sqrt((x * x).mean(-1, keepdim=True) + self.eps)
        return x / rms * self.vec(name)

    def rope(self, x: torch.Tensor, pos0: int) -> torch.Tensor:
        """x (T, H, hd) at positions pos0.. ; angles in float64."""
        T, half = x.shape[0], self.hd // 2
        pos = torch.arange(pos0, pos0 + T, dtype=torch.float64,
                           device=x.device)
        freq = self.theta ** (-torch.arange(half, dtype=torch.float64,
                                            device=x.device) / half)
        ang = pos[:, None] * freq[None]
        cos = torch.cos(ang).float()[:, None]
        sin = torch.sin(ang).float()[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q0: int) -> torch.Tensor:
        """Causal attention of q (T, hq, hd) at positions q0.. over k, v
        (S, hkv, hd) at positions 0..S-1."""
        T, S, g = q.shape[0], k.shape[0], self.hq // self.hkv
        rows = max(1, _SCORE_ELEMS // (S * self.hq))
        kpos = torch.arange(S, device=q.device)
        out = []
        for c0 in range(0, T, rows):
            qc = q[c0:c0 + rows].reshape(-1, self.hkv, g, self.hd)
            n = qc.shape[0]
            hi = q0 + c0 + n                     # keys this block can see
            s = torch.einsum("tkgd,skd->kgts", qc, k[:hi]) \
                / math.sqrt(self.hd)
            qpos = torch.arange(q0 + c0, q0 + c0 + n, device=q.device)
            mask = kpos[None, :hi] <= qpos[:, None]
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, -1)
            out.append(torch.einsum("kgts,skd->tkgd", p, v[:hi])
                       .reshape(n, self.hq, self.hd))
        return torch.cat(out, 0)

    def ffn(self, x: torch.Tensor, p: str, wi: torch.Tensor,
            wo: torch.Tensor) -> torch.Tensor:
        outs = []
        for r0 in range(0, x.shape[0], _ROWS):
            h = self.mm(self.norm(x[r0:r0 + _ROWS], p + "ln2.scale"), wi)
            a = torch.nn.functional.silu(h[:, :self.ff]) * h[:, self.ff:]
            outs.append(self.mm(a, wo))
        return x + torch.cat(outs, 0)

    def project(self, x: torch.Tensor, p: str, pos0: int, qkv):
        h = self.norm(x, p + "ln.scale")
        (wq, bq), (wk, bk), (wv, bv) = qkv
        q, k, v = self.mm(h, wq), self.mm(h, wk), self.mm(h, wv)
        if bq is not None:
            q, k, v = q + bq, k + bk, v + bv
        T = x.shape[0]
        q = self.rope(q.reshape(T, self.hq, self.hd), pos0)
        k = self.rope(k.reshape(T, self.hkv, self.hd), pos0)
        return q, k, v.reshape(T, self.hkv, self.hd)

    # ---- the forward ------------------------------------------------- #
    @torch.no_grad()
    def logits(self, prefix: Sequence[int],
               suffixes: Sequence[Sequence[int]],
               first: Sequence[int]) -> List[torch.Tensor]:
        """One shared ``prefix`` (it may be empty) and the ``suffixes``
        that follow it, each computed over the prefix and its own tokens;
        returns, per suffix, the float32 logits of its positions from
        ``first[i]`` on (indices into the suffix)."""
        with exact_float32():
            return self._logits(prefix, suffixes, first)

    def _logits(self, prefix, suffixes, first):
        dev = self.device
        P = len(prefix)
        xp = (self.embed(torch.as_tensor(list(prefix), device=dev))
              if P else None)
        xs = [self.embed(torch.as_tensor(list(s), device=dev))
              for s in suffixes]
        layers = self.cfg["num_hidden_layers"]
        for i in range(layers):
            p = f"layers.{i}."
            qkv = [(self.mat(p + f"attn.{n}.w"), self.vec(p + f"attn.{n}.b"))
                   for n in ("wq", "wk", "wv")]
            wo = self.mat(p + "attn.wo.w")
            wi, wo2 = self.mat(p + "ffn.wi.w"), self.mat(p + "ffn.wo.w")
            kp = vp = None
            if P:
                q, kp, vp = self.project(xp, p, 0, qkv)
                if i < layers - 1:   # the prefix's last update is unread
                    o = self.attend(q, kp, vp, 0).reshape(P, -1)
                    xp = self.ffn(xp + self.mm(o, wo), p, wi, wo2)
            for j, x in enumerate(xs):
                q, k, v = self.project(x, p, P, qkv)
                if P:
                    k, v = torch.cat([kp, k], 0), torch.cat([vp, v], 0)
                o = self.attend(q, k, v, P).reshape(x.shape[0], -1)
                xs[j] = self.ffn(x + self.mm(o, wo), p, wi, wo2)
            del qkv, wo, wi, wo2, kp, vp
        head = self.head()
        out = []
        for x, f in zip(xs, first):
            rows = [self.mm(self.norm(x[r0:r0 + _ROWS], "final_norm.scale"),
                            head) for r0 in range(f, x.shape[0], _ROWS)]
            out.append(torch.cat(rows, 0))
        return out
