"""The mesh's fused decode step: one CUDA-graph replay a token over a
``(data, model)`` grid of shards (port of ``repro.distributed.step_fn``).

The sibling of ``serving/step_fn.FusedStep`` (it inherits the buffers,
the ring of pinned outputs, the capture and the sampler): per attention
layer,

* **tail writes**: every data shard writes each row's new K/V into its
  own pool block, owners at the row's tail slot, every other shard at
  its trash page (a row of a replicated leaf: every shard at its own
  replica tail page);
* **per-shard partials**: for each model shard ``m`` (its block of query
  and KV heads, sliced from the shared projections) and each data shard
  ``d``, the backend's raw partials over shard ``d``'s plan and slab
  (PAC for ``codec-cuda``), then one epilogue launch with the row's
  tail-owner flags, writing float32 ``o`` and its ``m`` / ``l`` into the
  slot's fixed ``(D, M, B, h_loc)`` buffers (a shard that does not hold
  a row's tail contributes the POR identity);
* **the cross-shard merge**: one ``kernels.por.mesh_merge`` a layer (the
  ``codec_mesh_merge`` kernel on the card): the rows whose KV spans
  shards (``merge_gather``, ``Bm`` of them, a power of two or 0) go
  through ``por_subgroup_merge``'s butterfly over the data axis for
  every model shard at once, and shard 0's view of the layer comes out
  in the model's type; at ``D = 1`` or ``Bm = 0`` no merge runs and
  shard 0's ``o`` is cast;
* **head-parallel output projection**: each model shard's head block of
  shard 0's merged ``o`` multiplies its row block of ``wo``; the ``M``
  partial products are summed in order (``model_sum``), as ``repro``
  sums them with a ``psum`` over ``model``.

Everything free of pages and heads (the embedding, FFN/MoE, the Mamba
carry, the unembedding and sampling) is computed once.  ``repro`` runs it
on every device and keeps device 0's result; each data shard there goes
on from its own merged ``o``, which may differ from its XOR partner's in
the last bit.  The port takes shard 0's view for all of it, so K/V that
``repro`` writes on other shards may differ in the last bit from the
port's: streams, not pools, are held equal.

Per signature (``("mesh", D, M, bucket)``, each window's plan shapes and
``("merge", Bm)``) one set of fixed buffers and, on the card, one
captured graph; on the CPU the same body runs eagerly.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..core.plan import bucket_pow2
from ..kernels import ops, por as por_mod
from ..models import layers as L
from ..serving.step_fn import FusedStep, _Slot, decode_stack


class ShardedStepBase(NamedTuple):
    """Per-epoch step inputs at fixed addresses, int64: ``(B,)`` each but
    the ``(D, B)`` tail layout, the merge indices and ``delta``."""

    tokens: torch.Tensor        # tokens appended this step (the step
    #                             writes the next ones here)
    row_valid: torch.Tensor     # 1 for live rows, 0 for bucket padding
    q_pos0: torch.Tensor        # query position at delta 0 (-1 pads)
    tail_page: torch.Tensor     # (D, B) local tail page (else trash)
    tail_base: torch.Tensor     # absolute position of its slot 0
    tail_off0: torch.Tensor     # in-page slot written at delta 0
    tail_owner: torch.Tensor    # (D, B) 1 where the shard holds the tail
    #                             (every shard for a fully replicated row)
    merge_gather: torch.Tensor  # (Bm,) rows merged across shards (pad 0)
    merge_scatter: torch.Tensor  # (Bm,) where they go back (pad B: dropped)
    contrib: torch.Tensor       # (D,) 1 for shards with local partials
    delta: torch.Tensor         # steps into the epoch; the step adds 1


def sharded_step_base(tokens: Sequence[int], q_pos0: Sequence[int],
                      tail_page: np.ndarray, tail_base: Sequence[int],
                      tail_off0: Sequence[int], tail_owner: np.ndarray,
                      merge_rows: Sequence[int], contrib: np.ndarray,
                      bucket: int, local_trash: int) -> List[np.ndarray]:
    """``ShardedStepBase``'s arrays for the live rows, padded to
    ``bucket``: padded rows take token 0, ``q_pos0 = -1``, every shard's
    trash page and no owner.  ``tail_page`` / ``tail_owner`` are ``(D,
    B)``; the merge indices are padded to ``bucket_pow2`` of their count
    (none when no row merges)."""
    B = len(tokens)
    D = tail_page.shape[0]
    row = np.zeros((5, bucket), np.int64)
    row[0, :B] = tokens
    row[1, :B] = 1
    row[2] = -1
    row[2, :B] = q_pos0
    row[3, :B] = tail_base
    row[4, :B] = tail_off0
    pages = np.full((D, bucket), local_trash, np.int64)
    pages[:, :B] = tail_page
    owner = np.zeros((D, bucket), np.int64)
    owner[:, :B] = tail_owner
    n = len(merge_rows)
    Bm = bucket_pow2(n) if n else 0
    gather = np.zeros(Bm, np.int64)
    scatter = np.full(Bm, bucket, np.int64)
    gather[:n] = merge_rows
    scatter[:n] = merge_rows
    return [row[0], row[1], row[2], pages, row[3], row[4], owner, gather,
            scatter, np.asarray(contrib, np.int64),
            np.zeros((), np.int64)]


def model_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The model axis's reduction of the head-parallel output projection
    (``repro``'s ``psum`` over ``model``): the shards' partial products,
    summed in shard order."""
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


class _MeshSlot(_Slot):
    """The buffers of one mesh signature: per window, one set of plan
    arrays a data shard, and one PAC output buffer (a model shard's heads)
    that every shard reuses in turn; the epilogues' ``m`` and ``l``,
    ``(D, M, bucket, h_loc)`` float32 each, that every layer reuses."""

    base_cls = ShardedStepBase

    def __init__(self, plans, base, device, h_loc: int, d: int, cfg,
                 n_mamba: int = 0, *, D: int, M: int):
        super().__init__([], base, device, h_loc, d, cfg, n_mamba)
        self.plans = [[ops.StaticArrays(cls, arrs, device)
                       for cls, arrs in shards] for shards in plans]
        self.pac_out = [ops.pac_outputs(shards[0].arrays, h_loc, d, device)
                        if isinstance(shards[0].arrays, ops.PlanArrays)
                        else None for shards in self.plans]
        bucket = self.base.arrays.tokens.shape[0]
        self.stats_m, self.stats_l = torch.empty(
            (2, D, M, bucket, h_loc), dtype=torch.float32, device=device)

    def load(self, plans, base) -> None:
        for statics, shards in zip(self.plans, plans):
            for static, (_, arrs) in zip(statics, shards):
                static.load(arrs)
        self.base.load(base)


class ShardedStep(FusedStep):
    """The fused step of a mesh engine.  ``epoch(sig, plans, base)``
    takes, per window, one ``(cls, arrays)`` a data shard (the shards'
    plans share one shape) and ``ShardedStepBase``'s arrays; returns the
    prepared arrays at their fixed addresses, per window a list over the
    data shards."""

    def __init__(self, cfg, model, pool, backend, windows, attn_layer_idx,
                 device, temperature: float = 0.0, key=None, *, mesh):
        super().__init__(cfg, model, pool, backend, windows, attn_layer_idx,
                         device, temperature, key)
        self.D, self.M = mesh.shape["data"], mesh.shape["model"]
        self.h_loc = cfg.num_heads // self.M
        # the first global pool row of each data shard's block
        self._row0 = (torch.arange(self.D, device=self.device)
                      * pool.page_stride)[:, None]

    @staticmethod
    def _arrays(slot) -> List:
        return [[p.arrays for p in shards] for shards in slot.plans]

    def _new_slot(self, plans, base) -> _MeshSlot:
        return _MeshSlot(plans, base, self.device, self.h_loc,
                         self.cfg.head_dim, self.cfg, len(self.mamba_idx),
                         D=self.D, M=self.M)

    def _logits(self, slot: _MeshSlot, base, q_pos, dlt, mix):
        D, M, h_loc = self.D, self.M, self.h_loc
        hd = self.cfg.head_dim
        stride = self.pool.page_stride
        prepared = [[self.backend.advance_fn(p.arrays, base.delta)
                     for p in shards] for shards in slot.plans]
        B = q_pos.shape[0]
        Bm = base.merge_gather.shape[0]
        rows = base.tail_page + self._row0        # (D, B) global rows
        tail_off = base.tail_off0 + dlt

        def write(la, k_new, v_new):
            self.pool.write_tail(la, rows, tail_off, k_new, v_new)
            return self.pool.k[:, la], self.pool.v[:, la]

        def attend(qb, k_layer, v_layer, window, _, tail_base, q_pos):
            w = self.win_slot[window]
            o = torch.empty((D, M, B, h_loc, hd), dtype=torch.float32,
                            device=qb.device)
            ms, ls = slot.stats_m, slot.stats_l
            for m in range(M):
                q_m = qb[:, m * h_loc:(m + 1) * h_loc].contiguous()
                for d in range(D):
                    kp = k_layer[m, d * stride:(d + 1) * stride]
                    vp = v_layer[m, d * stride:(d + 1) * stride]
                    parts = self.backend.parts_arrays(
                        q_m, kp, vp, prepared[w][d], num_queries=B,
                        window=window, out=slot.pac_out[w])
                    por_mod.por_epilogue(
                        q_m, *parts, kp, vp, base.tail_page[d], tail_base,
                        q_pos, window=window, owner=base.tail_owner[d],
                        o_f32=True, out=o[d, m], out_m=ms[d, m],
                        out_l=ls[d, m])
            if D > 1 and Bm > 0:
                return por_mod.mesh_merge(o, ms, ls, base.merge_gather,
                                          base.merge_scatter, base.contrib,
                                          qb.dtype)
            return o[0].to(qb.dtype)                  # (M, B, h_loc, hd)

        def project(layer, o0):
            if M == 1:
                return L.dense(layer.attn.wo, o0[0].reshape(B, 1, -1))
            w_o = layer.attn.wo.w
            blk = h_loc * hd
            return model_sum([o0[m].reshape(B, 1, blk)
                              @ w_o[m * blk:(m + 1) * blk]
                              for m in range(M)])

        return decode_stack(self.model, self.pool, self.attn_layer_idx,
                            base.tokens, q_pos, None, base.tail_base, None,
                            attend, mix, write=write, project=project)
