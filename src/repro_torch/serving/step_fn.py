"""Fused decode step: one CUDA-graph replay per token (port of
``repro.serving.step_fn``).

The eager engine loop (``DecodeEngine._decode_phase_eager``) launches
every kernel of a decode step from Python, some 2500 at full depth, so the
host's launches, not the card, set the time per token.  ``FusedStep``
collapses the step into one replay of a captured ``torch.cuda.CUDAGraph``:

* every input lives at a fixed device address for a whole **plan epoch**
  (the interval between plan rebuilds): the backend's prepared plan arrays
  (one ``ops.StaticArrays`` per attention window), the step's base
  (``StepBase``: the input tokens, row validity, each row's query
  position, tail page and tail slot at ``delta = 0``, and ``delta``) and
  PAC's outputs.  A new epoch refreshes them with one host-to-device copy
  each, outside the graph;
* within an epoch the graph needs nothing from the host: query positions,
  plan positions and tail slots advance as ``base + delta`` on the device,
  the graph increments ``delta`` itself, copies its sampled tokens into
  its own input buffer for the next replay and splits the engine's
  sampler key in place (the key's buffer is the engine's, so the
  engine's own splits at prefill and the graph's advance one stream);
* the graph holds the whole step: the embedding, every layer's norm,
  projections, RoPE and KV tail write, the backend's raw partials over the
  frozen plan (PAC for the codec backends) and one ``por.por_epilogue``,
  the FFN, the unembedding, the sampler (argmax, or ``repro``'s threefry
  Gumbel draw at ``temperature > 0``) and the finite-logits flag;
* shapes are bucketed (rows and plan arrays to powers of two:
  ``core.plan.bucket_plan``), so arrivals and completions reuse a graph
  while their buckets hold: one ``_Slot`` (buffers and graph) per bucket
  signature.  Padded rows carry ``q_pos = -1`` and write their tail KV to
  the pool's trash page;
* a model with Mamba layers carries the rows' float32 SSM states in the
  slot's fixed ``conv`` (n_mamba, bucket, K-1, conv_dim) and ``ssm``
  (n_mamba, bucket, H, P, S) buffers (``repro``'s donated ``StepState``):
  the engine gathers them from its per-request store at each plan epoch
  and syncs them back at the next, and the graph steps them in place
  (``copy_``).  Every row is its own recurrence, so a padded row never
  touches a live one.

After each step the tokens and flags go to the host by one asynchronous
copy into a slice of a pinned ring, with an event recorded after it; the
engine reads them only at its sync points (``DecodeEngine.flush_tokens``).

On the card, the first epoch of a signature runs the step once, eagerly
and without feeding its tokens forward (that call builds the kernel
library, sets the kernels' shared-memory attributes and warms cuBLAS),
then captures it; all graphs share one memory pool.  A failed capture or
replay raises: there is no eager fallback on the card.  On the CPU the
same step body runs eagerly over the same buffers, with the same
semantics.

``SpecStep`` is the speculative engine's counterpart (``repro``'s
``make_spec_step_fn``): one replay scores a whole verify step's rows
(base queries and draft-node queries) over a verify plan that covers
every page, so each layer's epilogue runs with no tail; its plan and
rows are reloaded in place every step, and the host reads its greedy
tokens at once.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels import ops, pac as pac_mod, por as por_mod
from ..models import layers as L
from ..models import mamba as M
from ..models.transformer import Transformer
from . import sampler
from .kv_cache import PagedKVPool

# pinned host slices for step outputs not yet read: the engine flushes
# before it would reuse one (plan epochs come every page of tokens, so
# in practice a flush comes first)
RING_SIZE = 64


class StepBase(NamedTuple):
    """Per-epoch step inputs at fixed addresses, int64: (B,) each but
    ``delta``, a scalar."""

    tokens: torch.Tensor     # tokens appended this step; the step writes
    #                          the next ones here
    row_valid: torch.Tensor  # 1 for live rows, 0 for bucket padding
    q_pos0: torch.Tensor     # query position at delta 0 (-1 pads)
    tail_page: torch.Tensor  # tail KV page (pads: the pool's trash page)
    tail_base: torch.Tensor  # absolute position of the tail page's slot 0
    tail_off0: torch.Tensor  # in-page slot written at delta 0
    delta: torch.Tensor      # steps into the epoch; the step increments it


class _Slot:
    """The buffers of one bucket signature, and its graph on the card."""

    base_cls = StepBase

    def __init__(self, plans, base, device, h_q: int, d: int,
                 cfg: ModelConfig, n_mamba: int = 0):
        self.plans = [ops.StaticArrays(cls, arrs, device)
                      for cls, arrs in plans]
        self.base = ops.StaticArrays(self.base_cls, base, device)
        self.pac_out = [ops.pac_outputs(p.arrays, h_q, d, device)
                        if isinstance(p.arrays, ops.PlanArrays) else None
                        for p in self.plans]
        bucket = self.base.arrays.tokens.shape[0]
        # the Mamba layers' carried states, (n_mamba, bucket, ...) float32
        self.conv = self.ssm = None
        if n_mamba:
            conv, ssm = M.zero_state(cfg, n_mamba * bucket, device)
            self.conv = conv.view((n_mamba, bucket) + conv.shape[1:])
            self.ssm = ssm.view((n_mamba, bucket) + ssm.shape[1:])
        # (tokens, row_ok) of the last step, the source of the host copy
        self.out = torch.zeros((2, bucket), dtype=torch.int64, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # (PAC, epilogue), pairwise POR and mesh merge launches recorded
        # into the graph at its capture
        self.launches: Optional[Tuple[int, int]] = None
        self.por_launches: Optional[int] = None
        self.merge_launches: Optional[int] = None

    def load(self, plans, base) -> None:
        for static, (_, arrs) in zip(self.plans, plans):
            static.load(arrs)
        self.base.load(base)


class FusedStep:
    """The fused decode step of one engine: per bucket signature, fixed
    buffers and (on the card) one captured graph.

    ``epoch(sig, plans, base)`` makes the signature current, loading its
    buffers with ``plans`` (``(cls, arrays)`` per window, from the
    backend's ``host_arrays``) and ``base`` (``StepBase``'s arrays) and
    capturing its graph the first time; each call then decodes one token
    and returns ``(host, event)``: a pinned ``(2, bucket)`` int64 slice
    that will hold the step's tokens and finite-logits flags once
    ``event`` has completed (``None`` on the CPU, where it holds them at
    once).  The ring holds ``ring_size`` slices: the caller reads a slice
    before it asks for ``ring_size`` more steps.
    """

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 pool: PagedKVPool, backend, windows: Sequence[int],
                 attn_layer_idx: Dict[int, int], device,
                 temperature: float = 0.0,
                 key: Optional[torch.Tensor] = None):
        self.cfg = cfg
        self.temperature = float(temperature)
        # the sampler key, (2,) int64 on the device: each step splits it
        # in place, as ``repro``'s fused step returns its split key
        self.key = (key if key is not None
                    else sampler.prng_key(0, device))
        self.model = model
        self.pool = pool
        self.backend = backend
        self.win_slot = {w: i for i, w in enumerate(windows)}
        self.attn_layer_idx = attn_layer_idx
        # Mamba layer index -> its row of the carry buffers
        self.mamba_idx = {j: i for i, j in enumerate(
            j for j, layer in enumerate(model.layers)
            if layer.kind.mixer == "mamba")}
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots: Dict[tuple, _Slot] = {}
        self._cur: Optional[_Slot] = None
        self._mempool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.ring_size = RING_SIZE
        self._ring: Optional[torch.Tensor] = None
        self._events: List[Optional[torch.cuda.Event]] = []
        self._next = 0
        self.graphs = 0            # graphs captured
        self.replays = 0           # graph replays (eager calls on the CPU)
        self.capture_time = 0.0    # host seconds of warm-ups and captures

    # ------------------------------------------------------------------ #
    def epoch(self, sig: tuple, plans, base) -> List:
        """Start a plan epoch at signature ``sig``; returns the prepared
        plan arrays (one per window) at their fixed addresses.  The
        caller then loads the slot's SSM ``carry`` (the graph reads it only
        when replayed)."""
        self._cur = None
        slot = self.slots.get(sig)
        if slot is None:
            slot = self._new_slot(plans, base)
            self.slots[sig] = slot
        else:
            slot.load(plans, base)
        self._ensure_ring(slot.out.shape[1])
        if self.cuda and slot.graph is None:
            self._capture(slot)
        self._cur = slot
        return self._arrays(slot)

    @staticmethod
    def _arrays(slot) -> List:
        return [p.arrays for p in slot.plans]

    def _new_slot(self, plans, base) -> "_Slot":
        return _Slot(plans, base, self.device, self.cfg.num_heads,
                     self.cfg.head_dim, self.cfg, len(self.mamba_idx))

    @property
    def carry(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """The current signature's SSM carry buffers ``(conv, ssm)``
        (``(None, None)`` without Mamba layers)."""
        return self._cur.conv, self._cur.ssm

    @property
    def logits(self) -> Optional[torch.Tensor]:
        """Float32 (bucket, V) logits of the current signature's last step
        (on the card: its graph's output buffer, valid once the step's
        work has completed)."""
        return None if self._cur is None else self._cur.logits

    def __call__(self) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        slot = self._cur
        if slot is None:
            raise RuntimeError("FusedStep called outside a plan epoch")
        if self.cuda:
            slot.graph.replay()
        else:
            slot.logits = self._body(slot, feed=True)
        self.replays += 1
        i = self._next
        self._next = (i + 1) % self.ring_size
        # the slice's first 2 x bucket elements: contiguous, so the copy
        # lands in pinned memory asynchronously (a strided destination
        # would go through a pageable temporary and block the host)
        host = self._ring[i, :slot.out.numel()].view(slot.out.shape)
        assert host.is_contiguous()
        host.copy_(slot.out, non_blocking=True)
        event = self._events[i]
        if event is not None:
            event.record()
        return host, event

    # ------------------------------------------------------------------ #
    def _ensure_ring(self, bucket: int) -> None:
        """Pinned host slices for ``ring_size`` steps' outputs, one row of
        ``2 x bucket`` each (a smaller bucket takes a row's front).  A new
        ring is made only when a bucket outgrows it; slices of the old one
        stay alive while the engine still holds them."""
        if self._ring is not None and self._ring.shape[1] >= 2 * bucket:
            return
        ring = torch.zeros((self.ring_size, 2 * bucket), dtype=torch.int64)
        self._ring = ring.pin_memory() if self.cuda else ring
        self._events = [torch.cuda.Event() if self.cuda else None
                        for _ in range(self.ring_size)]
        self._next = 0

    def _capture(self, slot: _Slot) -> None:
        """Warm the step up eagerly (tokens not fed forward), then capture
        it into ``slot.graph``; any failure raises."""
        t0 = time.perf_counter()
        slot.graph, launches, slot.logits = capture_graph(
            self.device, self._mempool,
            lambda: self._body(slot, feed=False),
            lambda: self._body(slot, feed=True))
        slot.launches = launches[:2]
        slot.por_launches, slot.merge_launches = launches[2:]
        self.graphs += 1
        self.capture_time += time.perf_counter() - t0

    def _body(self, slot: _Slot, feed: bool) -> torch.Tensor:
        """One decode step over the slot's buffers; returns the logits.
        ``feed``: write the sampled tokens into the input buffer, advance
        ``delta`` and step the SSM carry in place (off only for the
        warm-up before a capture)."""
        base = slot.base.arrays
        dlt = base.delta * base.row_valid
        q_pos = base.q_pos0 + dlt
        logits = self._logits(slot, base, q_pos, dlt, self._mix(slot, feed))
        # greedy draws no bits, so its key is never split (the key's
        # state cannot show in any stream)
        split = self.temperature > 0
        key, sub = sampler.split(self.key) if split else (None, self.key)
        slot.out[0].copy_(sampler.sample(logits, sub, self.temperature,
                                         compiled=True))
        slot.out[1].copy_(torch.isfinite(logits).all(-1))
        if feed:
            base.tokens.copy_(slot.out[0])
            base.delta.add_(1)
            if split:
                self.key.copy_(key)
        return logits

    def _mix(self, slot: _Slot, feed: bool):
        """The Mamba layers' step over the slot's carry (in place when
        ``feed``)."""
        def mix(j, mixer, h):
            i = self.mamba_idx[j]
            y, (conv, ssm) = M.mamba_decode(mixer, self.cfg, h,
                                            slot.conv[i], slot.ssm[i])
            if feed:
                slot.conv[i].copy_(conv)
                slot.ssm[i].copy_(ssm)
            return y
        return mix

    def _logits(self, slot: _Slot, base, q_pos, dlt, mix) -> torch.Tensor:
        """The layer stack of one step: the backend's raw partials over
        the frozen plan and one epilogue a layer."""
        prepared = [self.backend.advance_fn(p.arrays, base.delta)
                    for p in slot.plans]
        B = q_pos.shape[0]

        def attend(qb, k_pool, v_pool, window, tail_page, tail_base, q_pos):
            w = self.win_slot[window]
            parts = self.backend.parts_arrays(
                qb, k_pool, v_pool, prepared[w], num_queries=B,
                window=window, out=slot.pac_out[w])
            return por_mod.por_epilogue(qb, *parts, k_pool, v_pool,
                                        tail_page, tail_base, q_pos,
                                        window=window)

        return decode_stack(self.model, self.pool, self.attn_layer_idx,
                            base.tokens, q_pos, base.tail_page,
                            base.tail_base, base.tail_off0 + dlt, attend,
                            mix)


def capture_graph(device, mempool, warm_up, body):
    """Run ``warm_up()`` eagerly on a side stream (it builds the kernel
    library, sets the kernels' shared-memory attributes and warms
    cuBLAS), then capture ``body()`` into a new ``torch.cuda.CUDAGraph``
    in ``mempool``.  Returns the graph, the (PAC, epilogue, pairwise POR,
    mesh merge) launches recorded into it and ``body``'s result; any
    failure raises."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm_up()
    torch.cuda.current_stream(device).wait_stream(side)
    def counts():
        return (pac_mod.launches, por_mod.epilogue_launches,
                por_mod.launches, por_mod.mesh_merge_launches)
    before = counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=mempool):
        out = body()
    launches = tuple(b - a for a, b in zip(before, counts()))
    torch.cuda.synchronize(device)
    return graph, launches, out


class SpecBase(NamedTuple):
    """One verify step's rows at fixed addresses, int64 (bucket,) each:
    every request's base query, then one query a draft node."""

    tokens: torch.Tensor      # the token each row feeds in
    q_pos: torch.Tensor       # its absolute position (-1 pads)
    write_page: torch.Tensor  # page its K/V go to (pads: the trash page)
    write_off: torch.Tensor   # slot in that page


class _SpecSlot:
    """The buffers of one verify signature, and its graph on the card."""

    def __init__(self, plans, base, device, h_q: int, d: int):
        self.plans = [ops.StaticArrays(cls, arrs, device)
                      for cls, arrs in plans]
        self.base = ops.StaticArrays(SpecBase, base, device)
        self.pac_out = [ops.pac_outputs(p.arrays, h_q, d, device)
                        if isinstance(p.arrays, ops.PlanArrays) else None
                        for p in self.plans]
        bucket = self.base.arrays.tokens.shape[0]
        # (greedy tokens, row_ok) of the step, and their pinned host copy
        self.out = torch.zeros((2, bucket), dtype=torch.int64, device=device)
        cuda = torch.device(device).type == "cuda"
        host = torch.zeros((2, bucket), dtype=torch.int64)
        self.host = host.pin_memory() if cuda else host
        self.event = torch.cuda.Event() if cuda else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # (PAC, epilogue) launches recorded into the graph at its capture
        self.launches: Optional[Tuple[int, int]] = None

    def load(self, plans, base) -> None:
        for static, (_, arrs) in zip(self.plans, plans):
            static.load(arrs)
        self.base.load(base)


class SpecStep:
    """The fused speculative verify step (port of ``repro``'s
    ``make_spec_step_fn``): one graph replay scores every row of a verify
    step — each request's committed-tail base query and one query per
    draft node.

    Per layer the graph projects q/k/v for all rows, writes K/V at each
    row's ``(write_page, write_off)`` (padded rows write the pool's trash
    page, which no plan reads), runs the backend's raw parts over the
    bucketed verify plan and one epilogue launch with no tail, then
    ``wo`` and the FFN; it ends with the argmax and the finite-logits
    flag, copied to a pinned ``(2, bucket)`` buffer that the host reads
    once a step for the acceptance walk (speculation never defers
    tokens).  The verify plan changes every step, so each call ``load``s
    the signature's plan and row buffers in place; a graph is captured
    only for a new signature (``("spec", bucket)`` + the plan arrays'
    shapes).  On the CPU the same body runs eagerly over the same
    buffers.
    """

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 pool: PagedKVPool, backend, windows: Sequence[int],
                 attn_layer_idx: Dict[int, int], device):
        self.cfg = cfg
        self.model = model
        self.pool = pool
        self.backend = backend
        self.win_slot = {w: i for i, w in enumerate(windows)}
        self.attn_layer_idx = attn_layer_idx
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots: Dict[tuple, _SpecSlot] = {}
        self._mempool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.graphs = 0            # graphs captured
        self.replays = 0           # graph replays (eager calls on the CPU)
        self.capture_time = 0.0    # host seconds of warm-ups and captures
        # a list to time replays on the card: each appends its (start,
        # end) CUDA events, recorded around the replay alone
        self.replay_events: Optional[list] = None

    def __call__(self, sig: tuple, plans, base) -> np.ndarray:
        """Verify one step at signature ``sig`` with ``plans`` (``(cls,
        arrays)`` per window) and ``base`` (``SpecBase``'s arrays);
        returns the ``(2, bucket)`` int64 greedy tokens and finite flags
        on the host."""
        slot = self.slots.get(sig)
        if slot is None:
            slot = _SpecSlot(plans, base, self.device, self.cfg.num_heads,
                             self.cfg.head_dim)
            self.slots[sig] = slot
        else:
            slot.load(plans, base)
        if self.cuda:
            if slot.graph is None:
                self._capture(slot)
            if self.replay_events is not None:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                slot.graph.replay()
                ev[1].record()
                self.replay_events.append(ev)
            else:
                slot.graph.replay()
        else:
            self._body(slot)
        self.replays += 1
        slot.host.copy_(slot.out, non_blocking=True)
        if slot.event is not None:
            slot.event.record()
            slot.event.synchronize()
        return slot.host.numpy()

    def _capture(self, slot: _SpecSlot) -> None:
        """Warm the step up eagerly (it writes the K/V the replay will
        write again), then capture it; any failure raises."""
        t0 = time.perf_counter()
        slot.graph, launches, _ = capture_graph(
            self.device, self._mempool, lambda: self._body(slot),
            lambda: self._body(slot))
        slot.launches = launches[:2]
        self.graphs += 1
        self.capture_time += time.perf_counter() - t0

    def _body(self, slot: _SpecSlot) -> None:
        """One verify step over the slot's buffers: per layer the
        backend's raw parts over the verify plan (every page, tail and
        draft pages included), then one epilogue launch with no tail
        (segment combine + cast); the argmax and finite flags to
        ``slot.out``."""
        base = slot.base.arrays
        B = base.tokens.shape[0]

        def attend(qb, k_pool, v_pool, window, *_):
            w = self.win_slot[window]
            parts = self.backend.parts_arrays(
                qb, k_pool, v_pool, slot.plans[w].arrays, num_queries=B,
                window=window, out=slot.pac_out[w])
            return por_mod.por_epilogue(qb, *parts, k_pool, v_pool, None,
                                        None, None, window=window,
                                        tail=False)

        logits = decode_stack(self.model, self.pool, self.attn_layer_idx,
                              base.tokens, base.q_pos, base.write_page,
                              base.q_pos, base.write_off, attend)
        slot.out[0].copy_(torch.argmax(logits, -1))
        slot.out[1].copy_(torch.isfinite(logits).all(-1))


def spec_base(tokens: Sequence[int], q_pos: Sequence[int],
              write_page: Sequence[int], write_off: Sequence[int],
              bucket: int, trash_page: int) -> List[np.ndarray]:
    """``SpecBase``'s arrays for the live rows, padded to ``bucket``:
    padded rows take token 0, ``q_pos = -1`` and slot 0 of the pool's
    trash page."""
    B = len(tokens)
    a = np.zeros((4, bucket), np.int64)
    a[0, :B] = tokens
    a[1] = -1
    a[1, :B] = q_pos
    a[2] = trash_page
    a[2, :B] = write_page
    a[3, :B] = write_off
    return list(a)


def decode_stack(model: Transformer, pool: PagedKVPool,
                 attn_layer_idx: Dict[int, int], tokens: torch.Tensor,
                 q_pos: torch.Tensor, tail_page: torch.Tensor,
                 tail_base: torch.Tensor, tail_off: torch.Tensor,
                 attend, mix=None, write=None, project=None) -> torch.Tensor:
    """The model over one decode token a row: the embedding, every
    layer's norm, then for an attention layer its projections and RoPE,
    its KV write to slot ``tail_off`` of page ``tail_page`` and
    ``attend(q, k_pool, v_pool, window, tail_page, tail_base, q_pos)``,
    for a Mamba layer ``mix(j, mixer, h)`` (the mixer's output; it steps
    the rows' SSM states wherever the caller keeps them), then its FFN,
    then the unembedding; returns the (B, V) logits.  The eager engine
    step and the fused step share it and differ only in ``attend``,
    ``mix`` and where their inputs live.  The mesh's step also replaces
    the tail write (``write(layer, k_new, v_new)``, returning the pools
    ``attend`` gets) and the output projection (``project(layer, o)``)."""
    cfg = model.cfg
    B = tokens.shape[0]
    x = model.embed_tokens(tokens[:, None], q_pos[:, None])    # (B, 1, d)
    for j, layer in enumerate(model.layers):
        h = L.apply_norm(layer.ln, x, cfg)
        if layer.kind.mixer == "mamba":
            x = x + mix(j, layer.mamba, h)
            x, _ = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)
            continue
        la = attn_layer_idx[j]
        window = layer.window
        q, k_new, v_new = L.attn_project(layer.attn, cfg, h, q_pos[:, None])
        if write is None:
            pool.write_tokens(la, tail_page, tail_off, k_new[:, 0],
                              v_new[:, 0])
            k_pool, v_pool = pool.layer_pools(la)
        else:
            k_pool, v_pool = write(la, k_new[:, 0], v_new[:, 0])
        o = attend(q[:, 0], k_pool, v_pool, window, tail_page, tail_base,
                   q_pos)
        if project is None:
            x = x + L.dense(layer.attn.wo,
                            o.reshape(B, 1, cfg.num_heads * cfg.head_dim))
        else:
            x = x + project(layer, o)
        x, _ = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)
    return model.unembed(x)[:, 0]


def step_base(tokens: Sequence[int], q_pos0: Sequence[int],
              tail: Sequence[Tuple[int, int, int]], bucket: int,
              trash_page: int) -> List[np.ndarray]:
    """``StepBase``'s arrays for the live rows, padded to ``bucket``:
    padded rows take token 0, ``q_pos0 = -1`` and the pool's trash page
    as their tail; ``delta`` starts at 0.  ``tail`` holds each live row's
    (tail page, absolute position of its slot 0, slot at delta 0)."""
    B = len(tokens)
    a = np.zeros((6, bucket), np.int64)
    a[0, :B] = tokens
    a[1, :B] = 1
    a[2] = -1
    a[2, :B] = q_pos0
    a[3] = trash_page
    if B:
        a[3:6, :B] = np.asarray(tail, np.int64).T
    return list(a) + [np.zeros((), np.int64)]
