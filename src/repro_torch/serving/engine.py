"""Prefix-shared decode engine, eager path (port of
``repro.serving.engine.DecodeEngine``).

Continuous-batching greedy decode with CoDec as the attention backend,
organised as a per-step state machine — **admit → prefill → decode →
evict** (``repro``'s DESIGN §6) — so the engine serves traffic larger than
its KV pool instead of raising ``MemoryError``:

* requests enter a FCFS **waiting queue**; admission is gated by a page
  watermark, a ``max_running`` cap and a cost-model prefill budget
  (``core.scheduler.AdmissionController``), and long prompts are
  prefilled in **chunks** interleaved with decode steps;
* prompts are radix-inserted into a ``PrefixForest``; already-cached
  nodes are *not* recomputed (prefill prefix reuse) — only the new leaf's
  KV is computed, attending to the gathered cached prefix;
* decode attention = **frozen CoDec plan** over all full pages (rebuilt
  exactly when ``core.plan.plan_key`` changes: batch membership, path
  structure, or a leaf crossing a page boundary) through the backend's
  raw ``parts`` — the CUDA PAC kernel by default — then one CUDA
  **POR epilogue** launch per layer: the per-query segment reduction of
  those partials, a **tail attention** over each request's growing last
  page, their POR merge and the cast;
* when the paged pool runs dry the engine reclaims, cheapest first:
  finished requests' KV, nodes only a waiting request still pins, then it
  **preempts and recomputes** — the live victim with the fewest generated
  tokens releases its non-shared pages, its shared prefix nodes stay
  pinned (``node.meta["pins"]``) and it re-enters the queue at the front
  to be re-prefilled from the radix-cached prefix.  Under greedy decoding
  its stream is the one an unconstrained run gives.

``fused=True`` (backends with the jit-safe contract; ``ref`` stays eager)
decodes each token with one replay of a captured CUDA graph
(``serving/step_fn.py``): plans are bucketed and held at fixed addresses
for a plan epoch, and the sampled tokens stay on the device, appended as
placeholders, until a sync point (``flush_tokens``: a plan epoch,
admission, reclamation, preemption, a completion, the end of ``run``).

Left for later slices: sampling at temperature > 0, the prefix cache and
its reclaim tier, deadlines and failing a lone request whose KV outgrows
the pool (here it raises ``MemoryError``), cascade prefill, telemetry and
speculation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import plan as plan_mod
from ..core import tree as tree_mod
from ..core.cost_model import CostModel
from ..core.scheduler import AdmissionController, AdmissionPolicy
from ..kernels import por as por_mod, registry as registry_mod
from ..models import layers as L
from ..models.transformer import Transformer
from . import sampler
from . import step_fn as step_fn_mod
from .kv_cache import PagedKVPool

# request lifecycle states
WAITING, PREFILL, RUNNING, DONE = "waiting", "prefill", "running", "done"

# a sampled token that still lives in an unread fused-step output;
# materialised by ``DecodeEngine.flush_tokens``
PENDING_DEVICE = "<device>"
_PLACEHOLDER = -1


class _Deferred:
    """One fused step's sampled tokens, not yet read on the host.

    ``patches`` records where each token was appended as a placeholder
    (request ``generated`` index + forest leaf token slot) so a later
    flush can write the real values in place.
    """

    __slots__ = ("tokens", "event", "rows", "patches")

    def __init__(self, tokens, event, rows):
        self.tokens = tokens          # (2, bucket) host int64: tokens, ok
        self.event = event            # CUDA event after its copy, or None
        self.rows = rows              # request id per row
        self.patches = []             # (rid, row, gen_idx, node_id, tok_idx)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    generated: List[int] = dataclasses.field(default_factory=list)
    pending: object = None             # sampled, not yet appended (an
    #                                    int, or PENDING_DEVICE)
    max_new: int = 16
    state: str = WAITING
    preemptions: int = 0
    computed_hwm: int = 0              # highest position ever computed
    pinned: List[int] = dataclasses.field(default_factory=list)
    kv_freed: bool = False             # done + KV reclaimed

    @property
    def seq(self) -> List[int]:
        """Full token sequence whose KV must be resident to decode."""
        return self.prompt + self.generated


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, model: Transformer, *,
                 page_size: int = 16, num_pages: int = 4096,
                 backend: str = "codec-cuda",
                 num_lanes: int = 2, max_q: int = 32,
                 max_kv_per_task: int = 2048,
                 temperature: float = 0.0,
                 prefill_chunk=None, reserve_pages: int = 0,
                 max_running: Optional[int] = None,
                 fused: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.backend = backend
        self._backend = registry_mod.get(backend)
        if (cfg.sliding_window and not self._backend.supports_window
                and any(k.mixer == "attn_local"
                        for k in cfg.layer_pattern)):
            raise ValueError(f"backend {backend!r} cannot serve "
                             f"sliding-window layers")
        sampler.check_temperature(temperature)
        self.page_size = page_size
        self.num_lanes = num_lanes
        self.max_q = max_q
        self.max_kv_per_task = max_kv_per_task
        self.temperature = temperature
        self.layers = list(model.layers)
        self.attn_layer_idx = {j: a for a, j in enumerate(
            j for j, layer in enumerate(self.layers)
            if layer.kind.mixer in ("attn", "attn_local"))}
        self.pool = PagedKVPool(max(len(self.attn_layer_idx), 1), num_pages,
                                page_size, max(cfg.num_kv_heads, 1),
                                max(cfg.head_dim, 1), device=self.device)
        self.forest = tree_mod.PrefixForest(page_size)
        # splitting a pinned node must extend each waiting holder's pin
        # list over the new lower half (see _on_split_pins)
        self.forest.on_split = self._on_split_pins
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.cost_model = CostModel(max(cfg.num_heads, 1),
                                    max(cfg.num_kv_heads, 1),
                                    max(cfg.head_dim, 1),
                                    bytes_per=self.pool.k.element_size(),
                                    page_size=page_size)
        self.policy = AdmissionPolicy(prefill_chunk=prefill_chunk,
                                      reserve_pages=reserve_pages,
                                      max_running=max_running)
        self.admission = AdmissionController(self.policy, self.cost_model,
                                             page_size)
        self._prefilling: List[int] = []   # admitted, prompt not prefilled
        # (start, end) CUDA events of the prefill chunks not yet read
        self._prefill_events: List[Tuple] = []
        # plans keyed by window size (0 = full attention)
        self._plans: Dict[int, Tuple] = {}
        self._plan_dirty = True
        self._plan_key: Optional[tuple] = None
        # float32 logits of the last decode step (B, V), row i for request
        # last_rows[i]; on the fused path the step's output buffer, valid
        # once its work has completed (read it after a flush)
        self.last_logits: Optional[torch.Tensor] = None
        self.last_rows: List[int] = []
        # host-clock seconds: plan builds, per-step q-position advances
        # (re-prepare + re-upload of every plan array), prefill (on the
        # card stream time, see prefill_time), decode (fused: enqueueing),
        # fused dispatch, token syncs, graph captures
        self.stats = {"steps": 0, "replans": 0, "plan_time": 0.0,
                      "advance_time": 0.0, "prefill_time": 0.0,
                      "decode_time": 0.0, "prefill_tokens": 0,
                      "admitted": 0, "preempted": 0, "reclaimed": 0,
                      "recompute_tokens": 0, "prefill_chunks": 0,
                      "prefill_stalls": 0, "fused_calls": 0,
                      "token_flushes": 0, "decode_dispatch_time": 0.0,
                      "decode_sync_time": 0.0, "capture_time": 0.0,
                      "nonfinite_rows": 0}
        # one record a step: what it decoded, admitted, preempted,
        # reclaimed and prefilled, and the queue and pool it left
        self.step_stats: List[Dict] = []

        # ---- fused decode: one graph replay a token (step_fn.py) ------ #
        # active only for backends with the jit-safe contract (``ref``
        # decodes eagerly)
        self.fused = bool(fused) and self._backend.jit_safe
        self.fused_step = (step_fn_mod.FusedStep(
            cfg, self.model, self.pool, self._backend, self._windows(),
            self.attn_layer_idx, self.device)
            if self.fused else None)
        # async token plumbing
        self._deferred: List[_Deferred] = []
        self._pending_ref: Dict[int, Tuple[_Deferred, int]] = {}
        # distinct fused shape signatures seen (one step state, and on the
        # card one captured graph, each)
        self.bucket_signatures: set = set()

    # ------------------------------------------------------------------ #
    # request admission (admit phase) + chunked prefill (prefill phase)
    # ------------------------------------------------------------------ #
    def add_request(self, prompt: List[int], max_new: int = 16) -> int:
        """Enqueue a request; admits (and prefills) it at once when memory
        allows, so under no pressure this is immediate prefill."""
        prompt = list(prompt)
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if max_new <= 0:
            raise ValueError(f"max_new must be positive, got {max_new}")
        arr = np.asarray(prompt)
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"prompt must be integer token ids, got dtype {arr.dtype}")
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token id {lo if lo < 0 else hi} outside the "
                f"vocabulary [0, {self.cfg.vocab_size})")
        # only an unservable prompt is an error: whole-prompt prefill needs
        # every page at once, chunked prefill one chunk + the tail it grows
        # into (larger prompts just wait in the queue)
        need = self.policy.min_working_pages(len(prompt), self.page_size)
        if need > self.pool.num_pages:
            raise MemoryError(
                f"prompt working set needs {need} KV pages but the pool "
                f"holds only {self.pool.num_pages}: it can never be "
                f"admitted")
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, prompt, max_new=max_new)
        self.admission.push(rid)
        self._admit_phase()
        return rid

    def has_work(self) -> bool:
        return any(q.state in (WAITING, PREFILL, RUNNING)
                   for q in self.requests.values())

    def _live(self) -> List[int]:
        return [r for r in sorted(self.requests)
                if self.requests[r].state in (PREFILL, RUNNING)]

    def _active_rows(self) -> List[int]:
        return [r for r in sorted(self.requests)
                if self.requests[r].state == RUNNING]

    def _has_pages_for(self, req: Request) -> bool:
        """Whether the pool holds the request's unmatched pages above the
        admission watermark."""
        seq = req.seq
        matched = self.forest.match_len(np.asarray(seq, np.int32))
        need = (-(-max(len(seq), 1) // self.page_size)
                - matched // self.page_size)
        # the watermark is the same at every batch size until
        # speculation's per-request draft reserve is ported
        return self.pool.num_free - self.policy.reserve_pages >= need

    def _admit_phase(self) -> None:
        """Admission + chunked-prefill phase: continue admitted prefills
        first, then admit waiting requests FCFS (head-of-line blocks)
        within the page watermark (reclaiming finished KV and orphaned
        pins, never preempting), the ``max_running`` cap and the step's
        cost-model prefill budget."""
        running_ctx = [self.forest.context_len(r)
                       for r in self._active_rows()]
        budget = self.admission.prefill_budget(running_ctx)
        # 1. advance chunked prefills already admitted
        spent = self._advance_prefills(budget)
        # 2. admit from the queue
        while len(self.admission):
            if budget is not None and spent >= budget:
                return
            if (self.policy.max_running is not None
                    and len(self._live()) >= self.policy.max_running):
                return                      # capacity cap, not memory
            head = self.requests[self.admission.peek()]
            need_min = self.policy.min_working_pages(len(head.seq),
                                                     self.page_size)
            if need_min > self.pool.num_pages:
                raise MemoryError(
                    f"request {head.rid} needs a {need_min}-page working "
                    f"set but the pool holds only {self.pool.num_pages}")
            while not self._has_pages_for(head):
                if not self._reclaim_one(set(), allow_preempt=False):
                    return                  # no free memory: keep waiting
            # admission boundary: radix insertion compares token values,
            # so in-flight device tokens must land before _admit (the
            # probe above only under-matches a placeholder, so a request
            # blocked on memory costs the fused path no sync a step)
            self.flush_tokens()
            self.admission.pop()
            self._admit(head)
            spent += self._prefill_step(
                head, None if budget is None else budget - spent)

    def _advance_prefills(self, budget: Optional[int]) -> int:
        """Advance every admitted-but-unfinished prefill by one chunk."""
        spent = 0
        for rid in list(self._prefilling):
            if budget is not None and spent >= budget:
                return spent
            req = self.requests[rid]
            if req.state != PREFILL:       # preempted by an earlier prefill
                continue
            spent += self._prefill_step(
                req, None if budget is None else budget - spent)
        return spent

    def _admit(self, req: Request) -> None:
        """(Re-)insert the request's sequence into the forest and release
        the pins it held while waiting (its path now keeps those nodes
        alive by membership)."""
        self.forest.insert_tokens(req.rid, np.asarray(req.seq, np.int32))
        self._unpin(req)
        req.state = PREFILL
        self._prefilling.append(req.rid)
        self.stats["admitted"] += 1

    # ------------------------------------------------------------------ #
    # async-token sync (fused path)
    # ------------------------------------------------------------------ #
    def flush_tokens(self) -> None:
        """Materialise every deferred fused-step token on the host.

        The fused decode path appends sampled tokens to the forest and to
        ``Request.generated`` as placeholders while their copies to the
        host are still in flight; this is the single blocking sync point,
        run only at plan-epoch, admission, reclamation and completion
        boundaries and at the end of ``run`` (a no-op otherwise: the eager
        path never defers).  Rows whose logits were not finite are
        counted in ``stats["nonfinite_rows"]``.
        """
        if not self._deferred and not self._pending_ref:
            return
        t0 = time.perf_counter()
        for e in self._deferred:
            if e.event is not None:
                e.event.synchronize()
        for e in self._deferred:
            toks, ok = e.tokens.numpy()
            self.stats["nonfinite_rows"] += int(
                (ok[:len(e.rows)] == 0).sum())
            for rid, row, gen_idx, node_id, tok_idx in e.patches:
                tok = int(toks[row])
                req = self.requests.get(rid)
                if req is not None and gen_idx < len(req.generated):
                    req.generated[gen_idx] = tok
                node = self.forest.nodes.get(node_id)
                if (node is not None and node.tokens is not None
                        and tok_idx < len(node.tokens)):
                    node.tokens[tok_idx] = tok
        # sampled-but-not-yet-appended tokens become host ``pending``s
        for rid, (e, row) in self._pending_ref.items():
            req = self.requests.get(rid)
            if req is not None and req.pending is PENDING_DEVICE:
                req.pending = int(e.tokens[0, row])
        self._deferred = []
        self._pending_ref = {}
        self.stats["token_flushes"] += 1
        self.stats["decode_sync_time"] += time.perf_counter() - t0

    @property
    def fused_cache_size(self) -> int:
        """Step states kept, one per bucket signature (on the card each
        holds one captured graph)."""
        return 0 if self.fused_step is None else len(self.fused_step.slots)

    # ------------------------------------------------------------------ #
    # eviction (evict phase) / reclamation
    # ------------------------------------------------------------------ #
    def _drop_node(self, node) -> None:
        """Release a node's pages and unlink it from the forest."""
        if node.page_ids:
            self.pool.allocator.release(node.page_ids)
            node.page_ids = []
        self.forest.nodes[node.parent].children.remove(node.id)
        del self.forest.nodes[node.id]

    def _maybe_free_node(self, node) -> None:
        """Free a node once nothing references it (no requests pass
        through it, no children, no waiting request pins it), then try
        its parent."""
        if node.id == tree_mod.ROOT_ID or node.id not in self.forest.nodes:
            return
        if node.requests or node.children or node.meta.get("pins", 0) > 0:
            return
        parent = self.forest.nodes[node.parent]
        self._drop_node(node)
        self._maybe_free_node(parent)

    def _release_kv(self, rid: int) -> None:
        """Drop a request's forest footprint (finished or released)."""
        for node in reversed(self.forest.path(rid)):
            if node.id not in self.forest.nodes:
                continue
            node.requests.remove(rid)
            self._maybe_free_node(node)
        del self.forest.leaf_of[rid]

    def _unpin(self, req: Request) -> None:
        """Drop the pins a waiting request holds, freeing the nodes only
        they kept."""
        for nid in req.pinned:
            node = self.forest.nodes.get(nid)
            if node is not None:
                node.meta["pins"] = node.meta.get("pins", 0) - 1
                self._maybe_free_node(node)
        req.pinned = []

    def _preempt(self, rid: int) -> None:
        """Evict a live request: release its non-shared pages, pin the
        shared prefix nodes it leaves behind, and requeue it (front) to be
        re-prefilled from the radix-cached prefix."""
        # re-prefill recomputes from token values, and a device pending
        # must become a host one (its re-prefill does not sample it
        # again); the sync also retires every queued replay that reads
        # the pages about to be freed
        self.flush_tokens()
        req = self.requests[rid]
        assert req.state in (PREFILL, RUNNING), req.state
        if len(req.generated) >= req.max_new:
            # generation already complete (evicted between its final
            # append and the done transition): just drop the KV
            self._release_kv(rid)
            if rid in self._prefilling:
                self._prefilling.remove(rid)
            req.state = DONE
            req.kv_freed = True
            self.stats["reclaimed"] += 1
            return
        pinned = []
        for node in reversed(self.forest.path(rid)):
            if node.id not in self.forest.nodes:
                continue
            node.requests.remove(rid)
            if (node.requests or node.children
                    or node.meta.get("pins", 0) > 0):
                node.meta["pins"] = node.meta.get("pins", 0) + 1
                pinned.append(node.id)
            else:
                self._drop_node(node)
        del self.forest.leaf_of[rid]
        if rid in self._prefilling:
            self._prefilling.remove(rid)
        req.pinned = pinned
        req.state = WAITING
        req.preemptions += 1
        self.admission.requeue(rid)
        self.stats["preempted"] += 1

    def _reclaimable_pages(self, rid: int) -> int:
        """Pages that preempting ``rid`` would free (its non-shared
        nodes)."""
        n = 0
        freeable: Set[int] = set()
        for node in reversed(self.forest.path(rid)):
            others = [r for r in node.requests if r != rid]
            kids = set(node.children) - freeable
            if others or kids or node.meta.get("pins", 0) > 0:
                continue
            freeable.add(node.id)
            n += len(node.page_ids)
        return n

    def _reclaim_one(self, exclude: Set[int],
                     allow_preempt: bool = True) -> bool:
        """Free some pages, cheapest first: (1) finished-request KV,
        (2) orphaned pinned nodes, (3) preempt the live victim with the
        fewest generated tokens (ties: latest arrival).  False when
        nothing is left to free."""
        for rid in sorted(self.requests):
            q = self.requests[rid]
            complete = (q.state == DONE
                        or (q.state == RUNNING
                            and len(q.generated) >= q.max_new))
            if (complete and not q.kv_freed and rid not in exclude
                    and rid in self.forest.leaf_of):
                # a finished request's tokens land, and the replays that
                # read its pages retire, before its nodes go
                self.flush_tokens()
                self._release_kv(rid)
                q.state = DONE
                q.kv_freed = True
                self._plan_dirty = True
                self.stats["reclaimed"] += 1
                return True
        for rid in sorted(self.requests):
            q = self.requests[rid]
            if q.state != WAITING or not q.pinned:
                continue
            for nid in list(q.pinned):
                node = self.forest.nodes.get(nid)
                if node is None:
                    q.pinned.remove(nid)
                    continue
                if not node.requests and not node.children:
                    # drop this waiter's pin; the node frees once the last
                    # pin goes (multiply-pinned nodes shed one pin per
                    # holder until the final drop releases the pages)
                    q.pinned.remove(nid)
                    node.meta["pins"] = node.meta.get("pins", 0) - 1
                    self._maybe_free_node(node)
                    if nid not in self.forest.nodes:
                        self.stats["reclaimed"] += 1
                        return True
        if not allow_preempt:
            return False
        victims = [r for r in sorted(self.requests)
                   if self.requests[r].state in (PREFILL, RUNNING)
                   and r not in exclude
                   and self._reclaimable_pages(r) > 0]
        if not victims:
            return False
        victim = min(victims,
                     key=lambda r: (len(self.requests[r].generated), -r))
        self._preempt(victim)
        return True

    def _on_split_pins(self, upper, lower) -> None:
        """Forest split observer: ``tree._split`` copies the pin refcount
        to the lower half; the per-request pin lists must follow, or
        un-pinning at re-admission would strand the lower half pinned
        forever."""
        if upper.meta.get("pins", 0) <= 0:
            return
        for req in self.requests.values():
            if upper.id in req.pinned:
                req.pinned.append(lower.id)

    def _alloc_pages(self, n: int, exclude: Set[int],
                     allow_preempt: bool = True) -> Optional[List[int]]:
        """Allocate ``n`` pages, reclaiming (and preempting, unless
        ``allow_preempt`` is off) under pressure; ``None`` when nothing
        more can be reclaimed."""
        while self.pool.num_free < n:
            if not self._reclaim_one(exclude, allow_preempt):
                return None
        return self.pool.allocator.alloc(n)

    def _grow_node_pages(self, node, k: int,
                         exclude: Set[int]) -> Optional[List[int]]:
        got = self._alloc_pages(k, exclude)
        if got is not None:
            node.page_ids += got
        return got

    # ------------------------------------------------------------------ #
    # prefill with prefix reuse
    # ------------------------------------------------------------------ #
    def _ensure_pages_upto(self, rid: int, upto: int) -> bool:
        """Allocate pages covering tokens [0, upto) of the path; False when
        allocation stalls (partial allocations are kept for the retry)."""
        for node in self.forest.path(rid):
            cover = min(node.length, max(0, upto - node.start_pos))
            need = -(-cover // self.page_size)
            if len(node.page_ids) < need:
                got = self._grow_node_pages(node,
                                            need - len(node.page_ids),
                                            exclude={rid})
                if got is None:
                    return False
        return True

    def _gather_prefix_upto(self, layer_attn: int, path,
                            upto: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense (upto, n_kv, hd) of the path's first ``upto`` cached
        tokens."""
        ks, vs = [], []
        pos = 0
        for node in path:
            take = min(node.length, upto - pos)
            if take <= 0:
                break
            npg = -(-take // self.page_size)
            k, v = self.pool.gather_context(layer_attn,
                                            node.page_ids[:npg], take)
            ks.append(k)
            vs.append(v)
            pos += take
        if not ks:
            z = self.pool.k.new_zeros((0,) + tuple(self.pool.k.shape[3:]))
            return z, z
        return torch.cat(ks, 0), torch.cat(vs, 0)

    def _filled_front(self, rid: int) -> int:
        """Contiguous filled-KV front along the request's path."""
        filled = 0
        for node in self.forest.path(rid):
            f = min(node.meta.get("filled", 0), node.length)
            filled += f
            if f < node.length:
                break
        return filled

    def _promote(self, req: Request) -> None:
        req.state = RUNNING
        if req.rid in self._prefilling:
            self._prefilling.remove(req.rid)

    def _prefill_mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _prefill_done(self, t0) -> None:
        if self.device.type != "cuda":
            self.stats["prefill_time"] += time.perf_counter() - t0
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._prefill_events.append((t0, ev))

    def prefill_time(self) -> float:
        """Seconds of prefill so far, ``stats["prefill_time"]`` brought up
        to date: on the card the stream time between each chunk's pair of
        events (the engine never waits for them: call this after a
        synchronize), on the CPU the host clock around each chunk."""
        for a, b in self._prefill_events:
            self.stats["prefill_time"] += a.elapsed_time(b) / 1e3
        self._prefill_events.clear()
        return self.stats["prefill_time"]

    @torch.no_grad()
    def _prefill_step(self, req: Request, budget: Optional[int]) -> int:
        """Advance the request's prefill by one chunk of ``<= budget``
        tokens (``None`` = the whole remaining span); returns tokens
        computed (0 = stalled on pages, retried next step).

        Attention KV of the cached prefix is reused (gathered from the
        paged pool).  A fully cached prompt recomputes only its final
        position so its logits exist.  When the sequence completes, the
        request joins the decode batch; ``pending`` is sampled only if it
        did not survive a preemption.  The chunk's seconds: on the card a
        pair of CUDA events around its work (read by ``prefill_time``), on
        the CPU the host clock.
        """
        cfg = self.cfg
        rid = req.rid
        seq = req.seq
        total = len(seq)
        path = self.forest.path(rid)
        kv_filled = self._filled_front(rid)
        if kv_filled < total:
            start = kv_filled
        elif req.pending is None:
            start = total - 1
        else:
            self._promote(req)
            return 0
        # a chunk of the budget, never below one new token of progress
        end = total if budget is None else min(
            total, max(start + max(budget, 1), kv_filled + 1))
        if not self._ensure_pages_upto(rid, end):
            self.stats["prefill_stalls"] += 1
            return 0
        t0 = self._prefill_mark()
        dev = self.device
        tokens = torch.as_tensor(np.asarray(seq[start:end], np.int64),
                                 device=dev)
        Tn = tokens.shape[0]
        positions = torch.arange(start, end, device=dev)[None]    # (1, Tn)

        # node segments covering the span (for KV writes)
        segments = []        # (node, lo, hi) in span-local coordinates
        off = 0
        for node in path:
            lo = max(0, off - start)
            hi = min(end, off + node.length) - start
            if hi > lo:
                segments.append((node, lo, hi))
            off += node.length

        x = self.model.embed_tokens(tokens[None])
        new_kv = []  # (layer_attn, k (Tn,kv,hd), v)
        for j, layer in enumerate(self.layers):
            h = L.apply_norm(layer.ln, x, cfg)
            la = self.attn_layer_idx[j]
            window = (cfg.sliding_window if layer.kind.mixer == "attn_local"
                      else 0)
            q, k_new, v_new = L.attn_project(layer.attn, cfg, h, positions)
            pk, pv = self._gather_prefix_upto(la, path, start)
            k_all = torch.cat([pk.to(k_new.dtype)[None], k_new], 1)
            v_all = torch.cat([pv.to(v_new.dtype)[None], v_new], 1)
            o = L.mha(q, k_all, v_all, causal=True, window=window,
                      q_positions=positions,
                      kv_positions=torch.arange(end, device=dev)[None])
            x = x + L.dense(layer.attn.wo,
                            o.reshape(1, Tn, cfg.num_heads * cfg.head_dim))
            new_kv.append((la, k_new[0], v_new[0]))
            x = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)

        # write new KV into unfilled page slots only
        offs, pages, kv_rows = [], [], []
        ps = self.page_size
        for node, lo, hi in segments:
            filled = node.meta.get("filled", 0)
            base = node.start_pos - start   # span-local index of token 0
            t_hi = hi - base
            for t in range(max(filled, lo - base), t_hi):
                pages.append(node.page_ids[t // ps])
                offs.append(t % ps)
                kv_rows.append(base + t)
            if t_hi > filled:
                node.meta["filled"] = t_hi
        if kv_rows:
            rows = torch.as_tensor(kv_rows, device=dev)
            pg = torch.as_tensor(pages, device=dev)
            of = torch.as_tensor(offs, device=dev)
            for la, k_new, v_new in new_kv:
                self.pool.write_tokens(la, pg, of, k_new[rows], v_new[rows])

        self.stats["prefill_tokens"] += Tn
        self.stats["recompute_tokens"] += max(
            0, min(end, req.computed_hwm) - start)
        req.computed_hwm = max(req.computed_hwm, end)
        if end < total:
            self.stats["prefill_chunks"] += 1
        elif req.pending is None:
            logits = self.model.unembed(x[:, -1])               # (1, V)
            req.pending = int(sampler.sample(logits, self.temperature)[0])
        self._prefill_done(t0)
        if end == total:
            self._promote(req)
        return Tn

    # ------------------------------------------------------------------ #
    # plan management
    # ------------------------------------------------------------------ #
    def _windows(self) -> List[int]:
        ws = set()
        for layer in self.layers:
            if layer.kind.mixer == "attn":
                ws.add(0)
            elif layer.kind.mixer == "attn_local":
                ws.add(self.cfg.sliding_window)
        return sorted(ws)

    @property
    def plan_rebuilds(self) -> int:
        return self.stats["replans"]

    def _rebuild_plans(self) -> None:
        t0 = time.perf_counter()
        rows = self._active_rows()
        req_rows = {r: i for i, r in enumerate(rows)}
        ps = self.page_size
        truncate = {}
        for r in rows:
            leaf = self.forest.nodes[self.forest.leaf_of[r]]
            truncate[leaf.id] = max(0, ((leaf.length - 1) // ps) * ps)
        build = (plan_mod.flash_plan if self._backend.plan_kind == "flash"
                 else plan_mod.build_plan)
        self._plans = {}
        for w in self._windows():
            p = build(
                self.forest, self.cost_model, self.num_lanes, self.max_q,
                self.max_kv_per_task, req_rows=req_rows, window=w,
                truncate=truncate)
            p = plan_mod.pad_plan(p)
            self._plans[w] = (p, self._backend.prepare(p, self.device))
        self._plan_key = plan_mod.plan_key(self.forest, rows)
        self._plan_dirty = False
        self.stats["replans"] += 1
        self.stats["plan_time"] += time.perf_counter() - t0

    def _advance_qpos(self) -> None:
        """Per-step plan refresh: live queries moved one position; every
        plan array is prepared and uploaded again."""
        t0 = time.perf_counter()
        for w, (p, _) in list(self._plans.items()):
            slot = np.arange(p.max_q)[None, :]
            live = slot < p.task_qnum[:, None]
            p.q_pos = p.q_pos + live.astype(np.int32)
            self._plans[w] = (p, self._backend.prepare(p, self.device))
        self.stats["advance_time"] += time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    # decode step (admit -> prefill -> decode)
    # ------------------------------------------------------------------ #
    _STEP_COUNTERS = ("admitted", "preempted", "reclaimed",
                      "prefill_tokens", "recompute_tokens")

    def step(self) -> Dict[int, int]:
        """One engine step: admission + chunked prefill, then append
        pending tokens (evicting under pressure) and decode one token per
        running request; appends the step's record to ``step_stats``."""
        snap = {k: self.stats[k] for k in self._STEP_COUNTERS}
        self._admit_phase()
        out = (self._decode_phase_fused() if self.fused
               else self._decode_phase_eager())
        self.step_stats.append({
            "step": len(self.step_stats),
            "decoded": len(out),
            **{k: self.stats[k] - snap[k] for k in self._STEP_COUNTERS},
            "waiting": len(self.admission),
            "prefilling": len(self._prefilling),
            "running": len(self._active_rows()),
            "pages_free": self.pool.num_free,
        })
        return out

    def _grow_leaf_tail(self, r: int):
        """Ensure the request's leaf has a page slot for its newest
        token, preempting under pressure (never ``r`` itself); returns
        the leaf."""
        leaf = self.forest.nodes[self.forest.leaf_of[r]]
        if -(-leaf.length // self.page_size) > len(leaf.page_ids):
            got = self._grow_node_pages(leaf, 1, exclude={r})
            if got is None:
                raise MemoryError(
                    f"KV pool exhausted growing request {r}: nothing "
                    f"left to evict (pool smaller than the working set)")
        return leaf

    def _append_pending(self, rows0: List[int]) -> None:
        """Append each running request's pending token to its leaf and
        grow tail pages, preempting the fewest-generated victim when the
        pool runs dry.  When nothing else can be evicted the growing row
        is preempted itself if other requests are live; a lone request
        that outgrows the pool raises ``MemoryError`` (``repro`` fails it
        as ``kv_exhausted``, with the lifecycle states of a later slice).
        Device pendings (fused path) are appended as placeholders and
        patched at the next ``flush_tokens``."""
        for r in rows0:
            req = self.requests[r]
            if req.state != RUNNING:    # evicted growing an earlier row
                continue
            if req.pending is None:
                continue
            if req.pending is PENDING_DEVICE:
                ent, row = self._pending_ref.pop(r)
                self.forest.append_token(r, _PLACEHOLDER)
                leaf = self.forest.nodes[self.forest.leaf_of[r]]
                ent.patches.append((r, row, len(req.generated), leaf.id,
                                    len(leaf.tokens) - 1))
                req.generated.append(_PLACEHOLDER)
            else:
                self.forest.append_token(r, req.pending)
                req.generated.append(req.pending)
            req.pending = None
            try:
                self._grow_leaf_tail(r)
            except MemoryError:
                # with other tenants the pressure is transient:
                # preempt-and-recompute keeps the greedy stream intact
                others = [q for q in self.requests.values()
                          if q.rid != r
                          and q.state in (WAITING, PREFILL, RUNNING)]
                if not others:
                    raise
                self._preempt(r)

    @torch.no_grad()
    def _decode_phase_eager(self) -> Dict[int, int]:
        rows0 = self._active_rows()
        if not rows0:
            return {}
        t0 = time.perf_counter()
        dev = self.device
        # 1. append pending tokens to leaves
        self._append_pending(rows0)
        rows = self._active_rows()
        if not rows:
            return {}
        tokens = [self.requests[r].generated[-1] for r in rows]

        # 2. plan lifecycle: rebuild exactly when the plan key changed
        if (self._plan_dirty
                or plan_mod.plan_key(self.forest, rows) != self._plan_key):
            self._rebuild_plans()
        else:
            self._advance_qpos()

        B = len(rows)
        ctx = np.array([self.forest.context_len(r) for r in rows], np.int64)
        # tail page info, uploaded ONCE per step (not once per layer)
        tail = np.zeros((4, B), np.int64)
        for i, r in enumerate(rows):
            leaf = self.forest.nodes[self.forest.leaf_of[r]]
            tp = (leaf.length - 1) // self.page_size
            tail[:, i] = (leaf.page_ids[tp],
                          leaf.start_pos + tp * self.page_size,
                          (leaf.length - 1) % self.page_size,
                          ctx[i] - 1)
        tail_pages, tail_base, tail_off, q_pos = \
            torch.as_tensor(tail, device=dev).unbind(0)
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
        logits = step_fn_mod.decode_stack(
            self.model, self.pool, self.attn_layer_idx, tok, q_pos,
            tail_pages, tail_base, tail_off, self._attend)        # (B, V)
        self.last_logits, self.last_rows = logits, list(rows)
        toks = sampler.sample(logits, self.temperature).cpu().numpy()
        out = {}
        for i, r in enumerate(rows):
            req = self.requests[r]
            req.pending = int(toks[i])
            req.computed_hwm = max(req.computed_hwm, int(ctx[i]))
            out[r] = int(toks[i])
            if len(req.generated) >= req.max_new:
                req.state = DONE
        self.stats["steps"] += 1
        self.stats["decode_time"] += time.perf_counter() - t0
        return out

    def _attend(self, qb, k_pool, v_pool, window, tail_pages, tail_base,
                q_pos):
        plan, prepared = self._plans[window]
        # frozen part: the backend's raw partials over all full pages;
        # the epilogue reduces them per query, attends each request's
        # growing last page, POR-merges the two and casts, in one launch
        parts = self._backend.parts(qb, k_pool, v_pool, plan, prepared,
                                    window=window)
        return por_mod.por_epilogue(qb, *parts, k_pool, v_pool, tail_pages,
                                    tail_base, q_pos, window=window)

    # ------------------------------------------------------------------ #
    # fused decode phase: one graph replay a token, host syncs only at
    # plan-epoch / admission / reclamation / completion boundaries
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def _decode_phase_fused(self) -> Dict[int, Optional[int]]:
        rows0 = self._active_rows()
        if not rows0:
            return {}
        t0 = time.perf_counter()
        # 1. append pending tokens (host ints after a sync or a prefill,
        #    otherwise placeholders for the in-flight step outputs)
        self._append_pending(rows0)
        rows = self._active_rows()
        if not rows:
            return {}
        # 2. plan lifecycle: a new epoch is a sync point (deferred tokens
        #    land; plans and the step's base are rebuilt, bucketed); within
        #    an epoch the step advances itself on the device
        if (self._plan_dirty
                or plan_mod.plan_key(self.forest, rows) != self._plan_key):
            self._fused_epoch(rows)
        elif len(self._deferred) >= self.fused_step.ring_size:
            self.flush_tokens()         # every pinned output slice is held
        # 3. one replay: layers, KV writes, attention, FFN, unembed, argmax
        t_d0 = time.perf_counter()
        host, event = self.fused_step()
        self.stats["decode_dispatch_time"] += time.perf_counter() - t_d0
        self.last_logits = self.fused_step.logits[:len(rows)]
        self.last_rows = list(rows)
        ent = _Deferred(host, event, list(rows))
        self._deferred.append(ent)
        out: Dict[int, Optional[int]] = {}
        done_any = False
        for i, r in enumerate(rows):
            req = self.requests[r]
            req.pending = PENDING_DEVICE
            self._pending_ref[r] = (ent, i)
            req.computed_hwm = max(req.computed_hwm,
                                   self.forest.context_len(r))
            out[r] = None
            if len(req.generated) >= req.max_new:
                req.state = DONE
                done_any = True
        self.stats["steps"] += 1
        self.stats["fused_calls"] += 1
        if done_any:
            # completion boundary: finished streams must be readable
            self.flush_tokens()
            for r in rows:
                if self.requests[r].state == DONE:
                    out[r] = self.requests[r].pending
        self.stats["decode_time"] += time.perf_counter() - t0
        return out

    def _fused_epoch(self, rows: List[int]) -> None:
        """Start a new plan epoch (the fused path's one sync point): plans
        bucketed to the row bucket, loaded with the step's base into the
        signature's fixed buffers (captured on first use)."""
        self.flush_tokens()
        t0 = time.perf_counter()
        B = len(rows)
        bucket = plan_mod.bucket_pow2(B)
        req_rows = {r: i for i, r in enumerate(rows)}
        ps = self.page_size
        truncate, tail, q_pos0 = {}, [], []
        for r in rows:
            leaf = self.forest.nodes[self.forest.leaf_of[r]]
            tp = (leaf.length - 1) // ps
            truncate[leaf.id] = max(0, tp * ps)
            tail.append((leaf.page_ids[tp], leaf.start_pos + tp * ps,
                         (leaf.length - 1) % ps))
            q_pos0.append(self.forest.context_len(r) - 1)
        build = (plan_mod.flash_plan if self._backend.plan_kind == "flash"
                 else plan_mod.build_plan)
        plans, host, sig = [], [], [bucket]
        for w in self._windows():
            p = build(self.forest, self.cost_model, self.num_lanes,
                      self.max_q, self.max_kv_per_task, req_rows=req_rows,
                      window=w, truncate=truncate)
            p = plan_mod.bucket_plan(p, bucket)
            cls, arrs = self._backend.host_arrays(p)
            plans.append(p)
            host.append((cls, arrs))
            sig.append((w, cls.__name__, tuple(a.shape for a in arrs)))
        sig = tuple(sig)
        self.bucket_signatures.add(sig)
        base = step_fn_mod.step_base(
            [self.requests[r].generated[-1] for r in rows], q_pos0, tail,
            bucket, self.pool.trash_page)
        self.stats["plan_time"] += time.perf_counter() - t0
        capture0 = self.fused_step.capture_time
        prepared = self.fused_step.epoch(sig, host, base)
        self.stats["capture_time"] += self.fused_step.capture_time - capture0
        self._plans = {w: (p, pa) for w, p, pa in
                       zip(self._windows(), plans, prepared)}
        self._plan_key = plan_mod.plan_key(self.forest, rows)
        self._plan_dirty = False
        self.stats["replans"] += 1

    # ------------------------------------------------------------------ #
    def run(self, max_steps: int = 64) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        self.flush_tokens()
        return {r: req.generated for r, req in self.requests.items()}

    def release(self, rid: int) -> None:
        self.flush_tokens()
        req = self.requests.pop(rid)
        self.admission.remove(rid)
        if req.state == WAITING:
            self._unpin(req)
            return
        if rid in self._prefilling:
            self._prefilling.remove(rid)
        if rid in self.forest.leaf_of:
            self._release_kv(rid)
            self._plan_dirty = True
