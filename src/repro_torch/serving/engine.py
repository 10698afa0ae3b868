"""Prefix-shared decode engine, eager path (port of
``repro.serving.engine.DecodeEngine``).

Continuous-batching greedy decode with CoDec as the attention backend:

* requests enter a FCFS **waiting queue**; a request is admitted when the
  pool holds the pages its whole prompt needs (finished requests' KV is
  reclaimed first), and its prompt is prefilled whole;
* prompts are radix-inserted into a ``PrefixForest``; already-cached
  nodes are *not* recomputed (prefill prefix reuse) — only the new leaf's
  KV is computed, attending to the gathered cached prefix;
* decode attention = **frozen CoDec plan** over all full pages (rebuilt
  exactly when ``core.plan.plan_key`` changes: batch membership, path
  structure, or a leaf crossing a page boundary) through the backend's
  raw ``parts`` — the CUDA PAC kernel by default — then one CUDA
  **POR epilogue** launch per layer: the per-query segment reduction of
  those partials, a **tail attention** over each request's growing last
  page, their POR merge and the cast.

Left for later slices: chunked prefill and preempt-and-recompute (a dry
pool raises ``MemoryError``), the fused single-launch step, sampling at
temperature > 0, the prefix cache, cascade prefill, faults, telemetry and
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
from ..core.scheduler import AdmissionController, min_working_pages
from ..kernels import por as por_mod, registry as registry_mod
from ..models import layers as L
from ..models.transformer import Transformer
from . import sampler
from .kv_cache import PagedKVPool

# request lifecycle states
WAITING, PREFILL, RUNNING, DONE = "waiting", "prefill", "running", "done"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    generated: List[int] = dataclasses.field(default_factory=list)
    pending: Optional[int] = None      # sampled, not yet appended
    max_new: int = 16
    state: str = WAITING
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
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.cost_model = CostModel(max(cfg.num_heads, 1),
                                    max(cfg.num_kv_heads, 1),
                                    max(cfg.head_dim, 1),
                                    bytes_per=self.pool.k.element_size(),
                                    page_size=page_size)
        self.admission = AdmissionController()
        self._prefilling: List[int] = []   # admitted, prompt not prefilled
        # plans keyed by window size (0 = full attention)
        self._plans: Dict[int, Tuple] = {}
        self._plan_dirty = True
        self._plan_key: Optional[tuple] = None
        # float32 logits of the last decode step (B, V)
        self.last_logits: Optional[torch.Tensor] = None
        # host-clock seconds: plan builds, per-step q-position advances
        # (re-prepare + re-upload of every plan array), prefill, decode
        self.stats = {"steps": 0, "replans": 0, "plan_time": 0.0,
                      "advance_time": 0.0, "prefill_time": 0.0,
                      "decode_time": 0.0, "prefill_tokens": 0,
                      "admitted": 0, "reclaimed": 0}

    # ------------------------------------------------------------------ #
    # request admission (admit phase) + whole-prompt prefill
    # ------------------------------------------------------------------ #
    def add_request(self, prompt: List[int], max_new: int = 16) -> int:
        """Enqueue a request; admits (and prefills) it at once when the
        pool has room, so under no pressure this is immediate prefill."""
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
        need = min_working_pages(len(prompt), self.page_size)
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

    def _active_rows(self) -> List[int]:
        return [r for r in sorted(self.requests)
                if self.requests[r].state == RUNNING]

    def _has_pages_for(self, req: Request) -> bool:
        seq = req.seq
        matched = self.forest.match_len(np.asarray(seq, np.int32))
        need = (-(-max(len(seq), 1) // self.page_size)
                - matched // self.page_size)
        return self.pool.num_free >= need

    def _admit_phase(self) -> None:
        """Finish stalled prefills, then admit waiting requests FCFS
        (head-of-line blocks) while the pool has room for their prompt."""
        for rid in list(self._prefilling):
            self._prefill_step(self.requests[rid])
        while len(self.admission):
            head = self.requests[self.admission.peek()]
            while not self._has_pages_for(head):
                if not self._reclaim_one(set()):
                    return                  # no free memory: keep waiting
            self.admission.pop()
            self._admit(head)
            self._prefill_step(head)

    def _admit(self, req: Request) -> None:
        """Radix-insert the request's sequence into the forest."""
        self.forest.insert_tokens(req.rid, np.asarray(req.seq, np.int32))
        req.state = PREFILL
        self._prefilling.append(req.rid)
        self.stats["admitted"] += 1

    # ------------------------------------------------------------------ #
    # reclamation (finished requests' KV only; preemption is not ported)
    # ------------------------------------------------------------------ #
    def _maybe_free_node(self, node) -> None:
        """Free a node once nothing references it (no requests, no
        children), then try its parent."""
        if node.id == tree_mod.ROOT_ID or node.id not in self.forest.nodes:
            return
        if node.requests or node.children:
            return
        if node.page_ids:
            self.pool.allocator.release(node.page_ids)
            node.page_ids = []
        parent = self.forest.nodes[node.parent]
        parent.children.remove(node.id)
        del self.forest.nodes[node.id]
        self._maybe_free_node(parent)

    def _release_kv(self, rid: int) -> None:
        """Drop a request's forest footprint (finished or released)."""
        for node in reversed(self.forest.path(rid)):
            if node.id not in self.forest.nodes:
                continue
            node.requests.remove(rid)
            self._maybe_free_node(node)
        del self.forest.leaf_of[rid]

    def _reclaim_one(self, exclude: Set[int]) -> bool:
        """Free the KV of one finished request; False if none is left."""
        for rid in sorted(self.requests):
            q = self.requests[rid]
            complete = (q.state == DONE
                        or (q.state == RUNNING
                            and len(q.generated) >= q.max_new))
            if (complete and not q.kv_freed and rid not in exclude
                    and rid in self.forest.leaf_of):
                self._release_kv(rid)
                q.state = DONE
                q.kv_freed = True
                self._plan_dirty = True
                self.stats["reclaimed"] += 1
                return True
        return False

    def _alloc_pages(self, n: int, exclude: Set[int]) -> Optional[List[int]]:
        """Allocate ``n`` pages, reclaiming finished KV; ``None`` when
        nothing more can be reclaimed."""
        while self.pool.num_free < n:
            if not self._reclaim_one(exclude):
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

    @torch.no_grad()
    def _prefill_step(self, req: Request) -> int:
        """Prefill the request's whole uncached span; returns tokens
        computed (0 = stalled on pages, retried next step).

        Attention KV of the cached prefix is reused (gathered from the
        paged pool).  A fully cached prompt recomputes only its final
        position so its logits exist.  When the sequence completes, the
        request joins the decode batch with its first token pending.
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
        if not self._ensure_pages_upto(rid, total):
            return 0
        t0 = time.perf_counter()
        dev = self.device
        tokens = torch.as_tensor(np.asarray(seq[start:total], np.int64),
                                 device=dev)
        Tn = tokens.shape[0]
        positions = torch.arange(start, total, device=dev)[None]  # (1, Tn)

        # node segments covering the span (for KV writes)
        segments = []        # (node, lo, hi) in span-local coordinates
        off = 0
        for node in path:
            lo = max(0, off - start)
            hi = min(total, off + node.length) - start
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
                      kv_positions=torch.arange(total, device=dev)[None])
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
        if req.pending is None:
            logits = self.model.unembed(x[:, -1])               # (1, V)
            req.pending = int(sampler.sample(logits, self.temperature)[0])
        self.stats["prefill_time"] += time.perf_counter() - t0
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
    def step(self) -> Dict[int, int]:
        """One engine step: admission + prefill, then append pending tokens
        and decode one token per running request."""
        self._admit_phase()
        return self._decode_phase_eager()

    def _grow_leaf_tail(self, r: int):
        """Ensure the request's leaf has a page slot for its newest
        token; returns the leaf."""
        leaf = self.forest.nodes[self.forest.leaf_of[r]]
        if -(-leaf.length // self.page_size) > len(leaf.page_ids):
            got = self._grow_node_pages(leaf, 1, exclude={r})
            if got is None:
                raise MemoryError(
                    f"KV pool exhausted growing request {r}: nothing left "
                    f"to reclaim (preemption is not implemented here)")
        return leaf

    def _append_pending(self, rows0: List[int]) -> None:
        """Append each running request's pending token to its leaf and
        grow tail pages."""
        for r in rows0:
            req = self.requests[r]
            if req.state != RUNNING or req.pending is None:
                continue
            self.forest.append_token(r, req.pending)
            req.generated.append(req.pending)
            req.pending = None
            self._grow_leaf_tail(r)

    @torch.no_grad()
    def _decode_phase_eager(self) -> Dict[int, int]:
        cfg = self.cfg
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
        x = self.model.embed_tokens(tok[:, None])              # (B, 1, d)

        for j, layer in enumerate(self.layers):
            h = L.apply_norm(layer.ln, x, cfg)
            la = self.attn_layer_idx[j]
            window = (cfg.sliding_window if layer.kind.mixer == "attn_local"
                      else 0)
            q, k_new, v_new = L.attn_project(layer.attn, cfg, h,
                                             q_pos[:, None])
            self.pool.write_tokens(la, tail_pages, tail_off,
                                   k_new[:, 0], v_new[:, 0])
            k_pool, v_pool = self.pool.layer_pools(la)
            o = self._attend(q[:, 0], k_pool, v_pool, window,
                             tail_pages, tail_base, q_pos)
            x = x + L.dense(layer.attn.wo,
                            o.reshape(B, 1, cfg.num_heads * cfg.head_dim))
            x = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)

        logits = self.model.unembed(x)[:, 0]                  # (B, V)
        self.last_logits = logits
        toks = sampler.sample(logits, self.temperature).cpu().numpy()
        out = {}
        for i, r in enumerate(rows):
            req = self.requests[r]
            req.pending = int(toks[i])
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
    def run(self, max_steps: int = 64) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return {r: req.generated for r, req in self.requests.items()}

    def release(self, rid: int) -> None:
        self.requests.pop(rid)
        self.admission.remove(rid)
        if rid in self._prefilling:
            self._prefilling.remove(rid)
        if rid in self.forest.leaf_of:
            self._release_kv(rid)
            self._plan_dirty = True
