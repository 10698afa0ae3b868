"""Decode-plan compiler: forest + schedule -> static-shape kernel arrays.

The port's copy of ``repro.core.plan``: single-device plans and the
mesh's per-shard plans (``build_sharded_plan``).  It runs on
the host every few decoding steps, not every step, and its output — a
``DecodePlan`` of flat int32 arrays — drives both the CUDA PAC kernel
(which reads the step arrays from global memory) and the plain PyTorch
implementation (which reads the task-major arrays).

Layout produced:

* **step-major** (for the PAC kernel): ``(num_lanes, max_steps)`` where a
  *step* is one KV page of one subtask.  Each lane is walked in order by
  one group of thread blocks; the scheduler balanced the lanes.  Per-step
  arrays give the task id, global page id, page validity/first/last flags,
  the page's base position and valid token count.
* **task-major** (for the torch impl + the reduction): per-task page
  tables, query gather lists, query counts/positions, and flattened
  segment ids mapping each (task, q-slot) partial to its query row (or to
  the trash segment ``num_queries`` when the slot is padding).

Partial outputs are indexed ``[task, q_slot]``; one extra trash task row
absorbs lane padding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .cost_model import CostModel
from .scheduler import (Schedule, SubTask, TaskSpec, _even_splits,
                        divide_and_schedule, lpt)
from .tree import PrefixForest


@dataclasses.dataclass
class DecodePlan:
    # sizes
    num_queries: int
    num_tasks: int            # real tasks (trash row excluded)
    num_lanes: int
    max_steps: int            # steps per lane (padded)
    max_q: int                # query slots per task
    max_pages: int            # pages per task (task-major arrays)
    page_size: int

    # step-major (num_lanes, max_steps)
    step_task: np.ndarray     # task id; padding -> lane's last task or trash
    step_page: np.ndarray     # global page id into the KV pool
    step_valid: np.ndarray    # 1 if this step does real work
    step_first: np.ndarray    # 1 on a subtask's first page
    step_last: np.ndarray     # 1 on a subtask's last page
    step_pos: np.ndarray      # absolute position of the page's first token
    step_kvlen: np.ndarray    # valid tokens in this page (1..page_size)

    # task-major (num_tasks [+1 trash], ...)
    task_qnum: np.ndarray     # (T,) valid queries of the task
    task_npages: np.ndarray   # (T,)
    task_kvlen: np.ndarray    # (T,) total KV tokens of the task slice
    task_pos: np.ndarray      # (T,) absolute position of first token
    task_pages: np.ndarray    # (T, max_pages) global page ids (pad 0)
    q_gather: np.ndarray      # (T, max_q) query rows (pad 0)
    q_pos: np.ndarray         # (T, max_q) absolute position of each query

    # reduction: flattened (T * max_q) partial -> segment id (query row,
    # or num_queries for padding slots)
    seg_ids: np.ndarray

    # bookkeeping / diagnostics
    makespan: float = 0.0
    lane_costs: Optional[List[float]] = None
    subtasks: Optional[List[SubTask]] = None

    @property
    def grid_steps(self) -> int:
        return self.num_lanes * self.max_steps

    def stats(self) -> Dict[str, float]:
        valid = float(self.step_valid.sum())
        return dict(num_tasks=self.num_tasks,
                    grid_steps=self.grid_steps,
                    valid_steps=valid,
                    grid_occupancy=valid / max(self.grid_steps, 1),
                    makespan=self.makespan,
                    lane_imbalance=(max(self.lane_costs) /
                                    (sum(self.lane_costs) / len(self.lane_costs))
                                    if self.lane_costs and sum(self.lane_costs) > 0
                                    else 1.0))


def _node_queries(node, active: Optional[set]) -> List[int]:
    """Sorted request ids of a node, filtered to the active batch."""
    if active is None:
        return sorted(node.requests)
    return [r for r in sorted(node.requests) if r in active]


def tasks_from_forest(forest: PrefixForest,
                      truncate: Optional[Dict[int, int]] = None,
                      active: Optional[set] = None) -> List[TaskSpec]:
    """``truncate`` maps node id -> effective length (engine uses this to
    exclude each leaf's growing tail page from the frozen plan);
    ``active`` restricts query sets to the live batch (finished requests
    keep their KV until released but receive no more attention)."""
    out = []
    for n in forest.real_nodes():
        ln = n.length if truncate is None else truncate.get(n.id, n.length)
        nq = len(_node_queries(n, active))
        if ln > 0 and nq > 0:
            out.append(TaskSpec(n.id, nq, ln))
    return out


def plan_key(forest: PrefixForest, rows: Sequence[int]) -> tuple:
    """Hashable signature of everything a frozen plan depends on.

    A cached plan stays valid exactly while this key is unchanged; the
    engine rebuilds when it differs.  The key captures every invalidation
    source in one place:

    * **batch membership** — the ordered active row set (arrivals,
      completions, *and evictions* all change it);
    * **path structure** — the node ids along each active request's
      prefix path (radix splits from new admissions, and node deletions
      from eviction/release, change them);
    * **tail boundary** — each leaf's full-page count: the plan truncates
      the growing last page out, so it survives in-page growth and dies
      when a leaf crosses a page boundary.

    Per-step query-position advance is handled separately (the engine's
    ``_advance_qpos``), not by rebuilding.
    """
    ps = forest.block_size
    out = []
    for r in rows:
        path = forest.path(r)
        leaf = path[-1] if path else None
        tail = 0 if leaf is None else max(0, (leaf.length - 1) // ps)
        out.append((r, tuple(n.id for n in path), tail))
    return tuple(out)


def assign_dense_pages(forest: PrefixForest) -> int:
    """Lay out every node's pages consecutively in a fresh pool.

    Returns the pool size in pages.  (The serving engine instead assigns
    pages through the paged KV-cache manager; this helper is for tests and
    benchmarks that build a pool directly from a forest.)
    """
    ps = forest.block_size
    next_page = 0
    for node in forest.real_nodes():
        npages = -(-node.length // ps)
        node.page_ids = list(range(next_page, next_page + npages))
        next_page += npages
    return max(next_page, 1)


def build_plan(forest: PrefixForest,
               cost_model: CostModel,
               num_lanes: int = 2,
               max_q: int = 64,
               max_kv_per_task: Optional[int] = 4096,
               schedule: Optional[Schedule] = None,
               req_rows: Optional[Dict[int, int]] = None,
               window: int = 0,
               truncate: Optional[Dict[int, int]] = None) -> DecodePlan:
    """Compile a forest into a DecodePlan.

    ``req_rows`` maps request id -> row in the stacked query tensor
    (defaults to sorted request-id order).  ``window``>0 drops KV pages
    wholly invisible to every query of a task under a sliding window (the
    in-kernel mask handles the page-boundary remainder).
    """
    ps = forest.block_size
    if req_rows is None:
        req_rows = {r: i for i, r in enumerate(forest.request_ids)}
    active = set(req_rows)
    nq_total = len(req_rows)

    tasks = tasks_from_forest(forest, truncate, active)
    if schedule is None:
        schedule = divide_and_schedule(
            tasks, cost_model, num_lanes, ps,
            max_kv_per_task=max_kv_per_task, max_q_per_task=max_q)
    subs = schedule.subtasks
    node_by_id = {n.id: n for n in forest.real_nodes()}

    # --- optional sliding-window pruning -------------------------------
    if window > 0:
        kept: List[SubTask] = []
        for s in subs:
            node = node_by_id[s.node_id]
            qs = _node_queries(node, active)[s.q_lo:s.q_hi]
            # a kv position p is visible to query at pos qp iff p > qp-window,
            # so a page is invisible to every query of the task only below
            # the smallest query's window.  (``repro`` prunes against the
            # largest position, which drops KV that a shorter query of the
            # same task still sees.)
            min_qpos = min(forest.context_len(r) - 1 for r in qs)
            lo_vis = min_qpos - window + 1
            task_lo = node.start_pos + s.kv_lo
            task_hi = node.start_pos + s.kv_hi
            if task_hi <= lo_vis:
                continue  # entirely out of every query's window
            new_lo = max(task_lo, (lo_vis // ps) * ps)  # page-aligned clamp
            kept.append(SubTask(s.node_id, s.q_lo, s.q_hi,
                                new_lo - node.start_pos,
                                s.kv_hi, s.cost))
        subs = kept
        lane_of, _ = _relane(subs, schedule, num_lanes)
    else:
        lane_of = schedule.lane_of

    num_tasks = len(subs)
    trash = num_tasks  # extra row for padding flushes

    # --- task-major arrays ---------------------------------------------
    max_pages = 1
    per_task_pages: List[List[int]] = []
    for s in subs:
        node = node_by_id[s.node_id]
        p_lo = s.kv_lo // ps
        p_hi = -(-s.kv_hi // ps)
        pages = node.page_ids[p_lo:p_hi]
        assert len(pages) == p_hi - p_lo, (
            f"node {s.node_id} pages not materialised")
        per_task_pages.append(pages)
        max_pages = max(max_pages, len(pages))

    T = num_tasks + 1
    task_qnum = np.zeros(T, np.int32)
    task_npages = np.zeros(T, np.int32)
    task_kvlen = np.zeros(T, np.int32)
    task_pos = np.zeros(T, np.int32)
    task_pages = np.zeros((T, max_pages), np.int32)
    q_gather = np.zeros((T, max_q), np.int32)
    q_pos = np.zeros((T, max_q), np.int32)
    seg_ids = np.full(T * max_q, nq_total, np.int32)

    for t, s in enumerate(subs):
        node = node_by_id[s.node_id]
        qs = _node_queries(node, active)[s.q_lo:s.q_hi]
        rows = [req_rows[r] for r in qs]
        nq = len(rows)
        assert nq <= max_q
        task_qnum[t] = nq
        task_npages[t] = len(per_task_pages[t])
        task_kvlen[t] = s.kv_hi - s.kv_lo
        task_pos[t] = node.start_pos + s.kv_lo
        task_pages[t, :len(per_task_pages[t])] = per_task_pages[t]
        q_gather[t, :nq] = rows
        # position index of the request's newest token (cache already
        # contains it): mask `pos <= q_pos` admits the whole cached path
        q_pos[t, :nq] = [forest.context_len(r) - 1 for r in qs]
        seg_ids[t * max_q: t * max_q + nq] = rows

    # --- step-major arrays ----------------------------------------------
    lanes: List[List[int]] = [[] for _ in range(num_lanes)]
    for i, lane in enumerate(lane_of):
        lanes[lane].append(i)
    lane_steps = [sum(len(per_task_pages[t]) for t in lane) for lane in lanes]
    S = max(max(lane_steps), 1) if lane_steps else 1

    step_task = np.full((num_lanes, S), trash, np.int32)
    step_page = np.zeros((num_lanes, S), np.int32)
    step_valid = np.zeros((num_lanes, S), np.int32)
    step_first = np.zeros((num_lanes, S), np.int32)
    step_last = np.zeros((num_lanes, S), np.int32)
    step_pos = np.zeros((num_lanes, S), np.int32)
    step_kvlen = np.ones((num_lanes, S), np.int32)

    for l, lane in enumerate(lanes):
        i = 0
        for t in lane:
            pages = per_task_pages[t]
            kv_total = int(task_kvlen[t])
            for j, pg in enumerate(pages):
                step_task[l, i] = t
                step_page[l, i] = pg
                step_valid[l, i] = 1
                step_first[l, i] = int(j == 0)
                step_last[l, i] = int(j == len(pages) - 1)
                step_pos[l, i] = int(task_pos[t]) + j * ps
                step_kvlen[l, i] = min(ps, kv_total - j * ps)
                i += 1
        # padding: repeat lane's last real task so spurious output flushes
        # rewrite already-final content (trash row if the lane is empty)
        if i > 0:
            step_task[l, i:] = step_task[l, i - 1]
            step_page[l, i:] = step_page[l, i - 1]

    return DecodePlan(
        num_queries=nq_total, num_tasks=num_tasks, num_lanes=num_lanes,
        max_steps=S, max_q=max_q, max_pages=max_pages, page_size=ps,
        step_task=step_task, step_page=step_page, step_valid=step_valid,
        step_first=step_first, step_last=step_last, step_pos=step_pos,
        step_kvlen=step_kvlen,
        task_qnum=task_qnum, task_npages=task_npages, task_kvlen=task_kvlen,
        task_pos=task_pos, task_pages=task_pages,
        q_gather=q_gather, q_pos=q_pos, seg_ids=seg_ids,
        makespan=schedule.makespan, lane_costs=list(schedule.lane_costs),
        subtasks=list(subs))


def build_verify_plan(forest: PrefixForest,
                      cost_model: CostModel,
                      query_rows: Dict[int, int],
                      num_lanes: int = 2,
                      max_q: int = 64,
                      max_kv_per_task: Optional[int] = 4096,
                      window: int = 0,
                      kind: str = "codec") -> DecodePlan:
    """Compile a multi-query *verification* plan (speculative decoding).

    A verification step scores every branch head of every request's
    draft tree in one dispatch: each draft node carries a virtual query
    id attached to it (``PrefixForest.attach_request``), and
    ``query_rows`` maps every query id — the request's committed-tail
    base query plus one per draft node — to its row in the stacked
    query tensor.  Sibling branches share all ancestor KV, so the plan's
    shared-node tasks read the trunk once for all branch-head lanes
    (the paper's §2.5 speculative-verification workload).

    Unlike the engine's frozen decode plan, nothing is truncated: the
    growing tail pages and the one-token draft nodes are all covered —
    the verify dispatch writes their KV before attending, and the plan
    is rebuilt every speculative step anyway (the draft tree changes),
    so there is no frozen/tail split: the epilogue runs without a tail
    (``por.por_epilogue(tail=False)``).  ``kind`` selects the planner
    family the backend declares (``AttentionBackend.plan_kind``):
    ``"codec"`` shares prefix tasks, ``"flash"`` clones per-query tasks.
    """
    build = flash_plan if kind == "flash" else build_plan
    return build(forest, cost_model, num_lanes, max_q, max_kv_per_task,
                 req_rows=query_rows, window=window)


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= ``n`` (at least ``floor``).

    All shape bucketing routes through here (the step axis of every plan,
    and the fused step's rows, tasks and pages), so each launch or graph
    shape changes only O(log n) times as the batch grows.
    """
    if n <= 0:
        return floor
    return max(floor, 1 << (n - 1).bit_length())


def bucket_plan(plan: DecodePlan, num_rows: int,
                steps: Optional[int] = None, tasks: Optional[int] = None,
                pages: Optional[int] = None) -> DecodePlan:
    """Bucket every plan shape the fused decode step sees.

    ``pad_plan`` already buckets the step axis; this additionally buckets
    the task and per-task page axes to powers of two and re-targets the
    query dimension at ``num_rows`` — the *bucketed* batch-row count the
    engine stacks its queries to — so one captured step serves every plan
    rebuild (arrivals, completions) whose buckets are unchanged.

    Padded task rows clone the trash row (``task_qnum == 0``, pages 0),
    so they are inert: every implementation masks dead query slots and
    the segment reduction drops anything mapped to the trash segment.
    ``seg_ids`` entries pointing at the old trash segment
    (``plan.num_queries``) are re-pointed at ``num_rows``; real query
    rows are below the live batch size and therefore below ``num_rows``.

    Explicit ``steps`` / ``tasks`` / ``pages`` targets override the
    per-axis powers of two: the sharded planner buckets every shard to
    the common maxima, so the shards' arrays share one shape.
    """
    if num_rows < plan.num_queries:
        raise ValueError(
            f"bucketed rows {num_rows} < live queries {plan.num_queries}")
    p = pad_plan(plan, steps=steps or bucket_pow2(plan.max_steps),
                 tasks=tasks or bucket_pow2(plan.task_qnum.shape[0]))
    pages = pages or bucket_pow2(p.max_pages)
    if pages < p.max_pages:
        raise ValueError("page bucket target smaller than plan")
    task_pages = np.zeros((p.task_qnum.shape[0], pages), np.int32)
    task_pages[:, :p.max_pages] = p.task_pages
    seg = p.seg_ids.copy()
    seg[seg == p.num_queries] = num_rows
    return dataclasses.replace(p, max_pages=pages, task_pages=task_pages,
                               seg_ids=seg, num_queries=num_rows)


def pad_plan(plan: DecodePlan, steps: Optional[int] = None,
             tasks: Optional[int] = None) -> DecodePlan:
    """Pad step/task arrays to bucketed sizes so launch shapes are reused
    across plan rebuilds (padding steps are invalid; padded task rows are
    trash clones)."""
    S0, T0 = plan.max_steps, plan.task_qnum.shape[0]
    S = steps or 1 << (S0 - 1).bit_length()
    T = tasks or T0
    if S < S0 or T < T0:
        raise ValueError("pad target smaller than plan")

    def pad_step(a):
        return np.pad(a, ((0, 0), (0, S - S0)), mode="edge")

    def pad_task(a):
        pad = [(0, T - T0)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, pad, mode="edge")

    step_valid = np.pad(plan.step_valid, ((0, 0), (0, S - S0)))
    step_first = np.pad(plan.step_first, ((0, 0), (0, S - S0)))
    step_last = np.pad(plan.step_last, ((0, 0), (0, S - S0)))
    seg = np.full(T * plan.max_q, plan.num_queries, np.int32)
    seg[:plan.seg_ids.shape[0]] = plan.seg_ids
    return dataclasses.replace(
        plan, max_steps=S,
        step_task=pad_step(plan.step_task), step_page=pad_step(plan.step_page),
        step_valid=step_valid, step_first=step_first, step_last=step_last,
        step_pos=pad_step(plan.step_pos), step_kvlen=pad_step(plan.step_kvlen),
        task_qnum=pad_task(plan.task_qnum),
        task_npages=pad_task(plan.task_npages),
        task_kvlen=pad_task(plan.task_kvlen),
        task_pos=pad_task(plan.task_pos),
        task_pages=pad_task(plan.task_pages),
        q_gather=pad_task(plan.q_gather), q_pos=pad_task(plan.q_pos),
        seg_ids=seg)


# --------------------------------------------------------------------- #
# mesh-aware plan partitioning
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ShardedPlan:
    """One ``DecodePlan`` per data shard, bucketed to common shapes.

    Every shard's arrays share the same (steps, tasks, pages, rows)
    buckets, so one step signature serves them all; page ids inside each
    shard's arrays are local (rows of that shard's pool block, its trash
    row included).  Queries are shared: every shard's ``seg_ids`` target
    the global query rows, and the cross-shard POR merge folds the
    shards' partials.
    """

    shards: List[DecodePlan]
    num_shards: int
    makespan: float            # slowest shard + merge term
    merge_cost: float          # cross-shard POR merge estimate (s)
    seq_splits: int            # nodes cut at a shard boundary
    # merge_rows[r]: row r's partials differ across shards and must be
    # merged; row_shards[s, r]: shard s computes a shard-local
    # (non-replicated) contribution to row r.  The engine ORs tail
    # ownership into row_shards and derives the packed gather / scatter
    # indices and the contributor vector from these.
    merge_rows: Optional[np.ndarray] = None
    row_shards: Optional[np.ndarray] = None
    replicated: Optional[set] = None   # node ids planned from replicas

    def stats(self) -> Dict[str, float]:
        local = [p.makespan for p in self.shards]
        occ = [p.stats()["grid_occupancy"] for p in self.shards]
        return dict(num_shards=self.num_shards, makespan=self.makespan,
                    merge_cost=self.merge_cost, seq_splits=self.seq_splits,
                    shard_makespans=local,
                    shard_imbalance=(max(local) / (sum(local) / len(local))
                                     if local and sum(local) > 0 else 1.0),
                    mean_grid_occupancy=sum(occ) / max(len(occ), 1),
                    replicated_nodes=len(self.replicated or ()),
                    merge_row_count=(int(self.merge_rows.sum())
                                     if self.merge_rows is not None else 0))


def replicated_node_set(forest: PrefixForest, num_shards: int,
                        req_rows: Dict[int, int]) -> tuple:
    """Nodes plannable from replicas, and per request whether its whole
    path is replicated.

    A node is a candidate when it holds a complete replica set
    (``node.meta["replicas"]``, one page list per shard).  A candidate is
    usable only if every query row it serves has its entire path (and so
    its leaf tail) replicated: a row with a shard-local contribution must
    be merged across shards, and the merge would count a contribution
    computed alike on every shard once per shard.  So a fixpoint drops
    candidates that serve a row not fully replicated, recomputes the row
    flags and repeats; the dropped candidates are planned from their
    primary pages (their replicas stay resident).  Returns ``(node_ids,
    {request_id: fully_replicated})``.
    """
    active = set(req_rows)
    R = {n.id for n in forest.real_nodes()
         if len(n.meta.get("replicas", {})) == num_shards}
    full: Dict[int, bool] = {r: False for r in active}
    if not R:
        return set(), full
    while True:
        for r in active:
            path = forest.path(r)
            full[r] = bool(path) and all(n.id in R for n in path)
        r2 = set()
        for n in forest.real_nodes():
            if n.id in R:
                qs = _node_queries(n, active)
                if qs and all(full[q] for q in qs):
                    r2.add(n.id)
        if r2 == R:
            return R, full
        R = r2


def build_sharded_plan(forest: PrefixForest,
                       cost_model: CostModel,
                       num_shards: int,
                       page_stride: int,
                       num_lanes: int = 2,
                       max_q: int = 64,
                       max_kv_per_task: Optional[int] = 4096,
                       req_rows: Optional[Dict[int, int]] = None,
                       window: int = 0,
                       truncate: Optional[Dict[int, int]] = None,
                       num_rows: Optional[int] = None) -> ShardedPlan:
    """Compile a forest into one DecodePlan per data shard.

    ``page_stride`` is a shard's block of pool rows (``pages_per_shard +
    1``: the block's last row is the shard's trash page), so global page
    row ``g`` lives on shard ``g // page_stride`` as local row ``g %
    page_stride``.  Division runs over ``num_shards * num_lanes`` lanes;
    subtasks are cut at shard boundaries (a sequence split of the node,
    whose partials meet again in the cross-shard POR merge); each shard's
    subtasks are then LPT-balanced over its own ``num_lanes`` lanes and
    compiled as single-device plans.

    Replicated nodes (``replicated_node_set``) are planned once and put
    first, alike, in every shard's schedule; each shard's page arrays map
    them to its own replica rows.  Rows whose whole path is replicated are
    computed alike on every shard and stay out of the merge; the others
    are listed in ``merge_rows`` / ``row_shards``, and the merge term is
    sized by their count.
    """
    from .scheduler import divide_and_schedule_sharded

    if req_rows is None:
        req_rows = {r: i for i, r in enumerate(forest.request_ids)}
    active = set(req_rows)
    tasks = tasks_from_forest(forest, truncate, active)
    node_by_id = {n.id: n for n in forest.real_nodes()}
    rows = num_rows if num_rows is not None else len(req_rows)

    rep_nodes, full_rep = replicated_node_set(forest, num_shards, req_rows)
    merge_mask = np.zeros(max(rows, 1), dtype=bool)
    for rid, row in req_rows.items():
        if row < rows and not full_rep.get(rid, False):
            merge_mask[row] = True

    sched = divide_and_schedule_sharded(
        tasks, cost_model, num_shards, num_lanes, forest.block_size,
        node_pages=lambda nid: node_by_id[nid].page_ids,
        shard_of_page=lambda g: g // page_stride,
        num_queries=len(req_rows),
        max_kv_per_task=max_kv_per_task, max_q_per_task=max_q,
        replicated=rep_nodes,
        num_merge_queries=int(merge_mask.sum()))

    # shard-local contributors per row (the engine ORs in tail owners);
    # listing a shard that contributes only the identity is harmless
    row_shards = np.zeros((num_shards, max(rows, 1)), dtype=bool)
    for s, sh in enumerate(sched.shards):
        for sub in sh.subtasks:
            if sub.node_id in rep_nodes:
                continue
            node = node_by_id[sub.node_id]
            for rid in _node_queries(node, active)[sub.q_lo:sub.q_hi]:
                row = req_rows[rid]
                if row < rows:
                    row_shards[s, row] = True

    shards = [build_plan(forest, cost_model, num_lanes, max_q,
                         max_kv_per_task, schedule=s, req_rows=req_rows,
                         window=window, truncate=truncate)
              for s in sched.shards]

    # per-shard page localisation, global row -> the shard's local row:
    # g % page_stride, but a replicated node's rows (``page_ids`` holds
    # the primary's) map to the shard's own replica rows
    remaps = []
    for s in range(num_shards):
        remap = (np.arange(num_shards * page_stride, dtype=np.int32)
                 % page_stride)
        for nid in rep_nodes:
            node = node_by_id[nid]
            rep = node.meta["replicas"][s]
            remap[np.asarray(node.page_ids, dtype=np.int64)] = (
                np.asarray(rep, dtype=np.int32) % page_stride)
        remaps.append(remap)

    # common buckets, so every shard's arrays take one shape
    steps_t = bucket_pow2(max(p.max_steps for p in shards))
    tasks_t = bucket_pow2(max(p.task_qnum.shape[0] for p in shards))
    pages_t = bucket_pow2(max(p.max_pages for p in shards))
    out = []
    for s, p in enumerate(shards):
        p = bucket_plan(p, rows, steps=steps_t, tasks=tasks_t,
                        pages=pages_t)
        # padding and other shards' entries fold into [0, stride) too:
        # they are masked (step_valid = 0, kvlen bounds), so reading a
        # wrong but resident local page is harmless
        p.step_page = remaps[s][p.step_page]
        p.task_pages = remaps[s][p.task_pages]
        out.append(p)
    return ShardedPlan(out, num_shards, sched.makespan, sched.merge_cost,
                       sched.seq_splits, merge_rows=merge_mask,
                       row_shards=row_shards, replicated=rep_nodes)


def _relane(subs: Sequence[SubTask], schedule: Schedule, num_lanes: int):
    """Re-run LPT after window pruning changed the subtask list."""
    return lpt(subs, num_lanes)


def flash_plan(forest: PrefixForest, cost_model: CostModel,
               num_lanes: int = 2, max_q: int = 64,
               max_kv_per_task: Optional[int] = 4096,
               **kw) -> DecodePlan:
    """FlashDecoding-equivalent plan: NO prefix combining.

    Every request is planned as its own chain of per-node slices (each task
    has n_q = 1), i.e. the shared prefix KV is read once per request — the
    baseline CoDec is compared against.  Division/scheduling still applies
    (FlashDecoding also splits the KV dimension).  Takes ``build_plan``'s
    keywords (``req_rows``, ``window``, ``truncate``).
    """
    fake_subs: List[SubTask] = []
    truncate = kw.get("truncate")
    req_rows = kw.get("req_rows")
    active = set(req_rows) if req_rows is not None else None
    # per-(request, node) single-query tasks, one query slice each
    for node in forest.real_nodes():
        ln = node.length if truncate is None else truncate.get(node.id,
                                                               node.length)
        if ln <= 0:
            continue
        for qi in range(len(_node_queries(node, active))):
            fake_subs.append(SubTask(node.id, qi, qi + 1, 0, ln,
                                     cost_model(1, ln)))
    sched = _schedule_fixed_qslices(fake_subs, cost_model, num_lanes,
                                    forest.block_size, max_kv_per_task)
    return build_plan(forest, cost_model, num_lanes, max_q,
                      max_kv_per_task, schedule=sched, **kw)


def _schedule_fixed_qslices(subs: List[SubTask], cost: CostModel,
                            num_lanes: int, page_size: int,
                            max_kv: Optional[int]) -> Schedule:
    """Split over-long KV slices page-aligned, keep the query slices, LPT."""
    out: List[SubTask] = []
    for s in subs:
        if max_kv is not None and s.n > max_kv:
            for (lo, hi) in _even_splits(s.n, -(-s.n // max_kv), page_size):
                out.append(SubTask(s.node_id, s.q_lo, s.q_hi, lo, hi,
                                   cost(s.n_q, hi - lo)))
        else:
            out.append(s)
    lane_of, lane_cost = lpt(out, num_lanes)
    return Schedule(out, lane_of, lane_cost, 0.0)
