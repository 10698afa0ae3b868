"""Decode-plan compiler: forest + schedule -> static-shape kernel arrays.

The port's copy of ``repro.core.plan`` (single-device plans).  It runs on
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
            # a kv position p is visible to query at pos qp iff p > qp-window
            max_qpos = max(forest.context_len(r) - 1 for r in qs)
            lo_vis = max_qpos - window + 1
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


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= ``n`` (at least ``floor``).

    The engine pads the step axis of every plan to such a bucket so the
    PAC launch shape changes only O(log n) times as the batch grows.
    """
    if n <= 0:
        return floor
    return max(floor, 1 << (n - 1).bit_length())


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
