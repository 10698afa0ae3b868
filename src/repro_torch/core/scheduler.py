"""Task division + scheduling (paper §5.1) and admission control.

The port's copy of ``repro.core.scheduler``: the single-device solver,
its mesh-aware form (``divide_and_schedule_sharded``) and admission
control.  The optimisation problem — choose per-node
division counts ``b_k[i]`` and an assignment of subtasks to ``m`` parallel
lanes minimising the makespan — is NP-hard.  The paper's solver:

1. set ``b_q = 1`` (dividing the query dimension forfeits the shared KV
   read, the whole point of CoDec);
2. binary-search a lower bound ``cost_l`` on the makespan using the
   monotone feasibility test derived from Eq. 4;
3. cap ``b_k[i] <= ceil(C_est(n_q_i, n_i) / cost_l)`` (Eq. 5);
4. greedy (LPT) assignment of the divided subtasks to lanes.

On the H100 a lane is one group of thread blocks of the PAC kernel (one
block per KV head), so ``num_lanes`` is sized to fill the SMs.
``max_kv_per_task`` bounds the per-task page run and ``max_q_per_task``
the query tile (the kernel's shared-memory Q block).  On a mesh each data
shard walks its own lanes over the pages it holds, and a node whose pages
span shards is cut at the shard boundaries (a sequence split, merged
again by the cross-shard POR butterfly).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .cost_model import CostModel


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Undivided PAC task: one KV-forest node and its query set."""
    node_id: int
    n_q: int
    n: int            # KV tokens in the node


@dataclasses.dataclass(frozen=True)
class SubTask:
    """A divided slice: queries [q_lo,q_hi) of the node × KV [kv_lo,kv_hi)."""
    node_id: int
    q_lo: int
    q_hi: int
    kv_lo: int
    kv_hi: int
    cost: float

    @property
    def n_q(self) -> int:
        return self.q_hi - self.q_lo

    @property
    def n(self) -> int:
        return self.kv_hi - self.kv_lo


@dataclasses.dataclass
class Schedule:
    subtasks: List[SubTask]
    lane_of: List[int]                # subtask -> lane
    lane_costs: List[float]
    cost_lower_bound: float

    @property
    def makespan(self) -> float:
        return max(self.lane_costs) if self.lane_costs else 0.0


# --------------------------------------------------------------------- #
# admission control (serving under memory pressure)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Queue policy for the engine's admit/prefill phase.

    ``prefill_chunk``: per-step prefill token budget — ``None`` admits and
    prefills whole prompts at once, an ``int`` is a fixed chunk,
    ``"auto"`` derives the chunk from the cost model so one step's prefill
    work stays within ``balance_ratio`` times the estimated
    decode-attention work of the running batch (chunked prefill bounds
    time-between-tokens interference, not memory).

    ``reserve_pages``: low watermark — admission never dips the free list
    below it, keeping headroom for decode growth of the running batch.
    ``max_running``: cap on admitted (prefilling + decoding) requests.

    ``draft_reserve_pages``: extra per-running-request headroom the
    speculative engine keeps for draft-tree pages (each draft node
    occupies one page for the duration of a verify step).  Draft
    allocation itself is best-effort — the engine skips proposing
    rather than evicting to make room — so this watermark only shapes
    *admission*, keeping the pool from being packed so tight that
    speculation never gets to draft.

    ``cascade``: co-schedule waiting requests whose prompts share forest
    paths with a just-admitted request (group key = deepest shared node
    per ``tree.match_path``) so cascade prefill computes the shared span
    once for the whole group and batches the per-request suffix chunks
    into one dispatch (``repro``'s DESIGN §14).  ``max_cascade_group``
    bounds the group (admitted head + co-admitted partners).
    """

    prefill_chunk: Optional[Union[int, str]] = None
    reserve_pages: int = 0
    max_running: Optional[int] = None
    balance_ratio: float = 4.0
    max_auto_chunk: int = 16384
    draft_reserve_pages: int = 0
    cascade: bool = False
    max_cascade_group: int = 8

    def admission_reserve(self, num_running: int) -> int:
        """Free-page watermark admission must stay above."""
        return self.reserve_pages + self.draft_reserve_pages * num_running

    def min_working_pages(self, seq_len: int, page_size: int) -> int:
        """Smallest page count that can ever make progress on a sequence.

        Whole-prompt prefill (``prefill_chunk=None``) needs the full
        sequence resident, so the working set is every page.  Chunked
        prefill only needs one chunk plus the tail page it is growing
        into — a prompt larger than the pool is still servable as long
        as each chunk fits (earlier chunks' pages are reclaimable via
        preempt-and-recompute).  Admission raises ``MemoryError`` only
        when this floor exceeds the pool; anything above it just waits.
        """
        ps = max(int(page_size), 1)
        total = -(-max(seq_len, 1) // ps)
        pc = self.prefill_chunk
        if pc is None:
            return total
        chunk = ps if pc == "auto" else int(pc)
        return min(total, -(-max(min(seq_len, chunk), 1) // ps) + 1)

    def __post_init__(self):
        pc = self.prefill_chunk
        if isinstance(pc, str) and pc != "auto":
            raise ValueError(f"prefill_chunk must be int, None or 'auto', "
                             f"got {pc!r}")
        if isinstance(pc, int) and pc < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.max_cascade_group < 2:
            raise ValueError("max_cascade_group must be >= 2 (a group is "
                             "the admitted head plus >= 1 partner)")


class AdmissionController:
    """Deadline-aware wait queue + cost-model per-step prefill budget.

    Requests without a deadline queue FCFS; a request pushed with a
    ``deadline`` (absolute engine-clock time) is ordered
    earliest-deadline-first ahead of every later-deadline and every
    deadline-less request (EDF).  Ties (equal deadlines, and the whole
    no-deadline class) keep arrival order.

    Preempted requests re-enter at the *front* regardless of deadline
    (they were admitted earliest; resuming them first preserves
    completion order and bounds each request's preemption count).
    """

    def __init__(self, policy: AdmissionPolicy, cost_model,
                 page_size: int):
        self.policy = policy
        self.cost_model = cost_model
        self.page_size = max(int(page_size), 1)
        self.queue: Deque[int] = deque()
        self.deadline: Dict[int, float] = {}
        self._arrival: Dict[int, int] = {}
        self._seq = 0

    def __len__(self) -> int:
        return len(self.queue)

    def _key(self, rid: int) -> Tuple[float, int]:
        return (self.deadline.get(rid, float("inf")),
                self._arrival.get(rid, 0))

    def push(self, rid: int, deadline: Optional[float] = None) -> None:
        self._arrival[rid] = self._seq
        self._seq += 1
        if deadline is not None:
            self.deadline[rid] = float(deadline)
        key = self._key(rid)
        idx = next((i for i, q in enumerate(self.queue)
                    if self._key(q) > key), len(self.queue))
        self.queue.insert(idx, rid)

    def requeue(self, rid: int) -> None:
        """Re-enter a preempted request at the head of the queue."""
        self.queue.appendleft(rid)

    def peek(self) -> Optional[int]:
        return self.queue[0] if self.queue else None

    def pop(self) -> int:
        rid = self.queue.popleft()
        self._arrival.pop(rid, None)
        return rid

    def remove(self, rid: int) -> None:
        try:
            self.queue.remove(rid)
        except ValueError:
            pass
        self.deadline.pop(rid, None)
        self._arrival.pop(rid, None)

    def cascade_partners(self, anchor_nodes, key_of,
                         limit: Optional[int] = None) -> List[int]:
        """Waiting rids that cascade with a just-admitted request.

        ``anchor_nodes`` is the set of forest node ids on the admitted
        request's path; ``key_of(rid)`` maps a waiting request to its
        prompt's deepest shared forest node (``tree.match_path``), or
        ``None`` when it shares nothing worth cascading.  A waiting
        request whose key lands on the anchor path shares that prefix's
        uncached compute, so prefilling it now — ahead of its FCFS turn —
        turns N copies of the shared span into one.  Queue order is kept
        among partners; non-sharing requests keep their position.  The
        caller admits each partner (memory probes still apply) and calls
        :meth:`remove` for the ones it takes.
        """
        out: List[int] = []
        for rid in list(self.queue):
            if limit is not None and len(out) >= limit:
                break
            if key_of(rid) in anchor_nodes:
                out.append(rid)
        return out

    def prefill_budget(self, running_ctx: Sequence[int]) -> Optional[int]:
        """Prefill token budget for one engine step (``None`` = unlimited).

        In ``"auto"`` mode the budget is the largest page-aligned chunk
        whose estimated attention cost stays within ``balance_ratio`` times
        the running batch's decode-attention cost, so admitted prompts
        cannot monopolise a step.  With nothing decoding there is nothing
        to starve and the budget is unlimited.
        """
        pc = self.policy.prefill_chunk
        if pc is None:
            return None
        if isinstance(pc, int):
            return pc
        if not running_ctx:
            return None
        decode_cost = sum(self.cost_model(1, max(c, 1)) for c in running_ctx)
        target = self.policy.balance_ratio * decode_cost
        mean_ctx = int(sum(running_ctx) / len(running_ctx))
        chunk = self.page_size
        while (chunk * 2 <= self.policy.max_auto_chunk
               and self.cost_model(chunk * 2, mean_ctx + chunk * 2)
               <= target):
            chunk *= 2
        return chunk


# --------------------------------------------------------------------- #
# division
# --------------------------------------------------------------------- #
def _even_splits(total: int, parts: int,
                 quantum: int) -> List[Tuple[int, int]]:
    """Split [0,total) into <=parts contiguous quantum-aligned slices."""
    nquanta = -(-total // quantum)
    parts = max(1, min(parts, nquanta))
    base, extra = divmod(nquanta, parts)
    out, lo = [], 0
    for p in range(parts):
        take = (base + (1 if p < extra else 0)) * quantum
        hi = min(total, lo + take)
        out.append((lo, hi))
        lo = hi
    return [s for s in out if s[1] > s[0]]


def divide_task(task: TaskSpec, b_k: int, cost: CostModel,
                page_size: int, max_q: Optional[int] = None) -> List[SubTask]:
    q_slices = ([(0, task.n_q)] if not max_q or task.n_q <= max_q
                else _even_splits(task.n_q, -(-task.n_q // max_q), 1))
    kv_slices = _even_splits(task.n, b_k, page_size)
    out = []
    for (qlo, qhi) in q_slices:
        for (klo, khi) in kv_slices:
            out.append(SubTask(task.node_id, qlo, qhi, klo, khi,
                               cost(qhi - qlo, khi - klo)))
    return out


def naive_divide(tasks: Sequence[TaskSpec], k: int, cost: CostModel,
                 page_size: int, max_q: Optional[int] = None) -> List[SubTask]:
    """Fixed division count for every task (paper Fig. 10 baseline)."""
    out: List[SubTask] = []
    for t in tasks:
        out.extend(divide_task(t, k, cost, page_size, max_q))
    return out


# --------------------------------------------------------------------- #
# LPT scheduling
# --------------------------------------------------------------------- #
def lpt(subtasks: Sequence[SubTask],
        num_lanes: int) -> Tuple[List[int], List[float]]:
    order = sorted(range(len(subtasks)), key=lambda i: -subtasks[i].cost)
    lane_cost = [0.0] * num_lanes
    lane_of = [0] * len(subtasks)
    for i in order:
        lane = int(np.argmin(lane_cost))
        lane_of[i] = lane
        lane_cost[lane] += subtasks[i].cost
    return lane_of, lane_cost


# --------------------------------------------------------------------- #
# sharded scheduling: each data shard runs its own lanes
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ShardedSchedule:
    """Per-data-shard schedules and the merge term of sequence splits.

    ``shards[s]`` is the lane schedule data shard ``s`` runs;
    ``seq_splits`` counts nodes whose KV was cut at a shard boundary
    (their partials meet in the cross-shard POR merge); ``merge_cost`` is
    that merge's estimate, charged once on top of the slowest shard.
    """

    shards: List[Schedule]
    seq_splits: int
    merge_cost: float

    @property
    def makespan(self) -> float:
        local = max((s.makespan for s in self.shards), default=0.0)
        return local + self.merge_cost


def split_at_shard_boundaries(subs: Sequence[SubTask], node_pages,
                              shard_of_page, page_size: int,
                              cost: CostModel,
                              ) -> Tuple[List[List[SubTask]], int]:
    """Cut each subtask where its page run crosses a data-shard boundary.

    ``node_pages(node_id)`` returns the node's page-id list,
    ``shard_of_page(page_id)`` its owning shard.  Returns per-shard
    subtask lists and the number of nodes whose KV landed on more than one
    shard (sequence splits).  Pieces carry only their local compute cost:
    the caller charges the merge once a step
    (``ShardedSchedule.merge_cost``).
    """
    ps = page_size
    out: Dict[int, List[SubTask]] = {}
    node_shards: Dict[int, set] = {}
    for s in subs:
        pages = node_pages(s.node_id)
        p_lo = s.kv_lo // ps
        p_hi = -(-s.kv_hi // ps)
        runs: List[Tuple[int, int, int]] = []   # (shard, page_a, page_b)
        for pi in range(p_lo, p_hi):
            sh = shard_of_page(pages[pi])
            node_shards.setdefault(s.node_id, set()).add(sh)
            if runs and runs[-1][0] == sh:
                runs[-1] = (sh, runs[-1][1], pi + 1)
            else:
                runs.append((sh, pi, pi + 1))
        for sh, pa, pb in runs:
            lo = max(s.kv_lo, pa * ps)
            hi = min(s.kv_hi, pb * ps)
            out.setdefault(sh, []).append(
                SubTask(s.node_id, s.q_lo, s.q_hi, lo, hi,
                        cost(s.n_q, hi - lo)))
    seq_splits = sum(1 for shards in node_shards.values() if len(shards) > 1)
    shards = [out.get(sh, []) for sh in range(max(out, default=0) + 1)]
    return shards, seq_splits


def divide_and_schedule_sharded(tasks: Sequence[TaskSpec], cost: CostModel,
                                num_shards: int, lanes_per_shard: int,
                                page_size: int, node_pages, shard_of_page,
                                num_queries: int,
                                max_kv_per_task: Optional[int] = None,
                                max_q_per_task: Optional[int] = None,
                                replicated: Optional[set] = None,
                                num_merge_queries: Optional[int] = None,
                                ) -> ShardedSchedule:
    """Mesh-aware §5.1 solver: divide over ``num_shards *
    lanes_per_shard`` lanes, assign each subtask to the shard that holds
    its pages (cutting sequence splits at shard boundaries), then LPT
    each shard's subtasks over its own lanes.

    ``replicated`` names nodes whose KV every shard holds a copy of:
    their tasks are divided over one shard's lanes and the same subtask
    list is put first in every shard's schedule, so each shard computes
    those partials alike and they never enter the merge.  The makespan
    charges the merge once on top of the slowest shard, sized by
    ``num_merge_queries`` (the rows whose KV spans shards; default
    ``num_queries``).
    """
    replicated = replicated or set()
    rep_tasks = [t for t in tasks if t.node_id in replicated]
    loc_tasks = [t for t in tasks if t.node_id not in replicated]
    rep_subs: List[SubTask] = []
    if rep_tasks:
        # divided for one shard's lanes: every shard runs the same copy
        rep_subs = divide_and_schedule(
            rep_tasks, cost, lanes_per_shard, page_size,
            max_kv_per_task=max_kv_per_task,
            max_q_per_task=max_q_per_task).subtasks
    base = divide_and_schedule(loc_tasks, cost,
                               num_shards * lanes_per_shard,
                               page_size, max_kv_per_task=max_kv_per_task,
                               max_q_per_task=max_q_per_task)
    per_shard, seq_splits = split_at_shard_boundaries(
        base.subtasks, node_pages, shard_of_page, page_size, cost)
    per_shard += [[] for _ in range(num_shards - len(per_shard))]
    shards = []
    for subs in per_shard[:num_shards]:
        allsubs = list(rep_subs) + subs
        lane_of, lane_cost = lpt(allsubs, lanes_per_shard)
        shards.append(Schedule(allsubs, lane_of, lane_cost,
                               base.cost_lower_bound))
    n_merge = num_queries if num_merge_queries is None else num_merge_queries
    merge = (cost.merge_cost(num_shards, n_merge)
             if num_shards > 1 else 0.0)
    return ShardedSchedule(shards, seq_splits, merge)


# --------------------------------------------------------------------- #
# full solver
# --------------------------------------------------------------------- #
def divide_and_schedule(tasks: Sequence[TaskSpec], cost: CostModel,
                        num_lanes: int, page_size: int,
                        max_kv_per_task: Optional[int] = None,
                        max_q_per_task: Optional[int] = None,
                        refine_steps: int = 5) -> Schedule:
    """Paper §5.1 solver: bound, cap, divide, LPT; small grid refine."""
    tasks = [t for t in tasks if t.n > 0 and t.n_q > 0]
    if not tasks:
        return Schedule([], [], [0.0] * num_lanes, 0.0)

    full_costs = [cost(t.n_q, t.n) for t in tasks]

    def build(cost_l: float) -> List[SubTask]:
        subs: List[SubTask] = []
        for t, c in zip(tasks, full_costs):
            b_k = max(1, int(np.ceil(c / max(cost_l, 1e-12))))
            max_pages = -(-t.n // page_size)
            b_k = min(b_k, max_pages)
            if max_kv_per_task is not None:
                b_k = max(b_k, -(-t.n // max_kv_per_task))
            subs.extend(divide_task(t, b_k, cost, page_size, max_q_per_task))
        return subs

    # Eq. 4 lower bound: makespan >= max(avg work / lanes, single-page task)
    lo = max(max(cost(t.n_q, min(t.n, page_size)) for t in tasks),
             sum(full_costs) / num_lanes / 4)
    hi = max(full_costs)
    # binary search the smallest cost_l whose division could meet it
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        subs = build(mid)
        total = sum(s.cost for s in subs)
        feasible = (total / num_lanes <= mid
                    and max(s.cost for s in subs) <= mid)
        if feasible:
            hi = mid
        else:
            lo = mid
    cost_l = hi

    # grid refine around the bound (paper: "grid search the division
    # number ... choose the optimal division")
    best: Optional[Schedule] = None
    for mult in np.geomspace(0.5, 4.0, refine_steps):
        subs = build(cost_l * float(mult))
        lane_of, lane_cost = lpt(subs, num_lanes)
        sched = Schedule(subs, lane_of, lane_cost, cost_l)
        if best is None or sched.makespan < best.makespan:
            best = sched
    return best
