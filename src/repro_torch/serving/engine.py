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

The request lifecycle (``repro``'s DESIGN §11-§12):

* ``temperature > 0`` samples each row from ``repro``'s threefry stream
  (``sampler.py``); the engine's key is a device buffer split once per
  completed prefill and once per decode step, inside the graph on the
  fused path;
* ``cache=`` keeps finished requests' prefix nodes resident (``cache.py``):
  they detach from the forest, a later request matches them by value and
  skips their prefill, TTL/LRU bound residency, and cached nodes are the
  first reclaim tier;
* ``add_request(on_token=, on_done=)`` streams tokens as their values
  land on the host and closes each stream once with its terminal reason;
  a raising callback fails only its own request;
* ``cancel``, ``deadline_s`` / ``max_queue_s`` on an injectable clock
  (EDF admission), the terminal states ``CANCELLED`` / ``TIMED_OUT`` /
  ``FAILED`` with their KV released, ``kv_exhausted`` for a lone request
  that outgrows the pool, ``faults=`` (``faults.py``) with the dispatch
  degradation ladder, the NaN guard's quarantine, ``check()`` and
  ``shutdown()``.

Telemetry and cascade prefill (``repro``'s DESIGN §13-§14):

* ``telemetry=True`` (or a ``telemetry.Telemetry``) keeps a metrics
  registry in step with the engine's stats and emits per-request and
  engine spans on the engine clock (Chrome trace JSON); ``profile_every=N``
  makes every Nth fused step synchronize after its graph replay and split
  into host preparation, launch and device wait, leaving the other steps
  as they are;
* ``cascade=True`` prefills requests that share an unfilled forest node as
  one group: the shared span once, through the group's lead, then the
  members' suffix chunks in one padded batch; admitting a head-of-line
  request pulls its cascade partners out of the queue.  With Mamba
  layers the lead hands its carried mid-node SSM state to every member,
  and the suffixes take the per-request path (``repro``'s ``has_mamba``
  branches); a replicated node's KV lands in every replica's pages.

Mamba-2 and hybrid models (``repro``'s SSM paths, ``models/mamba.py``): a
Mamba layer keeps no KV.  Each request carries its own float32 ``conv`` /
``ssm`` state per Mamba layer (``mamba_state[layer][rid]``; ``_mamba_pos``
for a request part-way through its prefill), and prefill caches the state
at every shared node end it reaches (``node.meta["ssm"]``), so a sibling
or a preempted request resumes at the deepest cached node boundary instead
of recomputing the shared document.  Attention layers of a hybrid still
share pages through PAC.  Eager decode steps the rows' states together and
writes them back per row; the fused step carries them in fixed buffers of
its bucket slot (``step_fn.FusedStep``), gathered at each plan epoch and
synced back at the next.  An attention-free model (mamba2) keeps
``repro``'s one placeholder pool layer, so the forest and the page
accounting behave as they do for attention: no plan is consumed and PAC is
never launched.

Tree-speculative decoding (``repro``'s DESIGN §10, ``speculation.py``):
``speculative=True`` (or a ``speculation.SpecConfig``) turns each decode
step into draft-propose / tree-verify / accept-rollback.  A self-drafting
n-gram proposer grows a draft tree of one-token forest nodes under each
request's leaf (one page each, best effort, never evicting), one verify
dispatch scores every branch head through a plan that covers every page
(``core.plan.build_verify_plan``: the backend's parts, then one epilogue
launch with no tail a layer; on the fused path one CUDA-graph replay,
``step_fn.SpecStep``), the host walks the tree greedily, the accepted
tokens' KV moves from the draft pages to the leaf (``copy_slots``) and
the rest rolls back.  Greedy streams are byte-identical to
non-speculative decode.  Greedy only, attention only, one shard (as in
``repro``, a mesh refuses it).

Mesh serving (``repro``'s DESIGN §9, ``distributed/``): ``mesh=`` (a
``distributed.decode_mesh(data, model)``) serves over a ``(data, model)``
grid of shards, fused only, through a shardable backend.  The pool shards
pages over ``data`` and KV heads over ``model``
(``distributed.ShardedKVPool``, one allocator a data shard; a node's pages
move to the next shard after ``seq_split_pages``), each data shard runs
its own plan (``core.plan.build_sharded_plan``: sequence splits cut at
shard boundaries), and the step (``distributed.ShardedStep``) merges the
rows that span shards with the POR butterfly and sums the head-parallel
output projection.  ``replicate=True`` copies hot short prefix nodes onto
every data shard when ``CostModel.replicate_gain`` says the saved merge
outweighs the extra reads (demoted first under pressure); ``calibrate=True``
synchronizes every mesh step to time it and refits the cost model's
coefficients from those steps at each plan epoch (``recalibrate``).  A
``decode_mesh`` places every shard on the engine's one device, so the
shards run one after another: the fitted coefficients describe that, not
a mesh of cards.  A ``distributed.process_mesh`` runs one engine a rank,
each holding its shard's slab (``RankKVPool``) and running its shard of
the step (``RankStep``); every rank runs this host logic on the same
inputs, compares a digest of each plan epoch (the faults fired
included) with the others (``MeshDivergenceError``), fits
``recalibrate`` to step times maxed over the ranks, and decides
deadlines and queue timeouts on rank 0's clock, broadcast to every rank
(each rank's own clock would part their admission order and timeouts).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import plan as plan_mod
from ..core import tree as tree_mod
from ..core.cost_model import CostModel
from ..core.scheduler import AdmissionController, AdmissionPolicy
from ..distributed.kv_pool import RankKVPool, ShardedKVPool
from ..distributed.mesh import ProcessMesh, digest
from ..distributed.step_fn import RankStep, ShardedStep, sharded_step_base
from ..kernels import por as por_mod, registry as registry_mod
from ..models import layers as L
from ..models import mamba as M
from ..models.transformer import Transformer
from . import faults as faults_mod
from . import sampler
from . import speculation as spec_mod
from . import step_fn as step_fn_mod
from . import telemetry as telemetry_mod
from .cache import CachePolicy, PrefixCache
from .faults import EngineInvariantError, InjectedFault, ResourceExhausted
from .kv_cache import PagedKVPool

# request lifecycle states
WAITING, PREFILL, RUNNING, DONE = "waiting", "prefill", "running", "done"
# terminal failure states: the request is over, its KV released, and its
# stream closed via on_done(rid, reason)
CANCELLED, TIMED_OUT, FAILED = "cancelled", "timed_out", "failed"
TERMINAL = frozenset({DONE, CANCELLED, TIMED_OUT, FAILED})

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
    on_token: Optional[Callable] = None  # streaming callback (rid, token)
    emitted: int = 0                   # tokens already streamed out
    on_done: Optional[Callable] = None   # stream-close callback (rid, reason)
    submit_t: float = 0.0              # engine-clock time at add_request
    deadline: Optional[float] = None   # absolute end-to-end deadline
    queue_deadline: Optional[float] = None  # absolute admission deadline
    finish_reason: Optional[str] = None
    notified: bool = False             # on_done already fired
    # telemetry: engine-clock times a committed token value first/last
    # became host-visible (None until the first one lands)
    first_tok_t: Optional[float] = None
    last_tok_t: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.state in TERMINAL

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
                 temperature: float = 0.0, seed: int = 0,
                 prefill_chunk=None, reserve_pages: int = 0,
                 max_running: Optional[int] = None,
                 cascade: bool = False, max_cascade_group: int = 8,
                 fused: bool = False, mesh=None, seq_split_pages: int = 0,
                 replicate: bool = False, calibrate: bool = False,
                 speculative=None, cache=None,
                 faults=None, nan_guard: bool = False,
                 check_every: int = 0, clock=None,
                 max_dispatch_retries: int = 4,
                 telemetry=None, device="cuda"):
        if cfg.encoder_layers:
            raise ValueError(f"{cfg.name}: the engine serves decoder-only "
                             f"archs")
        self.cfg = cfg
        self.device = torch.device(device)
        self.backend = backend
        self._backend = registry_mod.get(backend)
        self._check_kernel_shapes(page_size, mesh)
        self.model = model.to(self.device)
        if (cfg.sliding_window and not self._backend.supports_window
                and any(k.mixer == "attn_local"
                        for k in cfg.layer_pattern)):
            raise ValueError(f"backend {backend!r} cannot serve "
                             f"sliding-window layers")
        # ---- mesh serving (``repro``'s DESIGN §9, distributed/) -------- #
        # mesh != None serves over a (data, model) grid of shards: sharded
        # KV pool, per-shard plans, the sharded fused step
        self.mesh = mesh
        if mesh is not None:
            if not fused:
                raise ValueError("mesh serving runs only the fused step; "
                                 "pass fused=True")
            if not (self._backend.jit_safe and self._backend.shardable):
                raise ValueError(
                    f"backend {backend!r} is not shardable; choose one of "
                    f"{registry_mod.names(shardable=True)}")
            D, Mx = mesh.shape["data"], mesh.shape["model"]
            if D & (D - 1):
                raise ValueError(f"data axis must be a power of two "
                                 f"(POR butterfly), got {D}")
            if Mx > 1 and (cfg.num_heads % Mx or cfg.num_kv_heads % Mx):
                raise ValueError(
                    f"model axis {Mx} must divide heads "
                    f"({cfg.num_heads} q / {cfg.num_kv_heads} kv)")
            if torch.device(mesh.device) != self.device:
                raise ValueError(f"mesh on {mesh.device}, engine on "
                                 f"{self.device}")
        # a process mesh (one rank a shard): every rank runs this host
        # logic on the same inputs; the one value a rank reads for itself
        # and acts on, the clock, is rank 0's (``_mesh_clock``), and a
        # fault plan is a schedule by step, so every rank's injector
        # fires alike
        self._ranked = isinstance(mesh, ProcessMesh)
        # a running digest of the requests added and cancelled, which the
        # ranks compare at each plan epoch
        self._host_log = 0
        sampler.check_temperature(temperature)
        # ---- tree-speculative decoding (``repro``'s DESIGN §10) ------- #
        # speculative=True (defaults) or a SpecConfig: several tokens can
        # commit a verify dispatch when the self-drafting proposer guesses
        # right.  Greedy-only, attention-only and one shard
        if speculative is True:
            speculative = spec_mod.SpecConfig()
        self.spec: Optional[spec_mod.SpecConfig] = speculative or None
        if self.spec is not None:
            if temperature != 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only: acceptance "
                    "compares draft tokens against the argmax (lossless "
                    "speculative sampling is not implemented)")
            if any(k.mixer == "mamba" for k in cfg.layer_pattern):
                raise ValueError(
                    "speculative decoding needs KV-cache rollback; "
                    "recurrent (Mamba) state cannot be rolled back yet")
            if mesh is not None:
                raise ValueError(
                    "sharded speculation is not implemented; drop mesh= "
                    "or speculative=")
        self.proposer = (spec_mod.NGramProposer(self.spec)
                         if self.spec else None)
        # live draft trees by request; virtual branch-head query ids
        self._drafts: Dict[int, spec_mod.DraftState] = {}
        self._next_virt = -2
        self.page_size = page_size
        self.num_lanes = num_lanes
        self.max_q = max_q
        self.max_kv_per_task = max_kv_per_task
        self.temperature = temperature
        # the sampler's threefry key, split on the device where ``repro``
        # splits its key: each completed prefill and each decode step (on
        # the fused path inside the graph, so it stays at this address)
        self.key = sampler.prng_key(seed, self.device)

        # ---- lifecycle and faults (``repro``'s DESIGN §12) ------------ #
        # clock: injectable monotonic time source; deadlines are enforced
        # against it at step boundaries
        self.clock = clock if clock is not None else time.monotonic
        # telemetry: True builds a default Telemetry, an instance sets
        # profile_every or a TraceSink; spans ride the engine clock, so a
        # fake clock gives deterministic traces.  None keeps every hook off
        if telemetry is True:
            telemetry = telemetry_mod.Telemetry()
        self.telemetry: Optional[telemetry_mod.Telemetry] = \
            telemetry or None
        if self.telemetry is not None:
            self.telemetry.bind_clock(self.clock)
        # nan_guard: quarantine a request whose logits turn non-finite
        self.nan_guard = bool(nan_guard)
        if self.nan_guard and mesh is not None:
            raise ValueError(
                "nan_guard is not supported with mesh serving: the "
                "sharded step does not check its rows' logits")
        self.check_every = int(check_every)
        self.max_dispatch_retries = int(max_dispatch_retries)
        if faults is not None and not isinstance(faults,
                                                 faults_mod.FaultInjector):
            faults = faults_mod.FaultInjector(faults)
        self.injector: Optional[faults_mod.FaultInjector] = faults
        # admission-shrink rung of the degradation ladder: extra pages
        # the watermark holds back after repeated dispatch failures
        self._backoff_pages = 0
        # (page, slot) pairs the nan_logits injector poisoned: scrubbed
        # when the target request is quarantined so a future tenant of
        # those pages never reads the NaNs
        self._nan_dirty: List[Tuple[int, int]] = []
        self.layers = list(model.layers)
        self.attn_layer_idx = {j: a for a, j in enumerate(
            j for j, layer in enumerate(self.layers)
            if layer.kind.mixer in ("attn", "attn_local"))}
        self._has_mamba = any(layer.kind.mixer == "mamba"
                              for layer in self.layers)
        # per-request Mamba state, keyed by layer index then request:
        # (conv (1, K-1, conv_dim), ssm (1, H, P, S)) float32
        self.mamba_state: Dict[int, Dict[int, M.State]] = {}
        # position the carried state of a request part-way through its
        # prefill is valid at
        self._mamba_pos: Dict[int, int] = {}
        # the fused path's rows of the current epoch (None: a row whose
        # request left, so its carry row is never synced back)
        self._fused_rows: Optional[List[Optional[int]]] = None
        if mesh is not None:
            self.pool = (RankKVPool if self._ranked else ShardedKVPool)(
                max(len(self.attn_layer_idx), 1), num_pages, page_size,
                max(cfg.num_kv_heads, 1), max(cfg.head_dim, 1), mesh=mesh,
                seq_split_pages=seq_split_pages, device=self.device)
        else:
            self.pool = PagedKVPool(
                max(len(self.attn_layer_idx), 1), num_pages, page_size,
                max(cfg.num_kv_heads, 1), max(cfg.head_dim, 1),
                device=self.device)
        # replicate=True lets a mesh epoch copy hot short prefix nodes onto
        # every data shard (extra pages instead of merge work;
        # CostModel.replicate_gain decides each node); calibrate=True
        # times every mesh step and refits the cost model's coefficients
        # from step_stats at each plan epoch
        self.replicate = (bool(replicate) and mesh is not None
                          and mesh.shape["data"] > 1)
        self.calibrate = bool(calibrate)
        # the current epoch's cost features (every step record carries
        # them), and per shard (profiled steps only)
        self._epoch_features: Dict[str, float] = {}
        self._epoch_shard_features: Dict[str, List[float]] = {}
        # the last mesh epoch's ShardedPlan per window
        self._sharded_plans: Dict[int, plan_mod.ShardedPlan] = {}
        self.forest = tree_mod.PrefixForest(page_size)
        # splitting a pinned node must extend each waiting holder's pin
        # list over the new lower half (see _on_split_pins)
        self.forest.on_split = self._on_split_pins
        # persistent cross-request prefix cache: cache=True (default
        # policy) or a CachePolicy keeps finished requests' page-backed
        # prefix nodes resident; None frees them as before
        if cache is True:
            cache = CachePolicy()
        self.cache: Optional[PrefixCache] = (
            PrefixCache(self.forest, cache) if cache is not None else None)
        # rolling snapshot so step_stats deltas also cover lookups from
        # admissions between steps (add_request)
        self._cache_snap = dict(self.cache.stats) if self.cache else None
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.cost_model = CostModel(max(cfg.num_heads, 1),
                                    max(cfg.num_kv_heads, 1),
                                    max(cfg.head_dim, 1),
                                    bytes_per=self.pool.k.element_size(),
                                    page_size=page_size)
        self.policy = AdmissionPolicy(prefill_chunk=prefill_chunk,
                                      reserve_pages=reserve_pages,
                                      max_running=max_running,
                                      cascade=bool(cascade),
                                      max_cascade_group=max_cascade_group,
                                      draft_reserve_pages=(
                                          self.spec.max_nodes if self.spec
                                          else 0))
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
                      "nonfinite_rows": 0, "cancelled": 0, "timed_out": 0,
                      "failed": 0, "callback_errors": 0,
                      "faults_injected": 0, "dispatch_failures": 0,
                      "dispatch_recoveries": 0, "nan_rows": 0,
                      "invariant_checks": 0, "cascade_groups": 0,
                      "cascade_shared_tokens": 0,
                      "cascade_suffix_tokens": 0, "cascade_batches": 0,
                      "spec_steps": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_draft_stalls": 0,
                      "calibrations": 0, "replica_promotions": 0,
                      "replica_demotions": 0}
        # one record a step: what it decoded, admitted, preempted,
        # reclaimed and prefilled, the queue and pool it left, and its
        # timing (``_decode_timing``: dispatch_time and flush_time; on
        # sampled steps compute_time, host_time and profiled)
        self.step_stats: List[Dict] = []
        self._decode_timing: Dict[str, float] = {}

        # ---- fused decode: one graph replay a token (step_fn.py) ------ #
        # active only for backends with the jit-safe contract (``ref``
        # decodes eagerly)
        self.fused = bool(fused) and self._backend.jit_safe
        self.fused_step = None
        if self.fused and mesh is not None:
            self.fused_step = (RankStep if self._ranked else ShardedStep)(
                cfg, self.model, self.pool, self._backend, self._windows(),
                self.attn_layer_idx, self.device, temperature, self.key,
                mesh=mesh)
        elif self.fused and self.spec is None:
            self.fused_step = step_fn_mod.FusedStep(
                cfg, self.model, self.pool, self._backend, self._windows(),
                self.attn_layer_idx, self.device, temperature, self.key)
        # speculation replaces the per-token step with the fused verify
        # step: one graph replay scores a whole draft tree
        self.spec_step = (step_fn_mod.SpecStep(
            cfg, self.model, self.pool, self._backend, self._windows(),
            self.attn_layer_idx, self.device)
            if self.fused and self.spec is not None else None)
        # async token plumbing
        self._deferred: List[_Deferred] = []
        self._pending_ref: Dict[int, Tuple[_Deferred, int]] = {}
        # distinct fused shape signatures seen (one step state, and on the
        # card one captured graph, each)
        self.bucket_signatures: set = set()

    def _check_kernel_shapes(self, page_size: int, mesh) -> None:
        """On a CUDA device, refuse here, before any request is admitted,
        a shape that a kernel of this engine's decode step does not take,
        naming the kernel: the epilogue (every backend launches it; its
        head dims are among PAC's and are the merge's) and, on a mesh,
        the cross-shard merge's data axis.  The same checks run in each
        kernel's wrapper at its launch."""
        cfg = self.cfg
        if self.device.type != "cuda" or not cfg.num_heads or not any(
                k.mixer in ("attn", "attn_local") for k in cfg.layer_pattern):
            return
        refusals = [("codec_por_epilogue",
                     por_mod.epilogue_refusal(cfg.head_dim, page_size))]
        if mesh is not None:
            refusals.append(("codec_mesh_merge", por_mod.merge_refusal(
                mesh.shape["data"], cfg.head_dim)))
        for kernel, why in refusals:
            if why is not None:
                raise ValueError(
                    f"{cfg.name} at page size {page_size} on {self.device}: "
                    f"{kernel} does not take this shape ({why})")

    # ------------------------------------------------------------------ #
    # request admission (admit phase) + chunked prefill (prefill phase)
    # ------------------------------------------------------------------ #
    def add_request(self, prompt: List[int], max_new: int = 16,
                    on_token=None, on_done=None,
                    deadline_s: Optional[float] = None,
                    max_queue_s: Optional[float] = None) -> int:
        """Enqueue a request; admits (and prefills) it at once when memory
        allows, so under no pressure this is immediate prefill.

        ``on_token(rid, token)`` streams each generated token once its
        value is on the host (at once on the eager path; at sync points
        on the fused path).  ``on_done(rid, reason)`` closes the stream
        once with a terminal reason (``done``, ``cancelled``,
        ``deadline``, ``queue_timeout``, or a failure such as
        ``nan_logits``, ``kv_exhausted`` or ``callback_error``).

        ``deadline_s`` bounds the request end to end (queueing included)
        and ``max_queue_s`` its time waiting; both count from now on the
        engine clock and are enforced at step boundaries (the request
        ends ``TIMED_OUT`` with its KV released).  A deadline also orders
        the waiting queue (EDF).
        """
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
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive, got {deadline_s}")
        if max_queue_s is not None and max_queue_s <= 0:
            raise ValueError(
                f"max_queue_s must be positive, got {max_queue_s}")
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
        now = self.clock()
        if self._ranked and (deadline_s is not None
                             or max_queue_s is not None):
            now = self._mesh_clock(now)
        req = Request(rid, prompt, max_new=max_new, on_token=on_token,
                      on_done=on_done, submit_t=now)
        if deadline_s is not None:
            req.deadline = now + float(deadline_s)
        if max_queue_s is not None:
            req.queue_deadline = now + float(max_queue_s)
        if self._ranked:
            self._host_log = digest(self._host_log, "add", rid, max_new,
                                    req.deadline, req.queue_deadline,
                                    arr.astype(np.int64).tobytes())
        self.requests[rid] = req
        if self.telemetry is not None:
            self.telemetry.metrics["requests_submitted"].inc()
            self.telemetry.begin("queued", track=rid,
                                 args={"prompt_tokens": len(prompt),
                                       "max_new": max_new})
        edf = [d for d in (req.deadline, req.queue_deadline)
               if d is not None]
        self.admission.push(rid, deadline=min(edf) if edf else None)
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
        # the draft reserve scales with the requests running now, so an
        # idle engine always admits its head-of-line request;
        # _backoff_pages is the degradation ladder's admission-shrink rung
        reserve = (self.policy.admission_reserve(len(self._active_rows()))
                   + self._backoff_pages)
        return self.pool.num_free - reserve >= need

    def _admit_phase(self) -> None:
        """Admission + chunked-prefill phase: continue admitted prefills
        first, then admit waiting requests FCFS (head-of-line blocks)
        within the page watermark (reclaiming finished KV and orphaned
        pins, never preempting), the ``max_running`` cap and the step's
        cost-model prefill budget.  With ``cascade=True`` prefilling
        requests that share an unfilled forest node advance as one
        cascade group, and admitting a head-of-line request pulls its
        cascade partners out of the queue so the group prefills
        together."""
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
            group = [head.rid]
            if self.policy.cascade:
                group += self._co_admit_partners(head)
            spent += self._prefill_group(
                group, None if budget is None else budget - spent)

    def _advance_prefills(self, budget: Optional[int]) -> int:
        """Advance every admitted-but-unfinished prefill by one chunk."""
        spent = 0
        if not self.policy.cascade:
            for rid in list(self._prefilling):
                if budget is not None and spent >= budget:
                    return spent
                req = self.requests[rid]
                if req.state != PREFILL:   # preempted by an earlier prefill
                    continue
                spent += self._prefill_step(
                    req, None if budget is None else budget - spent)
            return spent
        # cascade: regroup every step — membership follows from the forest
        # (the first unfilled node on each path), so preemption, node
        # splits and members finishing apart need no group bookkeeping
        for group in self._prefill_groups():
            if budget is not None and spent >= budget:
                return spent
            spent += self._prefill_group(
                group, None if budget is None else budget - spent)
        return spent

    # ------------------------------------------------------------------ #
    # cascade prefill (``repro``'s DESIGN §14)
    # ------------------------------------------------------------------ #
    def _co_admit_partners(self, head: Request) -> List[int]:
        """Pull the head's cascade partners out of the wait queue: waiting
        requests whose prompt's deepest shared forest node
        (``tree.match_path``) lies on the head's freshly inserted path.
        The page probe and the ``max_running`` cap still apply; a partner
        failing either keeps its place in the queue."""
        anchor = {n.id for n in self.forest.path(head.rid) if n.length}
        if not anchor:
            return []
        ps = self.page_size

        def key_of(rid: int) -> Optional[int]:
            nid, matched = self.forest.match_path(
                np.asarray(self.requests[rid].seq, np.int32))
            # under one page shared: insertion would not split a node, so
            # there is no shared span to cascade over
            return nid if matched >= ps else None

        admitted: List[int] = []
        limit = self.policy.max_cascade_group - 1
        for rid in self.admission.cascade_partners(anchor, key_of, limit):
            if (self.policy.max_running is not None
                    and len(self._live()) >= self.policy.max_running):
                break
            part = self.requests[rid]
            if not self._has_pages_for(part):
                continue
            self.admission.remove(rid)
            self._admit(part)
            admitted.append(rid)
        return admitted

    def _cascade_key(self, rid: int) -> Optional[int]:
        """Id of the first not fully filled node on the request's path:
        prefilling requests with the same key are about to compute the
        same node's KV (``None``: nothing left to fill)."""
        for node in self.forest.path(rid):
            if node.length == 0:
                continue
            if min(node.meta.get("filled", 0), node.length) < node.length:
                return node.id
        return None

    def _prefill_groups(self) -> List[List[int]]:
        """Partition ``_prefilling`` into cascade groups (order kept)."""
        groups: List[List[int]] = []
        by_key: Dict[int, int] = {}
        for rid in list(self._prefilling):
            if self.requests[rid].state != PREFILL:
                continue
            key = self._cascade_key(rid)
            if key is not None and key in by_key:
                groups[by_key[key]].append(rid)
            else:
                if key is not None:
                    by_key[key] = len(groups)
                groups.append([rid])
        return groups

    def _prefill_group(self, group: List[int],
                       budget: Optional[int]) -> int:
        group = [r for r in group if self.requests[r].state == PREFILL]
        if not group:
            return 0
        if len(group) == 1:
            return self._prefill_step(self.requests[group[0]], budget)
        return self._cascade_prefill_step(group, budget)

    def _shared_frontier(self, group: List[int]) -> int:
        """Absolute end of the deepest node on every member's path: the
        span whose compute the group shares."""
        paths = [self.forest.path(r) for r in group]
        end = 0
        for nodes in zip(*paths):
            nid = nodes[0].id
            if any(n.id != nid for n in nodes[1:]):
                break
            end = nodes[0].end_pos
        return end

    def _cascade_prefill_step(self, group: List[int],
                              budget: Optional[int]) -> int:
        """Advance a cascade group by one chunk.

        Phase A computes the group's shared unfilled span once, through
        the lead member (``_prefill_step(stop_at=)``), writing the shared
        nodes' KV and caching their SSM boundary states
        (``node.meta["ssm"]``) as the sequential path does, then hands
        every sibling the lead's carried mid-node SSM state so all of them
        resume at the chunk boundary.  Phase B batches the members' suffix
        chunks into one padded forward (``_batched_suffix_prefill``);
        members whose next unfilled node is shared with another member
        recurse as a deeper subgroup, and recurrent (Mamba) suffixes and a
        fully cached prompt take the per-request path.  A member stalling
        on pages is skipped while its siblings go on; a stall on the
        shared span stalls the group (the span is on every member's
        path)."""
        tm = self.telemetry
        spent = 0
        alive = [r for r in group if self.requests[r].state == PREFILL]
        if len(alive) < 2:
            return self._prefill_group(alive, budget)
        self.stats["cascade_groups"] += 1

        # ---- phase A: the shared unfilled span, computed once ---------- #
        lead = self.requests[alive[0]]
        frontier = self._shared_frontier(alive)
        if self._filled_front(lead.rid) < frontier:
            c0 = self.clock() if tm is not None else 0.0
            n = self._prefill_step(lead, budget, stop_at=frontier)
            spent += n
            if n:
                self.stats["cascade_shared_tokens"] += n * (len(alive) - 1)
                if tm is not None:
                    c1 = self.clock()
                    for rid in alive[1:]:
                        # the shared chunk belongs to every member's
                        # prefill span, not the lead's only
                        tm.complete("prefill_chunk", c0, c1, track=rid,
                                    args={"tokens": n, "shared": True})
            # hand each sibling the carried mid-node SSM state, so hybrid
            # archs resume at the cascaded chunk boundary instead of
            # recomputing from the last node-aligned ``meta["ssm"]``
            pos = self._mamba_pos.get(lead.rid)
            if pos is not None and pos <= frontier:
                for rid in alive[1:]:
                    self._mamba_pos[rid] = pos
                    for st in self.mamba_state.values():
                        if lead.rid in st:
                            st[rid] = st[lead.rid]
            if n == 0:
                self.stats["prefill_stalls"] += len(alive) - 1
                return spent       # the shared span stalled: group waits
            if budget is not None and spent >= budget:
                return spent
            if self._filled_front(lead.rid) < frontier:
                return spent       # the chunk ended inside the shared span

        # ---- phase B: the members' suffix chunks, one batch ------------ #
        alive = [r for r in alive if self.requests[r].state == PREFILL]
        has_mamba = self._has_mamba
        by_key: Dict[int, List[int]] = {}
        for rid in alive:
            key = self._cascade_key(rid)
            by_key.setdefault(key if key is not None else ~rid,
                              []).append(rid)
        batch: List[Tuple[Request, int, int]] = []
        for key, rids in by_key.items():
            if budget is not None and spent >= budget:
                break
            left = None if budget is None else budget - spent
            if len(rids) > 1:
                # a deeper node shared by a strict subset of the group
                spent += self._cascade_prefill_step(rids, left)
                continue
            req = self.requests[rids[0]]
            if req.state != PREFILL:
                continue           # preempted by a sibling's allocation
            total = len(req.seq)
            start = self._filled_front(req.rid)
            if has_mamba or start >= total:
                # a recurrent suffix, or a fully cached prompt: the
                # per-request path (it resumes SSM state; it recomputes a
                # cached prompt's last position and promotes it)
                spent += self._prefill_step(req, left)
                continue
            end = total if left is None else min(total, start + left)
            if not self._ensure_pages_upto(req.rid, end):
                self.stats["prefill_stalls"] += 1
                continue           # this member stalls; siblings go on
            batch.append((req, start, end))
            spent += end - start
        # a later member's allocation may have preempted an earlier one
        # (``repro`` then raises ``KeyError`` in its batch: ROADMAP C)
        batch = [b for b in batch if b[0].state == PREFILL]
        if len(batch) == 1:
            req, start, end = batch[0]
            self._prefill_step(req, end - start)
        elif batch:
            self._batched_suffix_prefill(batch)
        return spent

    @torch.no_grad()
    def _batched_suffix_prefill(
            self, batch: List[Tuple[Request, int, int]]) -> int:
        """One padded forward over several requests' suffix chunks.

        Each row is a ``(request, start, end)`` span whose pages are
        ensured and whose KV is filled up to ``start``.  Rows pad to
        powers of two (``plan.bucket_pow2``) in batch, query length and
        KV length; padded query slots carry position -1 and padded KV
        slots are masked by ``kv_valid``.  Each row's prefix is gathered
        from the pool per layer, its new K/V go to its own nodes' unfilled
        slots, and rows that complete sample in batch order, each
        splitting the key once as the sequential path does.  Timed like
        ``_prefill_step``: a pair of CUDA events on the card."""
        cfg = self.cfg
        tm = self.telemetry
        c0 = self.clock() if tm is not None else 0.0
        t0 = self._prefill_mark()
        dev = self.device
        B = len(batch)
        Tn = [end - start for _, start, end in batch]
        T_pad = plan_mod.bucket_pow2(max(Tn))
        S_pad = plan_mod.bucket_pow2(max(end for _, _, end in batch))
        B_pad = plan_mod.bucket_pow2(B)
        tok = np.zeros((B_pad, T_pad), np.int64)
        qpos = np.full((B_pad, T_pad), -1, np.int64)
        kv_valid = np.zeros((B_pad, S_pad), bool)
        for i, (req, start, end) in enumerate(batch):
            tok[i, :Tn[i]] = req.seq[start:end]
            qpos[i, :Tn[i]] = start + np.arange(Tn[i])
            kv_valid[i, :end] = True
        qpos_t = torch.as_tensor(qpos, device=dev)
        kv_valid_t = torch.as_tensor(kv_valid, device=dev)
        kv_pos = torch.arange(S_pad, device=dev)[None].expand(B_pad, S_pad)

        paths = {req.rid: self.forest.path(req.rid) for req, _, _ in batch}
        segments: Dict[int, List[Tuple[object, int, int]]] = {}
        for req, start, end in batch:
            segs, off = [], 0
            for node in paths[req.rid]:
                lo = max(0, off - start)
                hi = min(end, off + node.length) - start
                if hi > lo:
                    segs.append((node, lo, hi))
                off += node.length
            segments[req.rid] = segs

        x = self.model.embed_tokens(torch.as_tensor(tok, device=dev), qpos_t)
        new_kv = []  # (layer_attn, k (B_pad, T_pad, kv, hd), v)
        for j, layer in enumerate(self.layers):
            h = L.apply_norm(layer.ln, x, cfg)
            la = self.attn_layer_idx[j]
            window = layer.window
            q, k_new, v_new = L.attn_project(layer.attn, cfg, h, qpos_t)
            k_all = k_new.new_zeros((B_pad, S_pad) + k_new.shape[2:])
            v_all = v_new.new_zeros((B_pad, S_pad) + v_new.shape[2:])
            for i, (req, start, end) in enumerate(batch):
                pk, pv = self._gather_prefix_upto(la, paths[req.rid], start)
                k_all[i, :start] = pk
                v_all[i, :start] = pv
                k_all[i, start:end] = k_new[i, :Tn[i]]
                v_all[i, start:end] = v_new[i, :Tn[i]]
            o = L.mha(q, k_all, v_all, causal=True, window=window,
                      q_positions=qpos_t, kv_positions=kv_pos,
                      kv_valid=kv_valid_t)
            x = x + L.dense(layer.attn.wo,
                            o.reshape(B_pad, T_pad,
                                      cfg.num_heads * cfg.head_dim))
            new_kv.append((la, k_new, v_new))
            x, _ = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)

        # write each row's new KV into its own nodes' unfilled slots
        ps = self.page_size
        pages, offs, rows_b, rows_t = [], [], [], []
        for i, (req, start, end) in enumerate(batch):
            for node, lo, hi in segments[req.rid]:
                filled = node.meta.get("filled", 0)
                base = node.start_pos - start
                t_hi = hi - base
                # a replicated node's KV lands in every replica's pages
                reps = node.meta.get("replicas")
                page_lists = (list(reps.values()) if reps
                              else [node.page_ids])
                for t in range(max(filled, lo - base), t_hi):
                    for pl in page_lists:
                        pages.append(pl[t // ps])
                        offs.append(t % ps)
                        rows_b.append(i)
                        rows_t.append(base + t)
                if t_hi > filled:
                    node.meta["filled"] = t_hi
        if pages:
            bi = torch.as_tensor(rows_b, device=dev)
            ti = torch.as_tensor(rows_t, device=dev)
            pg = torch.as_tensor(pages, device=dev)
            of = torch.as_tensor(offs, device=dev)
            for la, k_new, v_new in new_kv:
                self.pool.write_tokens(la, pg, of, k_new[bi, ti],
                                       v_new[bi, ti])

        done = sum(Tn)
        self.stats["prefill_tokens"] += done
        self.stats["cascade_suffix_tokens"] += done
        self.stats["cascade_batches"] += 1
        # the last position's logits of every row that completes and has
        # no pending token yet (a resumed request keeps its own)
        sample = [i for i, (req, _, end) in enumerate(batch)
                  if end == len(req.seq) and req.pending is None]
        logits = None
        if sample:
            idx = torch.as_tensor(sample, device=dev)
            last = torch.as_tensor([Tn[i] - 1 for i in sample], device=dev)
            logits = self.model.unembed(x[idx, last])       # (n, V)
        for i, (req, start, end) in enumerate(batch):
            self.stats["recompute_tokens"] += max(
                0, min(end, req.computed_hwm) - start)
            req.computed_hwm = max(req.computed_hwm, end)
            if end < len(req.seq):
                self.stats["prefill_chunks"] += 1
                continue
            if i in sample:
                row = logits[sample.index(i)][None]
                req.pending = int(sampler.sample(row, self._split_key(),
                                                 self.temperature)[0])
            self._promote(req)
        self._prefill_done(t0)
        if tm is not None:
            c1 = self.clock()
            for i, (req, _, _) in enumerate(batch):
                tm.complete("prefill_chunk", c0, c1, track=req.rid,
                            args={"tokens": Tn[i], "batched": True})
            tm.observe("prefill_chunk_s", c1 - c0)
        return done

    def _admit(self, req: Request) -> None:
        """(Re-)insert the request's sequence into the forest and release
        the pins it held while waiting (its path now keeps those nodes
        alive by membership)."""
        seq = np.asarray(req.seq, np.int32)
        if (self.cache is not None and req.preemptions == 0
                and not req.generated):
            # first admission only: a resumed request would count its own
            # pinned prefix as a hit
            self.cache.record_lookup(self.forest.match_len(seq), len(seq))
        self.forest.insert_tokens(req.rid, seq)
        if self.cache is not None:
            for node in self.forest.path(req.rid):
                self.cache.stamp(node)
        self._unpin(req)
        req.state = PREFILL
        self._prefilling.append(req.rid)
        self.stats["admitted"] += 1
        if self.telemetry is not None:
            if req.preemptions == 0 and not req.generated:
                self.telemetry.observe("queue_wait_s",
                                       self.clock() - req.submit_t)
            self.telemetry.end(track=req.rid)          # "queued"
            self.telemetry.begin("prefill", track=req.rid)

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
        counted in ``stats["nonfinite_rows"]``; with ``nan_guard`` such a
        request is quarantined (``FAILED``, ``nan_logits``) from its first
        bad token on, and no other row is touched.
        """
        if not self._deferred and not self._pending_ref:
            return
        tm = self.telemetry
        c0 = self.clock() if tm is not None else 0.0
        t0 = time.perf_counter()
        for e in self._deferred:
            if e.event is not None:
                e.event.synchronize()
        poisoned: Dict[int, int] = {}     # rid -> earliest bad gen index
        for e in self._deferred:
            ok = e.tokens[1].numpy()
            self.stats["nonfinite_rows"] += int(
                (ok[:len(e.rows)] == 0).sum())
            if self.nan_guard:
                for rid, row, gen_idx, _nid, _tid in e.patches:
                    if not ok[row] and gen_idx < poisoned.get(
                            rid, gen_idx + 1):
                        poisoned[rid] = gen_idx
        if self.nan_guard:
            for rid, (e, row) in self._pending_ref.items():
                req = self.requests.get(rid)
                if (not e.tokens[1, row] and rid not in poisoned
                        and req is not None):   # sampled, never appended
                    poisoned[rid] = len(req.generated)
        landed: Set[int] = set()
        for e in self._deferred:
            toks = e.tokens[0].numpy()
            for rid, row, gen_idx, node_id, tok_idx in e.patches:
                if gen_idx >= poisoned.get(rid, gen_idx + 1):
                    continue              # untrusted suffix: never lands
                tok = int(toks[row])
                req = self.requests.get(rid)
                if req is not None and gen_idx < len(req.generated):
                    req.generated[gen_idx] = tok
                    landed.add(rid)
                node = self.forest.nodes.get(node_id)
                if (node is not None and node.tokens is not None
                        and tok_idx < len(node.tokens)):
                    node.tokens[tok_idx] = tok
        # sampled-but-not-yet-appended tokens become host ``pending``s
        for rid, (e, row) in self._pending_ref.items():
            req = self.requests.get(rid)
            if (req is not None and req.pending is PENDING_DEVICE
                    and rid not in poisoned):
                req.pending = int(e.tokens[0, row])
        self._deferred = []
        self._pending_ref = {}
        self.stats["token_flushes"] += 1
        elapsed = time.perf_counter() - t0
        self.stats["decode_sync_time"] += elapsed
        # the wait is billed to the step the flush ran in, under its own
        # key: never to that step's dispatch/device split
        self._decode_timing["flush_time"] = \
            self._decode_timing.get("flush_time", 0.0) + elapsed
        if tm is not None:
            for rid in landed:
                self._note_token(self.requests[rid])
            tm.observe("flush_s", elapsed)
            tm.complete("flush", c0, self.clock(),
                        args={"tokens": len(landed)})
        for rid, cut in poisoned.items():
            req = self.requests.get(rid)
            if req is None:
                continue
            del req.generated[cut:]       # placeholders only (never
            self.stats["nan_rows"] += 1   # streamed, so emitted <= cut)
            self._fail_request(rid, "nan_logits", flush=False)

    @property
    def fused_cache_size(self) -> int:
        """Step states kept, one per bucket signature (on the card each
        holds one captured graph)."""
        step = self.fused_step or self.spec_step
        return 0 if step is None else len(step.slots)

    # ------------------------------------------------------------------ #
    # eviction (evict phase) / reclamation
    # ------------------------------------------------------------------ #
    def _drop_node(self, node) -> None:
        """Release a node's pages (every replica's) and unlink it from the
        forest."""
        self._release_node_pages(node)
        self.forest.nodes[node.parent].children.remove(node.id)
        del self.forest.nodes[node.id]

    def _maybe_free_node(self, node, force: bool = False) -> None:
        """Free a node once nothing references it (no requests pass
        through it, no children, no waiting request pins it), then try
        its parent.

        With the prefix cache on, page-backed nodes are retained instead
        (cache content, reclaimed by the TTL/LRU sweep or the pressure
        tier); ``force=True`` frees them all the same."""
        if node.id == tree_mod.ROOT_ID or node.id not in self.forest.nodes:
            return
        if node.requests or node.children or node.meta.get("pins", 0) > 0:
            return
        if (not force and self.cache is not None
                and self.cache.retainable(node)):
            if "touch" not in node.meta:
                self.cache.stamp(node)
            return
        parent = self.forest.nodes[node.parent]
        self._drop_node(node)
        self._maybe_free_node(parent)

    def _release_kv(self, rid: int, force_leaf: bool = False) -> None:
        """Drop a request's forest footprint (finished or released).

        ``force_leaf=True`` (failed requests) frees the private leaf even
        with the cache on: its tail KV may be poisoned or half written, so
        no later prefix match may serve it.  Shared ancestors hold prompt
        KV written by prefill and stay retainable."""
        self._rollback_drafts(rid)
        leaf_id = self.forest.leaf_of.get(rid)
        for node in reversed(self.forest.path(rid)):
            if node.id not in self.forest.nodes:
                continue
            node.requests.remove(rid)
            self._maybe_free_node(node,
                                  force=force_leaf and node.id == leaf_id)
        del self.forest.leaf_of[rid]
        self._drop_mamba(rid)

    def _drop_mamba(self, rid: int) -> None:
        """Forget a request's SSM state and carried prefill position
        (released, preempted or detached); its row of the fused carry is
        never synced back."""
        for st in self.mamba_state.values():
            st.pop(rid, None)
        self._mamba_pos.pop(rid, None)
        if self._fused_rows is not None and rid in self._fused_rows:
            self._fused_rows[self._fused_rows.index(rid)] = None

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
        # a victim evicted mid-speculation sheds its draft tree first: its
        # draft nodes and virtual queries would keep its leaf (and every
        # ancestor) alive and leak the draft pages
        self._rollback_drafts(rid)
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
        self._drop_mamba(rid)
        if rid in self._prefilling:
            self._prefilling.remove(rid)
        req.pinned = pinned
        req.state = WAITING
        req.preemptions += 1
        self.admission.requeue(rid)
        self.stats["preempted"] += 1
        if self.telemetry is not None:
            self.telemetry.end_all(rid)       # prefill/decode span
            self.telemetry.instant("evict", track=rid,
                                   args={"pinned_nodes": len(pinned)})
            self.telemetry.begin("queued", track=rid)

    def _reclaimable_pages(self, rid: int) -> int:
        """Pages that preempting ``rid`` would free (its non-shared
        nodes)."""
        n = 0
        freeable: Set[int] = set()
        for node in reversed(self.forest.path(rid)):
            # virtual branch-head queries (< 0) and draft children belong
            # to a live draft tree, which preemption rolls back first: they
            # do not disqualify the victim (draft pages are not counted)
            others = [r for r in node.requests if r != rid and r >= 0]
            kids = {c for c in set(node.children) - freeable
                    if not self.forest.nodes[c].meta.get("draft")}
            if others or kids or node.meta.get("pins", 0) > 0:
                continue
            freeable.add(node.id)
            n += self._node_total_pages(node)
        return n

    def _reclaim_one(self, exclude: Set[int],
                     allow_preempt: bool = True) -> bool:
        """Free some pages, cheapest first: (0) evict cached (request-
        less, unpinned) prefix nodes LRU-first, (1) finished-request KV,
        (2) orphaned pinned nodes, (3) preempt the live victim with the
        fewest generated tokens (ties: latest arrival).  False when
        nothing is left to free."""
        if self.cache is not None and self._evict_cached(1) > 0:
            self.stats["reclaimed"] += 1
            return True
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
                    self._maybe_free_node(node, force=True)
                    if nid not in self.forest.nodes:
                        self.stats["reclaimed"] += 1
                        return True
        # demote a replicated node (widest first): frees (D-1)/D of its
        # pages without touching any request, cheaper than preemption;
        # the plan rebuild re-derives the merge rows
        repl = [n for n in self.forest.nodes.values()
                if "replicas" in n.meta]
        if repl:
            self._demote_replicas(max(repl, key=lambda n: len(n.page_ids)))
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
        forever.  A replicated node's replica runs split at the same page
        (``tree._split`` cut ``page_ids``, the primary's rows; the other
        shards' runs must follow, or the lower half would alias the
        upper's replica pages)."""
        reps = upper.meta.get("replicas")
        if reps is not None:
            cut = len(upper.page_ids)
            prim = upper.meta["replica_primary"]
            lower.meta["replicas"] = {s: lst[cut:]
                                      for s, lst in reps.items()}
            upper.meta["replicas"] = {s: lst[:cut]
                                      for s, lst in reps.items()}
            lower.meta["replica_primary"] = prim
            upper.page_ids = list(upper.meta["replicas"][prim])
            lower.page_ids = list(lower.meta["replicas"][prim])
        if upper.meta.get("pins", 0) <= 0:
            return
        for req in self.requests.values():
            if upper.id in req.pinned:
                req.pinned.append(lower.id)

    # ------------------------------------------------------------------ #
    # persistent cross-request prefix cache (cache.py) and streaming
    # ------------------------------------------------------------------ #
    def _free_cached_node(self, node) -> None:
        """Evict one cached leaf: release its pages and unlink it (the
        parent becomes a future candidate under its own touch stamp)."""
        self.cache.stats["evicted_nodes"] += 1
        self.cache.stats["evicted_pages"] += self._node_total_pages(node)
        parent = self.forest.nodes[node.parent]
        self._drop_node(node)
        self._maybe_free_node(parent)   # frees empty husks, keeps cache

    def _evict_cached(self, min_pages: int) -> int:
        """Evict LRU cache entries until >= ``min_pages`` pages are freed
        (or the cache is empty); returns the pages freed."""
        freed = 0
        while freed < min_pages:
            cands = self.cache.candidates()
            if not cands:
                break
            node = cands[0]
            freed += len(node.page_ids)
            self._free_cached_node(node)
        return freed

    def _detach_finished(self) -> None:
        """Detach completed requests from the forest, keeping their
        page-backed prefix nodes as cache (a finished request's document
        stays resident for the next request that shares it)."""
        done = [r for r in sorted(self.requests)
                if self.requests[r].state == DONE
                and not self.requests[r].kv_freed
                and r in self.forest.leaf_of]
        if not done:
            return
        # cached node tokens are matched by value at later admissions:
        # in-flight placeholders land first
        self.flush_tokens()
        for rid in done:
            if self.requests[rid].state != DONE:   # that flush failed it
                continue
            self._rollback_drafts(rid)
            path = self.forest.path(rid)
            self.forest.detach_request(rid)
            for node in reversed(path):
                if node.id in self.forest.nodes:
                    self._maybe_free_node(node)
            self._drop_mamba(rid)
            self.requests[rid].kv_freed = True

    def _cache_sweep(self) -> None:
        """Per-step TTL expiry + LRU enforcement of ``max_pages``."""
        while True:
            expired = [n for n in self.cache.expired()
                       if n.id in self.forest.nodes]
            if not expired:
                break
            for node in expired:    # parents become leaves next round
                if node.id in self.forest.nodes:
                    self._free_cached_node(node)
        over = self.cache.over_cap()
        if over > 0:
            self._evict_cached(over)

    def _cache_step_delta(self) -> Dict[str, int]:
        """Advance the rolling cache-stats snapshot and return the delta
        since the previous step (lookups of admissions between steps land
        in exactly one step's record)."""
        cur = dict(self.cache.stats)
        prev = self._cache_snap
        self._cache_snap = cur
        return {k: cur[k] - prev.get(k, 0) for k in cur}

    def _stream_ready(self) -> None:
        """Deliver newly landed tokens to the streaming callbacks,
        stopping at the first placeholder still on the device (so on the
        fused path streams arrive at sync points, in order).  A raising
        ``on_token`` fails only its own request (``callback_error``)."""
        for req in list(self.requests.values()):
            if req.on_token is None:
                continue
            gen = req.generated
            while req.emitted < len(gen) and gen[req.emitted] >= 0:
                tok = gen[req.emitted]
                req.emitted += 1
                try:
                    if self.injector is not None:
                        spec = self.injector.take("callback", rid=req.rid)
                        if spec is not None:
                            self.stats["faults_injected"] += 1
                            raise InjectedFault(
                                spec, f"injected on_token failure for "
                                      f"request {req.rid}")
                    req.on_token(req.rid, tok)
                except Exception:
                    self.stats["callback_errors"] += 1
                    self._fail_request(req.rid, "callback_error",
                                       flush=False)
                    break

    def _alloc_pages(self, n: int, exclude: Set[int],
                     allow_preempt: bool = True,
                     hint: Optional[int] = None) -> Optional[List[int]]:
        """Allocate ``n`` pages, reclaiming (and preempting, unless
        ``allow_preempt`` is off) under pressure; ``None`` when nothing
        more can be reclaimed, or when an injected ``alloc`` fault
        simulates exhaustion (callers then degrade as under real
        pressure: stall, or preempt and recompute).  ``hint`` (a node id)
        is the mesh pool's placement affinity."""
        if (self.injector is not None and self.spec is None
                and self.injector.take("alloc") is not None):
            # gated off under speculation, as in ``repro``: a failure in
            # the middle of a commit has no clean unwind
            self.stats["faults_injected"] += 1
            return None
        while self.pool.num_free < n:
            if not self._reclaim_one(exclude, allow_preempt):
                return None
        return self.pool.allocator.alloc(n, hint=hint)

    # ------------------------------------------------------------------ #
    # replication-aware placement (mesh): hot short prefix nodes are
    # copied onto every data shard so their rows skip the cross-shard
    # merge (core.plan.replicated_node_set decides which rows may: a row
    # must be replicated along its whole path, or the merge would count
    # the shared partials once per shard)
    # ------------------------------------------------------------------ #
    def _node_total_pages(self, node) -> int:
        """Pool pages the node holds across all shards."""
        reps = node.meta.get("replicas")
        if reps is not None:
            return sum(len(v) for v in reps.values())
        return len(node.page_ids)

    def _release_node_pages(self, node) -> None:
        """Release every page the node holds (all replicas, or its single
        placement).  ``page_ids`` aliases the primary replica run, so a
        replicated node does not release it separately."""
        reps = node.meta.pop("replicas", None)
        node.meta.pop("replica_primary", None)
        if reps is not None:
            for rws in reps.values():
                self.pool.allocator.release(rws)
        elif node.page_ids:
            self.pool.allocator.release(node.page_ids)
        node.page_ids = []

    def _promote_replicas(self, node) -> bool:
        """Copy a node's KV onto every shard and free its old placement
        (its pages have refcount 1: only the node holds them).  The copy
        runs on the stream after the work that wrote the sources."""
        alloc = self.pool.allocator
        D = self.pool.num_shards
        n = len(node.page_ids)
        # the tie-break of alloc_replicas' affinity pin
        primary = max(range(D),
                      key=lambda i: (alloc.shards[i].num_free, -i))
        try:
            reps = alloc.alloc_replicas(n, hint=node.id)
        except MemoryError:
            return False
        dst = [g for s in range(D) for g in reps[s]]
        self.pool.copy_pages(dst, list(node.page_ids) * D)
        alloc.release(node.page_ids)
        node.meta["replicas"] = reps
        node.meta["replica_primary"] = primary
        node.page_ids = list(reps[primary])
        self.stats["replica_promotions"] += 1
        self._plan_dirty = True
        return True

    def _demote_replicas(self, node) -> None:
        """Back to one placement: keep the primary run, free the rest.
        The running plan reads the freed rows, so it is marked dirty and
        rebuilt before the next dispatch (replays already queued read them
        before any later write: one stream orders both)."""
        reps = node.meta.pop("replicas", None)
        if reps is None:
            return
        primary = node.meta.pop("replica_primary")
        for s, rws in reps.items():
            if s != primary:
                self.pool.allocator.release(rws)
        node.page_ids = list(reps[primary])
        self.stats["replica_demotions"] += 1
        self._plan_dirty = True

    def _replication_sweep(self, rows: List[int]) -> None:
        """Promote the nodes whose saved merge beats their extra reads
        (``CostModel.replicate_gain``), headroom permitting: every shard
        must fit the node and a page of tail growth a running row."""
        alloc = self.pool.allocator
        D = self.pool.num_shards
        rowset = set(rows)
        seen: Set[int] = set()
        for r in rows:
            for node in self.forest.path(r):
                if node.id in seen:
                    continue
                seen.add(node.id)
                if (not node.page_ids or "replicas" in node.meta
                        or node.meta.get("draft")):
                    continue
                n_q = sum(1 for q in node.requests if q in rowset)
                if n_q == 0:
                    continue
                if self.cost_model.replicate_gain(n_q, node.length, D) <= 0:
                    continue
                n = len(node.page_ids)
                if min(s.num_free for s in alloc.shards) < n + len(rows):
                    continue
                self._promote_replicas(node)

    def _grow_node_pages(self, node, k: int,
                         exclude: Set[int]) -> Optional[List[int]]:
        """Grow a node by ``k`` pages.  A replicated node grows on every
        shard (all or nothing), or is demoted to its primary placement
        when a shard cannot fit them; the reclaiming allocator then takes
        over.  Returns the (primary's) new rows."""
        reps = node.meta.get("replicas")
        if reps is not None:
            try:
                new = self.pool.allocator.alloc_replicas(k, hint=node.id)
            except MemoryError:
                self._demote_replicas(node)
            else:
                for s, rws in new.items():
                    reps[s].extend(rws)
                primary = node.meta["replica_primary"]
                node.page_ids = list(reps[primary])
                return new[primary]
        got = self._alloc_pages(k, exclude, hint=node.id)
        if got is not None:
            node.page_ids += got
        return got

    # ------------------------------------------------------------------ #
    # measured-cost calibration: refit the cost model's coefficients from
    # the step timings in ``step_stats``
    # ------------------------------------------------------------------ #
    def recalibrate(self, min_samples: int = 8) -> bool:
        """Fit ``CostModel`` coefficients from measured mesh steps.

        Mesh steps record their epoch's features (``hbm_bytes``,
        ``grid_steps``, ``merge_bytes``, ``merge_rounds``) beside the
        measured ``dispatch_time``, which under ``calibrate=True`` waits
        for the device and so is the step's time.  Steps that hit a
        capture or a plan epoch lie far above the steady state, so
        samples beyond 5x the median are dropped first.  Sampled
        profiling rows (``telemetry.profile_every``) carry a device time
        even with ``calibrate`` off and are preferred when any exist.
        Returns True when a fit was installed.

        On this port every shard of a mesh runs on one device, in turn,
        while the features charge the heaviest shard (a real mesh's
        makespan): a fit here describes that serial run, not a mesh of
        cards.  On a process mesh each rank measures its own steps; the
        fit takes their max over the ranks (a real mesh's makespan), so
        every rank fits the same coefficients."""
        rows = [s for s in self.step_stats if s.get("hbm_bytes")]
        if self._ranked and rows:
            secs = self.mesh.host_max(
                [v for s in rows for v in (s.get("dispatch_time", 0.0),
                                           s.get("compute_time", 0.0))])
            rows = [{**s, "dispatch_time": secs[2 * i],
                     **({"compute_time": secs[2 * i + 1]}
                        if "compute_time" in s else {})}
                    for i, s in enumerate(rows)]
        profiled = [s for s in rows if s.get("profiled")]
        pool = profiled or [s for s in rows
                            if s.get("dispatch_time", 0) > 0]
        samples = [{**s, "seconds": s["dispatch_time"]
                    + (s.get("compute_time", 0.0)
                       if s.get("profiled") else 0.0)}
                   for s in pool if s.get("dispatch_time", 0) > 0
                   or s.get("compute_time", 0) > 0]
        if samples:
            med = float(np.median([s["seconds"] for s in samples]))
            samples = [s for s in samples if s["seconds"] <= 5.0 * med]
        if self.cost_model.fit(samples, min_samples=min_samples):
            self.stats["calibrations"] += 1
            return True
        return False

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
            z = self.pool.k.new_zeros((0,) + self.pool.kv_shape)
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
        self._mamba_pos.pop(req.rid, None)
        if self.telemetry is not None:
            self.telemetry.end(track=req.rid)         # "prefill"
            self.telemetry.begin("decode", track=req.rid)

    def _note_token(self, req: Request) -> None:
        """Telemetry: a committed token value of ``req`` just became
        host-visible (TTFT and TPOT attribution)."""
        now = self.clock()
        if req.first_tok_t is None:
            req.first_tok_t = now
        req.last_tok_t = now

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
    def _prefill_step(self, req: Request, budget: Optional[int],
                      stop_at: Optional[int] = None) -> int:
        """Advance the request's prefill by one chunk of ``<= budget``
        tokens (``None`` = the whole remaining span); returns tokens
        computed (0 = stalled on pages, retried next step).  ``stop_at``
        caps the chunk at an absolute position: cascade phase A stops at
        the group's shared frontier.

        Attention KV of the cached prefix is reused (gathered from the
        paged pool); SSM layers resume from the deepest cached boundary —
        the carried chunk state, else a node-boundary ``meta["ssm"]`` —
        and their states are cached at every shared node end inside the
        span, so later siblings resume exactly.  The span starts at the
        earlier of the two.  A fully cached prompt recomputes only its
        final position so its logits exist.  When the sequence completes,
        the request joins the decode batch; ``pending`` is sampled only if
        it did not survive a preemption.  The chunk's seconds: on the card a
        pair of CUDA events around its work (read by ``prefill_time``), on
        the CPU the host clock.
        """
        cfg = self.cfg
        rid = req.rid
        seq = req.seq
        total = len(seq)
        path = self.forest.path(rid)
        kv_filled = self._filled_front(rid)
        has_mamba = self._has_mamba
        if kv_filled < total:
            attn_start = kv_filled
        elif req.pending is None:
            # fully cached prompt: recompute the final position for its
            # logits; recurrent archs still rewind to the deepest cached
            # SSM boundary (mamba_start below)
            attn_start = total - 1
        else:
            attn_start = total
        mamba_init: Dict[int, M.State] = {}
        mamba_start = 0
        if has_mamba:
            carried = self._mamba_pos.get(rid)
            if carried is not None and carried == attn_start:
                mamba_start = carried
                mamba_init = {j: st[rid]
                              for j, st in self.mamba_state.items()
                              if rid in st}
            else:
                pos = 0
                for node in path:
                    f = min(node.meta.get("filled", 0), node.length)
                    pos += node.length
                    if f < node.length or pos > attn_start:
                        break
                    if "ssm" in node.meta:
                        mamba_start, mamba_init = pos, node.meta["ssm"]
        if attn_start >= total and (not has_mamba or mamba_start >= total):
            # every position is cached, the SSM state at the sequence's end
            # too (a shared node ends there): decode resumes from it
            # (``repro`` promotes without it)
            for j, state in mamba_init.items():
                self.mamba_state.setdefault(j, {})[rid] = state
            self._promote(req)
            return 0
        start = min(attn_start, mamba_start) if has_mamba else attn_start
        # a chunk of the budget, never below one new token of progress
        end = total if budget is None else min(
            total, max(start + max(budget, 1), kv_filled + 1))
        if stop_at is not None and stop_at < end:
            # never below the minimum-progress floor above
            end = max(stop_at, min(kv_filled + 1, total))
        if not self._ensure_pages_upto(rid, end):
            self.stats["prefill_stalls"] += 1
            return 0
        c0 = self.clock() if self.telemetry is not None else 0.0
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

        x = self.model.embed_tokens(tokens[None], positions)
        leaf_id = self.forest.leaf_of[rid]
        new_kv = []  # (layer_attn, k (Tn,kv,hd), v)
        for j, layer in enumerate(self.layers):
            h = L.apply_norm(layer.ln, x, cfg)
            if layer.kind.mixer == "mamba":
                state = mamba_init.get(j)
                ys = []
                for node, lo, hi in segments:
                    y_seg, state = M.mamba_prefill(layer.mamba, cfg,
                                                   h[:, lo:hi], state)
                    ys.append(y_seg)
                    # cache the end-of-node state (shared nodes only, and
                    # only when the chunk reaches the node's end; a leaf's
                    # state keeps moving, carried per request below)
                    if node.id != leaf_id and start + hi == node.end_pos:
                        node.meta.setdefault("ssm", {})[j] = state
                self.mamba_state.setdefault(j, {})[rid] = state
                x = x + torch.cat(ys, 1)
                x, _ = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)
                continue
            la = self.attn_layer_idx[j]
            window = layer.window
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
            x, _ = L.apply_ffn_block(layer, cfg, layer.kind.ffn, x)

        # write new KV into unfilled page slots only
        offs, pages, kv_rows = [], [], []
        ps = self.page_size
        for node, lo, hi in segments:
            filled = node.meta.get("filled", 0)
            base = node.start_pos - start   # span-local index of token 0
            t_hi = hi - base
            # a replicated node's KV lands in every replica's pages (the
            # same source row scattered to each), keeping them in step
            reps = node.meta.get("replicas")
            page_lists = list(reps.values()) if reps else [node.page_ids]
            for t in range(max(filled, lo - base), t_hi):
                for pl in page_lists:
                    pages.append(pl[t // ps])
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
        if self.telemetry is not None:
            c1 = self.clock()
            self.telemetry.complete("prefill_chunk", c0, c1, track=rid,
                                    args={"tokens": Tn})
            self.telemetry.observe("prefill_chunk_s", c1 - c0)
        if end < total:
            self.stats["prefill_chunks"] += 1
            if has_mamba:
                self._mamba_pos[rid] = end
        elif req.pending is None:
            logits = self.model.unembed(x[:, -1])               # (1, V)
            req.pending = int(sampler.sample(logits, self._split_key(),
                                             self.temperature)[0])
        self._prefill_done(t0)
        if end == total:
            self._promote(req)
        return Tn

    # ------------------------------------------------------------------ #
    # plan management
    # ------------------------------------------------------------------ #
    def _windows(self) -> List[int]:
        """The attention windows, one plan each (none without attention)."""
        return sorted({self.layers[j].window for j in self.attn_layer_idx})

    @property
    def plan_rebuilds(self) -> int:
        return self.stats["replans"]

    def _rebuild_plans(self) -> None:
        t0 = time.perf_counter()
        c0 = self.clock() if self.telemetry is not None else 0.0
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
        if self.telemetry is not None:
            c1 = self.clock()
            self.telemetry.complete("plan_build", c0, c1,
                                    args={"rows": len(rows)})
            self.telemetry.observe("plan_build_s", c1 - c0)

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
    _FAULT_COUNTERS = ("cancelled", "timed_out", "failed",
                       "callback_errors", "faults_injected",
                       "dispatch_failures", "dispatch_recoveries")
    _SPEC_COUNTERS = ("spec_proposed", "spec_accepted")

    def step(self) -> Dict[int, int]:
        """One engine step: deadlines, admission + chunked prefill, then
        append pending tokens (evicting under pressure) and decode one
        token per running request under the dispatch degradation ladder;
        then the cache sweep, streaming and stream closes.  Appends the
        step's record to ``step_stats``; with telemetry, the step's span,
        its histograms and the registry's sync."""
        tm = self.telemetry
        snap = {k: self.stats[k]
                for k in self._STEP_COUNTERS + self._FAULT_COUNTERS
                + self._SPEC_COUNTERS}
        # the step's timing starts here: a flush run by the deadline sweep
        # or by admission bills this step's flush_time, never the decode
        # phase's dispatch/device split
        self._decode_timing = {}
        snap_steps = self.stats["steps"]
        if tm is not None:
            c_step0 = self.clock()
            tm.begin("step", args={"step": len(self.step_stats)})
        if self.injector is not None:
            self.injector.tick(len(self.step_stats))
        self._enforce_deadlines()
        self._admit_phase()
        out = self._decode_with_recovery()
        if self.cache is not None:
            self.cache.tick()
            self._detach_finished()
            self._cache_sweep()
        self._stream_ready()
        self._notify_done()
        if self.check_every and (len(self.step_stats) + 1) \
                % self.check_every == 0:
            self.check()
        cache_stats = {}
        if self.cache is not None:
            d = self._cache_step_delta()
            resident = self.cache.resident_pages()
            cache_stats = {
                "cache_hits": d["hits"],
                "cache_hit_rate": self.cache.hit_rate,
                "cache_resident_pages": resident,
                "cache_resident_bytes": resident * self.pool.page_bytes,
                "cache_evicted_nodes": d["evicted_nodes"],
            }
        self.step_stats.append({
            "step": len(self.step_stats),
            "decoded": len(out),
            **self._decode_timing,
            **{k: self.stats[k] - snap[k] for k in self._STEP_COUNTERS},
            **({k: self.stats[k] - snap[k] for k in self._SPEC_COUNTERS}
               if self.spec is not None else {}),
            "waiting": len(self.admission),
            "prefilling": len(self._prefilling),
            "running": len(self._active_rows()),
            "pages_free": self.pool.num_free,
            "occupancy": self.pool.occupancy(),
            **{k: self.stats[k] - snap[k] for k in self._FAULT_COUNTERS},
            **cache_stats,
        })
        if tm is not None:
            tm.metrics["engine_steps"].inc()
            if self.mesh is not None and self._epoch_features \
                    and self.stats["steps"] > snap_steps:
                tm.metrics["merge_bytes"].inc(
                    self._epoch_features["merge_bytes"])
                tm.metrics["merge_rounds"].inc(
                    self._epoch_features["merge_rounds"])
            t = self._decode_timing
            if "dispatch_time" in t:
                tm.observe("dispatch_s", t["dispatch_time"])
            if t.get("profiled"):
                tm.observe("profile_dispatch_s", t["dispatch_time"])
                tm.observe("profile_device_s", t.get("compute_time", 0.0))
                tm.observe("profile_host_s", t.get("host_time", 0.0))
            self._publish_telemetry()
            c_step1 = self.clock()
            tm.observe("step_s", c_step1 - c_step0)
            tm.end(args={"decoded": len(out)})            # "step"
        return out

    def _publish_telemetry(self) -> None:
        """Fold the cumulative engine and cache stats into the registry
        (monotone counter deltas) and refresh the gauges; runs every step
        and before any metrics export."""
        tm = self.telemetry
        if tm is None:
            return
        tm.sync_counters("engine", self.stats,
                         telemetry_mod.ENGINE_STAT_COUNTERS)
        gauges = {
            "pool_occupancy": self.pool.occupancy(),
            "pool_free_pages": self.pool.num_free,
            "backoff_pages": self._backoff_pages,
            "running": len(self._active_rows()),
            "waiting": len(self.admission),
            "prefilling": len(self._prefilling),
        }
        if self.cache is not None:
            tm.sync_counters("cache", self.cache.stats,
                             telemetry_mod.CACHE_STAT_COUNTERS)
            resident = self.cache.resident_pages()
            gauges.update(cache_hit_rate=self.cache.hit_rate,
                          cache_resident_pages=resident,
                          cache_resident_bytes=resident
                          * self.pool.page_bytes)
        if self.fused:
            # step states kept, one a bucket signature: on the card the
            # CUDA graphs captured (``repro``: jit cache entries)
            gauges["compile_count"] = self.fused_cache_size
        tm.set_gauges(gauges)

    def publish_metrics(self):
        """Sync point for registry readers: returns the up-to-date
        ``core.metrics.MetricsRegistry``, or None when telemetry is
        off."""
        if self.telemetry is None:
            return None
        self._publish_telemetry()
        return self.telemetry.metrics

    def export_metrics(self, path: str, extra=None) -> None:
        """Sync and write the schema-tagged metrics JSON."""
        if self.telemetry is None:
            raise RuntimeError(
                "export_metrics needs DecodeEngine(telemetry=...)")
        self._publish_telemetry()
        self.telemetry.export_metrics(path, extra=extra)

    def _split_key(self) -> torch.Tensor:
        """Advance the engine's key in place (``repro``'s ``self.key, sk
        = jax.random.split(self.key)``); returns the subkey.  Greedy
        decoding draws no bits, so there the key stays as it is: its
        state cannot show in any stream."""
        if self.temperature == 0.0:
            return self.key
        keys = sampler.split(self.key)
        self.key.copy_(keys[0])
        return keys[1]

    def _decode_with_recovery(self) -> Dict[int, Optional[int]]:
        """The decode phase under the degradation ladder: a recoverable
        dispatch failure (``ResourceExhausted``, from a backend or the
        fault injector) walks one rung per retry (demote a replicated
        node, evict cached nodes, then reclaim or preempt, then shrink
        admission), each followed by a full ``check()``; past
        ``max_dispatch_retries`` it propagates."""
        for attempt in range(self.max_dispatch_retries + 1):
            try:
                return self._decode_phase()
            except ResourceExhausted:
                self.stats["dispatch_failures"] += 1
                if (attempt >= self.max_dispatch_retries
                        or not self._recover_dispatch()):
                    raise
                self.stats["dispatch_recoveries"] += 1
                self._plan_dirty = True
                self.check()
        return {}

    def _recover_dispatch(self) -> bool:
        """One rung of the degradation ladder; ``True`` if anything gave."""
        repl = [n for n in self.forest.nodes.values()
                if "replicas" in n.meta]
        if repl:
            self._demote_replicas(max(repl,
                                      key=lambda n: len(n.page_ids)))
            return True
        if self.cache is not None and self._evict_cached(1) > 0:
            return True
        if self._reclaim_one(set(), allow_preempt=True):
            return True
        if self._backoff_pages < self.pool.num_pages:
            self._backoff_pages += max(1, self.pool.num_pages // 16)
            return True
        return False

    def _decode_phase(self) -> Dict[int, Optional[int]]:
        if self.injector is not None:
            spec = self.injector.take("stall")
            if spec is not None:
                # a latency fault (a slow device or host hiccup): the
                # engine rides it out, streams are unaffected
                self.stats["faults_injected"] += 1
                time.sleep(float(spec.payload) or 0.002)
            spec = self.injector.take("dispatch")
            if spec is not None:
                # raised before any state changes, like an out-of-memory
                # at dispatch: the retry re-enters cleanly
                self.stats["faults_injected"] += 1
                raise ResourceExhausted(
                    f"injected dispatch failure at step "
                    f"{len(self.step_stats)}: out of device memory "
                    f"(simulated)")
        if self.spec is not None:
            return self._decode_phase_spec()
        if self.fused:
            return self._decode_phase_fused()
        return self._decode_phase_eager()

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
        that outgrows the pool fails (``kv_exhausted``).  Device pendings
        (fused path) are appended as placeholders and patched at the next
        ``flush_tokens``."""
        for r in rows0:
            req = self.requests[r]
            if req.state != RUNNING:    # evicted growing an earlier row
                continue
            if req.pending is None:     # dispatch-retry re-entry: this
                continue                # row already appended this step
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
                if self.telemetry is not None:
                    self._note_token(req)
            req.pending = None
            try:
                self._grow_leaf_tail(r)
            except MemoryError:
                # with other tenants the pressure is transient:
                # preempt-and-recompute keeps the greedy stream intact
                others = [q for q in self.requests.values()
                          if q.rid != r
                          and q.state in (WAITING, PREFILL, RUNNING)]
                if others:
                    self._preempt(r)
                else:
                    # a lone request can never get more room: fail it
                    # instead of livelocking
                    self._fail_request(r, "kv_exhausted", flush=False)

    @torch.no_grad()
    def _decode_phase_eager(self) -> Dict[int, int]:
        rows0 = self._active_rows()
        if not rows0:
            return {}
        t0 = time.perf_counter()
        c0 = self.clock() if self.telemetry is not None else 0.0
        flush_before = self._decode_timing.get("flush_time", 0.0)
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

        def mix(j, mixer, h):
            # the rows' states stepped together, written back per row
            states = self.mamba_state[j]
            conv = torch.cat([states[r][0] for r in rows], 0)
            ssm = torch.cat([states[r][1] for r in rows], 0)
            y, (conv_n, ssm_n) = M.mamba_decode(mixer, self.cfg, h, conv,
                                                ssm)
            for i, r in enumerate(rows):
                states[r] = (conv_n[i:i + 1], ssm_n[i:i + 1])
            return y

        logits = step_fn_mod.decode_stack(
            self.model, self.pool, self.attn_layer_idx, tok, q_pos,
            tail_pages, tail_base, tail_off, self._attend, mix)   # (B, V)
        if self.injector is not None:
            spec = self.injector.take("nan_logits")
            if spec is not None:
                target = spec.rid if spec.rid in rows else rows[0]
                logits[rows.index(target)] = float("nan")
                self.stats["faults_injected"] += 1
        self.last_logits, self.last_rows = logits, list(rows)
        toks = sampler.sample(logits, self._split_key(), self.temperature)
        t1 = time.perf_counter()
        # the launches are done; the copy to the host waits for the device
        toks = toks.cpu().numpy()
        t2 = time.perf_counter()
        bad_rows: List[int] = []
        if self.nan_guard:
            # the eager path syncs every step anyway: the finite check
            # costs one more small copy
            okv = torch.isfinite(logits).all(-1).cpu().numpy()
            bad_rows = [r for i, r in enumerate(rows) if not okv[i]]
        out = {}
        for i, r in enumerate(rows):
            if r in bad_rows:
                continue
            req = self.requests[r]
            req.pending = int(toks[i])
            req.computed_hwm = max(req.computed_hwm, int(ctx[i]))
            out[r] = int(toks[i])
            if len(req.generated) >= req.max_new:
                req.state = DONE
        for r in bad_rows:
            # quarantine: the poisoned token never enters the stream, the
            # batch decodes on without the failed row
            self.stats["nan_rows"] += 1
            self._fail_request(r, "nan_logits", flush=False)
        self.stats["steps"] += 1
        # a flush inside this phase (a preempting append) billed
        # flush_time already; keep it out of the dispatch split
        flush_in = self._decode_timing.get("flush_time", 0.0) \
            - flush_before
        self._decode_timing.update(
            dispatch_time=max(0.0, t1 - t0 - flush_in),
            compute_time=t2 - t1)
        self.stats["decode_dispatch_time"] += \
            self._decode_timing["dispatch_time"]
        self.stats["decode_time"] += time.perf_counter() - t0
        if self.telemetry is not None:
            self.telemetry.complete("decode", c0, self.clock(),
                                    args={"mode": "eager",
                                          "rows": len(rows)})
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
        tm = self.telemetry
        c0 = self.clock() if tm is not None else 0.0
        flush_before = self._decode_timing.get("flush_time", 0.0)
        # sampled profiling (telemetry.profile_every): this step waits for
        # the device after its replay to split host preparation, launch
        # and device time; the other steps are left as they are
        profiled = tm is not None and tm.should_profile(
            len(self.step_stats))
        # 1. append pending tokens (host ints after a sync or a prefill,
        #    otherwise placeholders for the in-flight step outputs)
        self._append_pending(rows0)
        rows = self._active_rows()
        if not rows:
            return {}
        # 2. plan lifecycle: a new epoch is a sync point (deferred tokens
        #    land; plans and the step's base are rebuilt, bucketed); within
        #    an epoch the step advances itself on the device
        epoch = (self._plan_dirty
                 or plan_mod.plan_key(self.forest, rows) != self._plan_key)
        if epoch or len(self._deferred) >= self.fused_step.ring_size:
            # a sync point (for the ring: every pinned output slice is
            # held).  The NaN guard may quarantine rows here, which then
            # leave the batch and dirty the plan.  (``repro`` builds the
            # epoch from the rows of before its flush, and fails on a
            # quarantined one.)
            self.flush_tokens()
            rows = self._active_rows()
            if not rows:
                return {}
            epoch = epoch or self._plan_dirty
        if epoch:
            self._fused_epoch(rows)
        # injected NaN: corrupt one live K slot of the target's private
        # leaf (the previous token's, which the step's attention reads),
        # so the step itself produces the NaN logits that its finite flag
        # reports at the next flush
        if self.injector is not None:
            spec = self.injector.take("nan_logits")
            if spec is not None:
                target = spec.rid if spec.rid in rows else rows[0]
                leaf = self.forest.nodes[self.forest.leaf_of[target]]
                if (leaf.length >= 2 and len(leaf.requests) == 1
                        and not leaf.children):
                    slot = leaf.length - 2
                    page = leaf.page_ids[slot // self.page_size]
                    off = slot % self.page_size
                    self.pool.fill_slot(page, off, float("nan"))
                    self._nan_dirty.append((page, off))
                    self.stats["faults_injected"] += 1
                else:       # leaf shared or too short: try again later
                    self.injector.requeue(spec)
        # 3. one replay: layers, KV writes, attention, FFN, unembed,
        #    sampling
        t_d0 = time.perf_counter()
        host, event = self.fused_step()
        t_d1 = time.perf_counter()
        # calibration fits against the step's true time, so a calibrating
        # mesh waits for every step (sampled profiling for its steps only)
        calibrating = self.calibrate and self.mesh is not None
        if (profiled or calibrating) and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_d2 = time.perf_counter()
        dispatch = (t_d2 if calibrating else t_d1) - t_d0
        self.stats["decode_dispatch_time"] += dispatch
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
        flush_in = self._decode_timing.get("flush_time", 0.0) \
            - flush_before
        self._decode_timing.update(dispatch_time=dispatch)
        if profiled and not calibrating:
            self._decode_timing.update(
                compute_time=t_d2 - t_d1, profiled=True,
                host_time=max(0.0, t_d0 - t0 - flush_in))
        if self._ranked:
            # under gloo the rank step runs uncaptured
            self._decode_timing.update(graph=self.fused_step.captures)
        if self.mesh is not None and self._epoch_features:
            self._decode_timing.update(self._epoch_features)
            if profiled and self._epoch_shard_features:
                self._decode_timing.update(self._epoch_shard_features)
        if done_any:
            # completion boundary: finished streams must be readable
            self.flush_tokens()
            for r in rows:
                if self.requests[r].state == DONE:
                    out[r] = self.requests[r].pending
        self.stats["decode_time"] += time.perf_counter() - t0
        if tm is not None:
            tm.complete("decode", c0, self.clock(),
                        args={"mode": "fused", "rows": len(rows),
                              "profiled": bool(profiled)})
        return out

    def _fused_epoch(self, rows: List[int]) -> None:
        """Start a new plan epoch (the fused path's one sync point): plans
        bucketed to the row bucket, loaded with the step's base into the
        signature's fixed buffers (captured on first use); the previous
        epoch's SSM carry synced back, the new rows' gathered."""
        self.flush_tokens()
        self._sync_mamba_state()
        t0 = time.perf_counter()
        c0 = self.clock() if self.telemetry is not None else 0.0
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
        plans: List = []
        if self.mesh is not None:
            sig, host, base = self._sharded_epoch(rows, bucket, req_rows,
                                                  truncate, q_pos0)
        else:
            build = (plan_mod.flash_plan
                     if self._backend.plan_kind == "flash"
                     else plan_mod.build_plan)
            host, sig = [], [bucket]
            for w in self._windows():
                p = build(self.forest, self.cost_model, self.num_lanes,
                          self.max_q, self.max_kv_per_task,
                          req_rows=req_rows, window=w, truncate=truncate)
                p = plan_mod.bucket_plan(p, bucket)
                cls, arrs = self._backend.host_arrays(p)
                plans.append(p)
                host.append((cls, arrs))
                sig.append((w, cls.__name__, tuple(a.shape for a in arrs)))
            base = step_fn_mod.step_base(
                [self.requests[r].generated[-1] for r in rows], q_pos0,
                tail, bucket, self.pool.trash_page)
        sig = tuple(sig)
        self.bucket_signatures.add(sig)
        self.stats["plan_time"] += time.perf_counter() - t0
        capture0 = self.fused_step.capture_time
        prepared = self.fused_step.epoch(sig, host, base)
        self.stats["capture_time"] += self.fused_step.capture_time - capture0
        self._gather_mamba_state(rows)
        # (a mesh epoch keeps its per-shard plans in _sharded_plans)
        self._plans = {w: (p, pa) for w, p, pa in
                       zip(self._windows(), plans, prepared)}
        self._plan_key = plan_mod.plan_key(self.forest, rows)
        self._plan_dirty = False
        self.stats["replans"] += 1
        if self.telemetry is not None:
            # on the card a signature's first epoch includes its capture
            c1 = self.clock()
            self.telemetry.complete("plan_build", c0, c1,
                                    args={"rows": len(rows),
                                          "bucket": bucket})
            self.telemetry.observe("plan_build_s", c1 - c0)

    def _sharded_epoch(self, rows: List[int], bucket: int,
                       req_rows: Dict[int, int], truncate: Dict[int, int],
                       q_pos0: List[int]):
        """A mesh epoch: the replication sweep and the recalibration when
        on, one plan a data shard per window (subtasks on the shard that
        holds their pages, sequence splits cut at shard boundaries:
        ``core.plan.build_sharded_plan``) bucketed to common shapes, the
        tail layout as each shard's local page rows (non-owners at their
        trash page), and the rows the merge packs.  Returns the
        signature, the plans' host arrays (per window, one a shard) and
        ``ShardedStepBase``'s arrays."""
        ps = self.page_size
        D = self.pool.num_shards
        if self.replicate:
            self._replication_sweep(rows)
        if self.calibrate:
            # refit from the measured steps, so the plans built below
            # divide, balance and replicate on measured costs
            self.recalibrate()
        host: List = []
        sig: List = [("mesh", D, self.mesh.shape["model"], bucket)]
        self._sharded_plans = {}
        for w in self._windows():
            sp = plan_mod.build_sharded_plan(
                self.forest, self.cost_model, D, self.pool.page_stride,
                self.num_lanes, self.max_q, self.max_kv_per_task,
                req_rows=req_rows, window=w, truncate=truncate,
                num_rows=bucket)
            self._sharded_plans[w] = sp
            shards = [self._backend.host_arrays(p) for p in sp.shards]
            cls, arrs = shards[0]
            host.append(shards)
            sig.append((w, cls.__name__, tuple(a.shape for a in arrs)))

        # which rows the merge packs, and which shards hold a shard-local
        # contribution to them (every window ORed: one contributor vector
        # serves every layer)
        row_sh = np.zeros((D, bucket), bool)
        merge_mask = np.zeros(bucket, bool)
        rep_set: Set[int] = set()
        for sp in self._sharded_plans.values():
            row_sh |= sp.row_shards
            merge_mask |= sp.merge_rows
            rep_set |= sp.replicated
        B = len(rows)
        tail_page = np.zeros((D, B), np.int64)
        tail_owner = np.zeros((D, B), bool)
        tail_base, tail_off0 = [], []
        for i, r in enumerate(rows):
            leaf = self.forest.nodes[self.forest.leaf_of[r]]
            tp = (leaf.length - 1) // ps
            tail_page[:, i] = self.pool.local_trash
            reps = leaf.meta.get("replicas")
            if reps is not None:
                # every shard writes the row's new KV into its own replica
                # tail page, keeping the replicas alike; a fully
                # replicated row owns its tail everywhere (alike results),
                # a merged row only on the primary (one contribution)
                for sh in range(D):
                    tail_page[sh, i] = self.pool.local_of(reps[sh][tp])
                if leaf.id in rep_set:
                    tail_owner[:, i] = True
                else:
                    sh = self.pool.shard_of(leaf.page_ids[tp])
                    tail_owner[sh, i] = True
                    row_sh[sh, i] = True
            else:
                g = leaf.page_ids[tp]
                sh = self.pool.shard_of(g)
                tail_page[sh, i] = self.pool.local_of(g)
                tail_owner[sh, i] = True
                row_sh[sh, i] = True
            tail_base.append(leaf.start_pos + tp * ps)
            tail_off0.append((leaf.length - 1) % ps)
        # Bm (a power of two, or 0: no merge) is part of the signature;
        # which rows and shards are not
        mrows = np.nonzero(merge_mask)[0] if D > 1 else np.zeros(0, int)
        contrib = (row_sh[:, merge_mask].any(axis=1) if len(mrows)
                   else np.zeros(D, bool))
        base = sharded_step_base(
            [self.requests[r].generated[-1] for r in rows], q_pos0,
            tail_page, tail_base, tail_off0, tail_owner, mrows, contrib,
            bucket, self.pool.local_trash)
        Bm = base[7].shape[0]
        sig.append(("merge", Bm))
        self._record_epoch_features(Bm)
        if self._ranked:
            # the ranks must agree on the whole host plan before the step's
            # collectives: a divergent rank raises on every rank
            self.mesh.agree(digest(
                self._host_log, rows, sig,
                self.injector and sorted(self.injector.fired.items()),
                *(a.tobytes() for shards in host for _, arrs in shards
                  for a in arrs),
                *(np.asarray(a).tobytes() for a in base)), "the plan epoch")
        return sig, host, base

    def _record_epoch_features(self, merge_bucket: int) -> None:
        """The new epoch's per-step cost-model features, attached to every
        step record until the next epoch (``recalibrate`` fits against
        them).  Compute terms take the heaviest shard's totals over its
        lanes: the makespan the scheduler minimises on a real mesh."""
        ps = self.page_size
        lanes = max(self.num_lanes, 1)
        n_attn_w = {w: 0 for w in self._windows()}
        for j in self.attn_layer_idx:
            n_attn_w[self.layers[j].window] += 1
        hbm = steps = 0.0
        shard_hbm: List[float] = []
        shard_steps: List[float] = []
        for w, sp in self._sharded_plans.items():
            per_shard = [sum(self.cost_model.hbm_bytes(s.n_q, s.n)
                             for s in p.subtasks) for p in sp.shards]
            per_steps = [sum(max(1, -(-s.n // ps)) for s in p.subtasks)
                         for p in sp.shards]
            if not per_shard:
                continue
            if not shard_hbm:
                shard_hbm = [0.0] * len(per_shard)
                shard_steps = [0.0] * len(per_steps)
            for i, (b, g) in enumerate(zip(per_shard, per_steps)):
                shard_hbm[i] += n_attn_w[w] * b / lanes
                shard_steps[i] += n_attn_w[w] * g / lanes
            k = int(np.argmax(per_shard))
            hbm += n_attn_w[w] * per_shard[k] / lanes
            steps += n_attn_w[w] * per_steps[k] / lanes
        D = self.pool.num_shards
        rounds = (int(np.ceil(np.log2(D)))
                  if D > 1 and merge_bucket > 0 else 0)
        n_attn = sum(n_attn_w.values())
        wire = (merge_bucket * self.cfg.num_heads
                * (self.cfg.head_dim + 2) * 4)
        self._epoch_features = {
            "hbm_bytes": hbm, "grid_steps": steps,
            "merge_bytes": n_attn * rounds * wire,
            "merge_rounds": n_attn * rounds,
        }
        # per-shard vectors ride on profiled rows only
        self._epoch_shard_features = {
            "shard_hbm_bytes": shard_hbm,
            "shard_grid_steps": shard_steps,
        } if shard_hbm else {}

    def predicted_step_seconds(self, hw=None) -> float:
        """The cost model's attention and merge seconds a step for the
        current epoch on a real mesh: the heaviest shard's bytes and page
        steps plus the merge's wire and launch terms, under ``hw`` (by
        default the current, possibly recalibrated, coefficients; pass a
        fixed ``HardwareSpec`` to compare engines).  Leaves out the dense
        part of the step (FFN, unembedding, launch), which does not depend
        on the mesh."""
        f = self._epoch_features
        if not f:
            return 0.0
        hw = hw or self.cost_model.hw
        return (f["hbm_bytes"] / hw.hbm_bw
                + f["grid_steps"] * hw.grid_step_overhead
                + f["merge_bytes"] / hw.ici_bw
                + f["merge_rounds"] * hw.launch_overhead)

    def _sync_mamba_state(self) -> None:
        """Copy the fused SSM carry of the ending epoch back into the
        per-request store, for the rows still running (one device copy of
        the carry; each row keeps views of it).  The carry is read only
        here: no host-side path reads a running request's state before
        the next epoch, and a row whose request left (``_drop_mamba``) is
        skipped."""
        rows, self._fused_rows = self._fused_rows, None
        if not self._has_mamba or rows is None:
            return
        conv_all, ssm_all = (t.clone() for t in self.fused_step.carry)
        for j, li in self.fused_step.mamba_idx.items():
            st = self.mamba_state.setdefault(j, {})
            for i, r in enumerate(rows):
                req = self.requests.get(r)
                if req is not None and req.state == RUNNING:
                    st[r] = (conv_all[li, i:i + 1], ssm_all[li, i:i + 1])

    def _gather_mamba_state(self, rows: List[int]) -> None:
        """Load the new epoch's rows' SSM states into the slot's carry
        (padded rows zero)."""
        self._fused_rows = list(rows)
        if not self._has_mamba:
            return
        conv_all, ssm_all = self.fused_step.carry
        B = len(rows)
        for j, li in self.fused_step.mamba_idx.items():
            st = self.mamba_state[j]
            torch.cat([st[r][0] for r in rows], 0, out=conv_all[li, :B])
            torch.cat([st[r][1] for r in rows], 0, out=ssm_all[li, :B])
        conv_all[:, B:].zero_()
        ssm_all[:, B:].zero_()

    # ------------------------------------------------------------------ #
    # speculative tree decoding (speculation.py, ``repro``'s DESIGN §10):
    # draft-propose -> tree-verify (one multi-query dispatch) ->
    # accept/commit (KV moves from draft pages to the leaf tail) ->
    # rollback (draft pages released)
    # ------------------------------------------------------------------ #
    def _rollback_drafts(self, rid: int) -> None:
        """Release a request's live draft tree: detach the virtual
        branch-head queries, prune the draft nodes leaf-first, and return
        their pages to the allocator.  A no-op when the request holds no
        drafts.  On the card every replay that wrote those pages was read
        back on the host before (the verify step's output), and later
        writes to them run on the same stream, so a page may be handed
        out again at once."""
        st = self._drafts.pop(rid, None)
        if st is None:
            return
        for virt in st.virts:
            if virt in self.forest.leaf_of:
                self.forest.detach_request(virt)
        for nid in reversed(st.nodes):      # children before parents
            if nid not in self.forest.nodes:
                continue
            pages = self.forest.prune_leaf(nid)
            if pages:
                self.pool.allocator.release(pages)

    def _grow_drafts(self, rows: List[int]) -> None:
        """Propose and materialise each running request's draft tree.

        Draft pages are allocated best-effort: speculation never evicts to
        make room (a wrong guess would have paid an eviction for nothing),
        it drafts fewer nodes (``spec_draft_stalls``); committed progress
        is unaffected because verification degenerates to normal decode.
        """
        reserve = self.policy.reserve_pages
        for r in rows:
            req = self.requests[r]
            room = req.max_new - len(req.generated)
            if room <= 0:        # only the done transition is left
                continue
            branches = self.proposer.propose(req.seq, max_tokens=room)
            if not branches:
                continue
            leaf_id = self.forest.leaf_of[r]
            st = spec_mod.DraftState(r)
            stalled = False
            for chain in branches:
                parent = leaf_id
                for tok in chain:
                    if self.pool.num_free - reserve < 1:
                        stalled = True
                        break
                    node = self.forest.add_draft(parent, int(tok))
                    node.page_ids = self.pool.allocator.alloc(1)
                    virt = self._next_virt
                    self._next_virt -= 1
                    self.forest.attach_request(virt, node.id)
                    st.nodes.append(node.id)
                    st.virts.append(virt)
                    parent = node.id
                if stalled:
                    break
            if stalled:
                self.stats["spec_draft_stalls"] += 1
            if st.nodes:
                self._drafts[r] = st
                self.stats["spec_proposed"] += len(st.nodes)

    def _spec_layout(self, rows: List[int]):
        """Stack the verification queries: per request its committed-tail
        base query (the normal decode position), then one query per draft
        node, each with its token, absolute position and the KV slot the
        dispatch writes that token's K/V into."""
        ps = self.page_size
        tokens: List[int] = []
        q_pos: List[int] = []
        w_page: List[int] = []
        w_off: List[int] = []
        req_rows: Dict[int, int] = {}
        head_rows: Dict[int, Dict[int, int]] = {}
        for r in rows:
            req = self.requests[r]
            leaf = self.forest.nodes[self.forest.leaf_of[r]]
            tp = (leaf.length - 1) // ps
            head_rows[r] = {leaf.id: len(tokens)}
            req_rows[r] = len(tokens)
            tokens.append(req.generated[-1])
            q_pos.append(leaf.end_pos - 1)
            w_page.append(leaf.page_ids[tp])
            w_off.append((leaf.length - 1) % ps)
            st = self._drafts.get(r)
            if st is None:
                continue
            for nid, virt in zip(st.nodes, st.virts):
                node = self.forest.nodes[nid]
                head_rows[r][nid] = len(tokens)
                req_rows[virt] = len(tokens)
                tokens.append(int(node.tokens[0]))
                q_pos.append(node.end_pos - 1)
                w_page.append(node.page_ids[0])
                w_off.append(0)
        return tokens, q_pos, w_page, w_off, req_rows, head_rows

    @torch.no_grad()
    def _decode_phase_spec(self) -> Dict[int, Optional[int]]:
        rows0 = self._active_rows()
        if not rows0:
            return {}
        t0 = time.perf_counter()
        tm = self.telemetry
        self._append_pending(rows0)        # host ints: spec never defers
        rows = self._active_rows()
        if not rows:
            return {}
        c0 = self.clock() if tm is not None else 0.0
        self._grow_drafts(rows)
        if tm is not None:
            tm.complete("spec_propose", c0, self.clock(),
                        args={"rows": len(rows),
                              "drafts": sum(len(st.nodes) for st in
                                            self._drafts.values())})
        # injected NaN: poison a committed KV slot of the target's leaf so
        # every verify row of that request (base query and draft heads)
        # reads it through the verify plan
        if self.injector is not None:
            spec = self.injector.take("nan_logits")
            if spec is not None:
                target = spec.rid if spec.rid in rows else rows[0]
                leaf = self.forest.nodes[self.forest.leaf_of[target]]
                owners = [q for q in leaf.requests if q >= 0]
                kids = [c for c in leaf.children
                        if not self.forest.nodes[c].meta.get("draft")]
                if leaf.length >= 2 and owners == [target] and not kids:
                    slot = leaf.length - 2
                    page = leaf.page_ids[slot // self.page_size]
                    off = slot % self.page_size
                    self.pool.fill_slot(page, off, float("nan"))
                    self._nan_dirty.append((page, off))
                    self.stats["faults_injected"] += 1
                else:
                    self.injector.requeue(spec)
        tokens, q_pos, w_page, w_off, req_rows, head_rows = \
            self._spec_layout(rows)
        tp0 = time.perf_counter()
        plans = {w: plan_mod.build_verify_plan(
            self.forest, self.cost_model, req_rows, self.num_lanes,
            self.max_q, self.max_kv_per_task, window=w,
            kind=self._backend.plan_kind) for w in self._windows()}
        self.stats["replans"] += 1
        self.stats["plan_time"] += time.perf_counter() - tp0
        t_d0 = time.perf_counter()
        c_v0 = self.clock() if tm is not None else 0.0
        verify = (self._spec_verify_fused if self.spec_step is not None
                  else self._spec_verify_eager)
        toks, ok = verify(tokens, q_pos, w_page, w_off, plans)
        t_d1 = time.perf_counter()
        if tm is not None:
            tm.complete("spec_verify", c_v0, self.clock(),
                        args={"queries": len(tokens)})
        if self.nan_guard:
            # quarantine before commit: a poisoned request's drafts roll
            # back with it and nothing enters its committed stream
            for r in list(rows):
                if not bool(ok[req_rows[r]]):
                    self.stats["nan_rows"] += 1
                    self._fail_request(r, "nan_logits", flush=False)
        c_a0 = self.clock() if tm is not None else 0.0
        out = self._spec_commit(rows, toks, head_rows)
        self.stats["steps"] += 1
        self.stats["spec_steps"] += 1
        self._decode_timing.update(
            dispatch_time=t_d1 - t_d0,
            compute_time=time.perf_counter() - t_d1)
        self.stats["decode_dispatch_time"] += t_d1 - t_d0
        self.stats["decode_time"] += time.perf_counter() - t0
        if tm is not None:
            tm.complete("spec_accept", c_a0, self.clock(),
                        args={"accepted": sum(
                            1 for v in out.values() if v is not None)})
        return out

    def _spec_verify_eager(self, tokens, q_pos, w_page, w_off, plans):
        """Eager verification: ``step_fn.decode_stack`` over every row,
        each layer's attention the backend's parts over the verify plan
        and one epilogue launch with no tail; returns the greedy tokens
        and the finite-logits flags on the host."""
        dev = self.device
        prepared = {w: self._backend.prepare(p, dev)
                    for w, p in plans.items()}

        def attend(qb, k_pool, v_pool, window, *_):
            parts = self._backend.parts(qb, k_pool, v_pool, plans[window],
                                        prepared[window], window=window)
            return por_mod.por_epilogue(qb, *parts, k_pool, v_pool, None,
                                        None, None, window=window,
                                        tail=False)

        tok, qp, wp, wo = torch.as_tensor(
            np.asarray([tokens, q_pos, w_page, w_off], np.int64),
            device=dev).unbind(0)
        logits = step_fn_mod.decode_stack(
            self.model, self.pool, self.attn_layer_idx, tok, qp, wp, qp, wo,
            attend)
        out = torch.stack([torch.argmax(logits, -1),
                           torch.isfinite(logits).all(-1).long()]
                          ).cpu().numpy()
        return out[0], out[1]

    def _spec_verify_fused(self, tokens, q_pos, w_page, w_off, plans):
        """Fused verification: one replay of the signature's graph
        (``step_fn.SpecStep``) scores every row, with the verify plan
        bucketed (``plan.bucket_plan``) and loaded into the signature's
        fixed buffers; the host reads the result once a verify step."""
        B = len(tokens)
        bucket = plan_mod.bucket_pow2(B)
        host, sig = [], [("spec", bucket)]
        for w in self._windows():
            cls, arrs = self._backend.host_arrays(
                plan_mod.bucket_plan(plans[w], bucket))
            host.append((cls, arrs))
            sig.append((w, cls.__name__, tuple(a.shape for a in arrs)))
        sig = tuple(sig)
        self.bucket_signatures.add(sig)
        base = step_fn_mod.spec_base(tokens, q_pos, w_page, w_off, bucket,
                                     self.pool.trash_page)
        capture0 = self.spec_step.capture_time
        out = self.spec_step(sig, host, base)
        self.stats["capture_time"] += self.spec_step.capture_time - capture0
        self.stats["fused_calls"] += 1
        return out[0, :B].copy(), out[1, :B].copy()

    def _spec_commit(self, rows: List[int], toks: np.ndarray,
                     head_rows) -> Dict[int, Optional[int]]:
        """Greedy accept/commit/rollback for every request.

        Per request: walk the scored draft tree (``speculation.
        accept_walk``), roll the whole tree back (freeing its pages), then
        append the accepted tokens to the committed leaf, moving each
        one's KV from its draft page to the leaf's tail slot in one
        ``copy_slots`` (which reads every source before it writes, so a
        freed draft page handed straight back as the leaf's new page is
        safe), and carry the correction or bonus token as the next
        ``pending``.  The committed forest afterwards is exactly what
        non-speculative decode would have produced.
        """
        ps = self.page_size
        out: Dict[int, Optional[int]] = {}
        for r in rows:
            req = self.requests[r]
            if req.state != RUNNING:   # preempted committing earlier rows
                continue
            leaf_id = self.forest.leaf_of[r]
            rowmap = head_rows[r]
            room = req.max_new - len(req.generated)
            accepted, final_tok = spec_mod.accept_walk(
                self.forest, leaf_id, lambda nid: toks[rowmap[nid]], room)
            # source KV slots and token values, read before the rollback
            moves = [(self.forest.nodes[nid].page_ids[0],
                      int(self.forest.nodes[nid].tokens[0]))
                     for nid in accepted]
            self._rollback_drafts(r)
            copies = []
            for src_page, tok in moves:
                self.forest.append_token(r, tok)
                req.generated.append(tok)
                leaf = self._grow_leaf_tail(r)
                # exclude={r} forbids self-preemption: r is still running,
                # or the appended token would be left without its KV
                assert req.state == RUNNING, (r, req.state)
                tp = (leaf.length - 1) // ps
                copies.append((src_page, 0, leaf.page_ids[tp],
                               (leaf.length - 1) % ps))
            if copies:
                src_p, src_o, dst_p, dst_o = map(np.asarray, zip(*copies))
                self.pool.copy_slots(src_p, src_o, dst_p, dst_o)
                self.stats["spec_accepted"] += len(copies)
                if self.telemetry is not None:
                    self._note_token(req)
            req.computed_hwm = max(req.computed_hwm,
                                   self.forest.context_len(r))
            if len(req.generated) >= req.max_new:
                req.state = DONE
                req.pending = None
                out[r] = req.generated[-1]
            else:
                req.pending = final_tok
                out[r] = final_tok
        return out

    # ------------------------------------------------------------------ #
    def run(self, max_steps: int = 64) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        self.flush_tokens()
        self._stream_ready()
        self._notify_done()
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
        self._pending_ref.pop(rid, None)

    # ------------------------------------------------------------------ #
    # request lifecycle control and self-checks (``repro``'s DESIGN §12)
    # ------------------------------------------------------------------ #
    def cancel(self, rid: int) -> bool:
        """Cancel a request in any state before its end: its KV is
        released (a waiting request's pins unwound), its stream closed
        with ``on_done(rid, "cancelled")``, and tokens already delivered
        stand.  ``False`` when the request is unknown or already over."""
        req = self.requests.get(rid)
        if req is None or req.state in TERMINAL:
            return False
        if self._ranked:
            self._host_log = digest(self._host_log, "cancel", rid)
        self.flush_tokens()    # deliverable tokens land before closing
        self._finish(req, CANCELLED, "cancelled")
        return True

    def _finish(self, req: Request, state: str, reason: str) -> None:
        """The terminal transition of the failure states: unwinds the
        stage the request is in (waiting: queue entry and pins;
        prefilling or running: forest membership and deferred-token
        refs), releases its KV and closes the stream.  ``FAILED`` frees
        the private leaf even with the cache on."""
        if req.state in TERMINAL and req.kv_freed:
            return
        rid = req.rid
        if req.state == WAITING:
            self.admission.remove(rid)
            self._unpin(req)
        else:
            if rid in self._prefilling:
                self._prefilling.remove(rid)
            if rid in self.forest.leaf_of:
                self._release_kv(rid, force_leaf=state == FAILED)
            self._pending_ref.pop(rid, None)
            # the epoch's plan holds the departed row (and maybe its
            # freed pages): rebuild it
            self._plan_dirty = True
        req.pending = None
        req.kv_freed = True
        req.state = state
        req.finish_reason = reason
        self.stats[{CANCELLED: "cancelled", TIMED_OUT: "timed_out",
                    FAILED: "failed"}[state]] += 1
        self._fire_on_done(req)

    def _fail_request(self, rid: int, reason: str,
                      flush: bool = True) -> None:
        """Quarantine one request as ``FAILED`` without touching the rest
        of the batch."""
        req = self.requests.get(rid)
        if req is None or (req.state in TERMINAL and req.kv_freed):
            return
        if flush:
            self.flush_tokens()
        if reason == "nan_logits":
            # its draft tree goes first: the leaf is then its own again
            self._rollback_drafts(rid)
            # scrub injected NaN slots before their pages return to the
            # free list: a later tenant must never read them
            for page, off in self._nan_dirty:
                self.pool.fill_slot(page, off, 0.0)
            self._nan_dirty = []
            # the poisoned row kept decoding until its flag was read, so
            # its private leaf holds non-finite KV past the injected slot
            # too: a later tenant's dead slots there would turn the plain
            # tail attention NaN (0 x NaN; the CUDA epilogue never reads
            # them).  ``repro`` scrubs the injected slots only.
            leaf = self.forest.nodes.get(self.forest.leaf_of.get(rid))
            if leaf is not None and leaf.requests == [rid] \
                    and leaf.page_ids:
                self.pool.zero_pages(leaf.page_ids)
        self._finish(req, FAILED, reason)

    def _fire_on_done(self, req: Request) -> None:
        """Close the stream once; a raising callback is isolated."""
        if req.notified:
            return
        req.notified = True
        self.admission.remove(req.rid)   # drop the EDF bookkeeping
        tm = self.telemetry
        if tm is not None:
            reason = req.finish_reason or "done"
            tm.end_all(req.rid)
            tm.instant(reason, track=req.rid,
                       args={"tokens": len(req.generated)})
            tm.metrics.counter("tokens_generated").inc(len(req.generated))
            if reason == "done":
                tm.metrics.counter("requests_done").inc()
            if req.first_tok_t is not None:
                tm.observe("ttft_s", req.first_tok_t - req.submit_t)
                tm.observe("e2e_s",
                           (req.last_tok_t or req.first_tok_t)
                           - req.submit_t)
                if req.last_tok_t is not None and len(req.generated) > 1:
                    tm.observe("tpot_s",
                               (req.last_tok_t - req.first_tok_t)
                               / (len(req.generated) - 1))
        try:
            if self.injector is not None and req.on_done is not None:
                spec = self.injector.take("callback", rid=req.rid)
                if spec is not None:
                    self.stats["faults_injected"] += 1
                    raise InjectedFault(
                        spec, f"injected on_done failure for request "
                              f"{req.rid}")
            if req.on_done is not None:
                req.on_done(req.rid, req.finish_reason or "done")
        except Exception:
            self.stats["callback_errors"] += 1
            if req.state == DONE:
                # the only visible casualty is this request's status
                if req.rid in self.forest.leaf_of:
                    self._release_kv(req.rid)
                    self._plan_dirty = True
                req.kv_freed = True
                req.state = FAILED
                req.finish_reason = "callback_error"
                self.stats["failed"] += 1

    def _notify_done(self) -> None:
        """Fire ``on_done`` for requests that completed normally once
        their stream has drained (failure states notify in ``_finish``)."""
        for req in list(self.requests.values()):
            if req.state != DONE or req.notified:
                continue
            if req.on_token is not None and req.emitted < len(
                    req.generated):
                continue    # tokens still deferred: next sync point
            req.finish_reason = req.finish_reason or "done"
            self._fire_on_done(req)

    def _mesh_clock(self, now: float) -> float:
        """Rank 0's clock reading on every rank of a process mesh (one
        host broadcast): deadlines, queue timeouts and the EDF order are
        decided on it, so the ranks decide alike.  Telemetry spans stay
        on each rank's own clock (rank 0 alone exports them)."""
        return self.mesh.host_broadcast([now])[0]

    def _enforce_deadlines(self) -> None:
        """Step-boundary deadline sweep over every request not yet over
        (the waiting queue included): an expired one ends ``TIMED_OUT``
        with its KV released and its stream closed."""
        now = self.clock()
        if self._ranked:
            if not any(q.state not in TERMINAL and (
                    q.deadline is not None or q.queue_deadline is not None)
                    for q in self.requests.values()):
                return
            now = self._mesh_clock(now)
        for req in list(self.requests.values()):
            if req.state in TERMINAL:
                continue
            if req.deadline is not None and now >= req.deadline:
                self.flush_tokens()
                self._finish(req, TIMED_OUT, "deadline")
            elif (req.state == WAITING and req.queue_deadline is not None
                  and now >= req.queue_deadline):
                self._finish(req, TIMED_OUT, "queue_timeout")

    def check(self) -> None:
        """Serving-time invariant self-check; raises
        ``EngineInvariantError`` listing every violation.

        The allocator's structural check, plus: every allocated page is
        owned by exactly one forest node (replicas included), pin
        refcounts equal the waiting holders' pin lists, ``leaf_of``
        agrees with request states,
        deferred-token refs point at live requests, and cache residency
        fits the pool.  Runs after every dispatch recovery and every
        ``check_every`` steps."""
        self.stats["invariant_checks"] += 1
        failures: List[str] = []
        try:
            self.forest.validate()
        except AssertionError as e:
            failures.append(f"forest: {e}")
        try:
            self.pool.allocator.check()
        except AssertionError as e:
            failures.append(f"allocator: {e}")
        owned: Dict[int, int] = {}
        for node in self.forest.nodes.values():
            if node.id == tree_mod.ROOT_ID:
                continue
            reps = node.meta.get("replicas")
            pages = ([p for run in reps.values() for p in run]
                     if reps is not None else node.page_ids)
            for p in pages:
                owned[p] = owned.get(p, 0) + 1
        for p, n in owned.items():
            if n != 1:
                failures.append(f"page {p} owned by {n} nodes")
        used = self.pool.allocator.used_page_ids()
        leaked = sorted(set(used) - set(owned))
        dangling = sorted(set(owned) - set(used))
        if leaked:
            failures.append(
                f"{len(leaked)} leaked page(s) (allocated, owned by no "
                f"node): {leaked[:8]}")
        if dangling:
            failures.append(
                f"{len(dangling)} dangling page(s) (node-owned, not "
                f"allocated): {dangling[:8]}")
        pin_count: Dict[int, int] = {}
        for req in self.requests.values():
            for nid in req.pinned:
                pin_count[nid] = pin_count.get(nid, 0) + 1
        for node in self.forest.nodes.values():
            pins = node.meta.get("pins", 0)
            if pins != pin_count.get(node.id, 0):
                failures.append(
                    f"node {node.id} pins={pins} but "
                    f"{pin_count.get(node.id, 0)} holder(s) list it")
        for rid, req in self.requests.items():
            if (req.state in (PREFILL, RUNNING)
                    and rid not in self.forest.leaf_of):
                failures.append(f"live request {rid} has no forest leaf")
            if req.state == WAITING and rid in self.forest.leaf_of:
                failures.append(
                    f"waiting request {rid} still in the forest")
            if (req.state in TERMINAL and req.kv_freed
                    and rid in self.forest.leaf_of):
                failures.append(
                    f"finished request {rid} still holds forest KV")
        draft_virts = {v for st in self._drafts.values() for v in st.virts}
        for rid in self.forest.leaf_of:
            if rid >= 0 and rid not in self.requests:
                failures.append(
                    f"forest request {rid} unknown to the engine")
            if rid < 0 and rid not in draft_virts:
                failures.append(
                    f"virtual query {rid} without a draft tree")
        for rid in self._pending_ref:
            req = self.requests.get(rid)
            if req is None or req.pending is not PENDING_DEVICE:
                failures.append(
                    f"dangling deferred-token ref for request {rid}")
        if self.cache is not None:
            resident = self.cache.resident_pages()
            total_used = sum(used.values())
            if resident > total_used:
                failures.append(
                    f"cache claims {resident} resident pages but only "
                    f"{total_used} are allocated")
        if failures:
            raise EngineInvariantError(failures)

    def shutdown(self) -> Dict[str, int]:
        """Graceful teardown: cancel all outstanding work, drop finished
        and cached KV, self-check, and return a leak summary
        (``used_pages`` is 0 after a clean shutdown)."""
        for rid in sorted(self.requests):
            if self.requests[rid].state not in TERMINAL:
                self.cancel(rid)
        self.flush_tokens()
        self._stream_ready()
        self._notify_done()
        for rid, req in sorted(self.requests.items()):
            if rid in self.forest.leaf_of:    # done, KV still resident
                self._release_kv(rid)
                req.kv_freed = True
        if self.cache is not None:
            self._evict_cached(self.pool.num_pages)
        self.check()
        return {"used_pages": self.pool.allocator.num_used,
                "requests": len(self.requests)}
