"""The rank side of ``test_torch_process_mesh.py``: what each rank of a
process mesh runs, in a module that imports neither ``jax`` nor
``repro`` (ranks are spawned processes that import it by name).

The workload is ``test_torch_mesh_engine.py``'s (``repro``'s
``SHARDED_PARITY``), copied here because that file imports ``jax``; the
test holds the copies equal to the originals.  The weights arrive as the
``np.savez`` of ``repro``'s ``init_params`` (keys joined by ``/``) and go
through ``weights.from_jax_params``.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.cost_model import HardwareSpec
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.models.transformer import Transformer, build_model
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.weights import from_jax_params

CFG = smoke_config("qwen2.5-14b")
DOC = list(range(10, 58))                      # 6-page shared prefix
PROMPTS = [DOC + [100 + 3 * i + j for j in range(3)] for i in range(4)]
LATE = DOC + [250, 251]                        # arrives mid-decode
# the JAX package's TPU priors, as one explicit HardwareSpec
TPU_PRIORS = HardwareSpec(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
                          grid_step_overhead=1e-6, launch_overhead=5e-6)
ARCHS = (("gemma3-1b", 16), ("jamba-v0.1-52b", 8), ("mamba2-2.7b", 8))


def drive(eng):
    rids = [eng.add_request(p, max_new=6) for p in PROMPTS]
    eng.step()
    eng.step()
    rids.append(eng.add_request(LATE, max_new=4))
    eng.run(96)
    outs = {i: list(eng.requests[r].generated) for i, r in enumerate(rids)}
    assert all(len(outs[i]) == eng.requests[r].max_new
               for i, r in enumerate(rids)), "unfinished requests"
    return outs


def save_params(path, params) -> None:
    """``np.savez`` of a nested dict of arrays, keys joined by ``/``."""
    flat = {}

    def walk(tree, pre):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                flat[pre + k] = np.asarray(v)
    walk(params, "")
    np.savez(path, **flat)


def load_model(path) -> Transformer:
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = params
            *outer, leaf = key.split("/")
            for k in outer:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return Transformer.from_state_dict(CFG, from_jax_params(CFG, params))


# the engine options of each case (``test_torch_mesh_engine.run_mesh``'s)
CASES = {
    "greedy": {},
    "t0.7": {"temperature": 0.7},
    "rep-greedy": {"replicate": True},
    "rep-t0.7": {"replicate": True, "temperature": 0.7},
    "pressured": {"num_pages": 10, "prefill_chunk": 8},
    "rep-pressured": {"num_pages": 12, "prefill_chunk": 8,
                      "replicate": True},
    "calibrate": {"calibrate": True},
    "cache-cascade-telemetry": {"cache": True, "cascade": True,
                                "prefill_chunk": 16, "telemetry": True},
}


def run_case(model, mesh, case: str, device="cpu"):
    """One ``drive`` of the mesh engine under ``CASES[case]``: the
    streams, the counters, and (after releasing every request) the pages
    left on each shard and the pool's bytes."""
    kw = dict(CASES[case])
    num_pages = kw.pop("num_pages", 256)
    eng = DecodeEngine(CFG, model, page_size=8, num_pages=num_pages,
                       backend="codec-cuda", max_q=8, fused=True,
                       mesh=mesh, seq_split_pages=2, device=device, **kw)
    if kw.get("replicate"):
        eng.cost_model.hw = TPU_PRIORS
    n0 = mesh_mod.collectives
    outs = drive(eng)
    if eng.cache is not None:
        # a second wave, served from the cached document
        rid = eng.add_request(PROMPTS[0], max_new=3)
        eng.run(32)
        outs["again"] = list(eng.requests[rid].generated)
    out = {"streams": outs, "stats": dict(eng.stats),
           "collectives": mesh_mod.collectives - n0,
           "pool_bytes": eng.pool.bytes_used(),
           "cache_hits": eng.cache.stats["hits"] if eng.cache else 0,
           "graph": [s.get("graph") for s in eng.step_stats
                     if s["decoded"]]}
    if case == "calibrate":
        rows = [s for s in eng.step_stats if s.get("hbm_bytes")]
        for _ in range(12):          # enough measured steps for a fit
            eng.step_stats += rows
        out["fitted"] = eng.recalibrate()
        out["calibrations"] = eng.stats["calibrations"]
        out["hw"] = dataclasses.asdict(eng.cost_model.hw)
    eng.check()
    for r in list(eng.requests):
        eng.release(r)
    if eng.cache is not None:
        eng.shutdown()              # the cache's resident pages go too
    out["free"] = [s.num_free == s.num_pages
                   for s in eng.pool.allocator.shards]
    eng.pool.allocator.check()
    out["forest"] = sorted(eng.forest.nodes)
    return out


def arch_streams(arch: str, page: int, mesh, device="cpu"):
    """``test_torch_mesh_engine``'s ARCH_SWEEP run on ``mesh`` (None: one
    device, fused)."""
    cfg = smoke_config(arch)
    model = build_model(cfg, seed=0, device=device, dtype=torch.float32)
    doc = list(range(10, 10 + 64))
    eng = DecodeEngine(cfg, model, page_size=page, num_pages=64,
                       backend="codec-cuda", max_q=8, fused=True,
                       mesh=mesh, seq_split_pages=2 if mesh else 0,
                       device=device)
    for i in range(2):
        eng.add_request(doc + [100 + i, 101 + i], max_new=4)
    outs = eng.run(12)
    eng.pool.allocator.check()
    return outs


def special_values(shape, slot: int, dtype) -> torch.Tensor:
    """A slot's payload for the slot-gather check: NaN, -1e30, -0.0, inf
    and seeded values, different in every slot."""
    g = torch.Generator().manual_seed(slot)
    x = torch.randn(shape, generator=g).to(dtype).view(-1)
    x[:4] = torch.tensor([float("nan"), -1e30, -0.0, float("inf")],
                         dtype=dtype)
    return x.view(shape)


def check_slot_gather(mesh) -> bool:
    """Every axis, f32 and bf16: after the gather each slot holds its
    owner's bits exactly."""
    ok = True
    D, M = mesh.shape["data"], mesh.shape["model"]
    for axis, n in (("data", D), ("model", M), ("world", D * M)):
        for dtype in (torch.float32, torch.bfloat16):
            shape = (3, 6)
            buf = torch.zeros((n,) + shape, dtype=dtype)
            me = mesh.slot(axis)
            buf[me] = special_values(shape, mesh.rank, dtype)
            mesh.slot_gather(buf, axis)
            d, m = mesh.coords
            peers = {"data": [i * M + m for i in range(D)],
                     "model": [d * M + j for j in range(M)],
                     "world": list(range(D * M))}[axis]
            want = torch.stack([special_values(shape, r, dtype)
                                for r in peers])
            ok &= bool(torch.equal(buf.view(torch.uint8),
                                   want.view(torch.uint8)))
    return ok


# ---- deadlines and fault plans (ROADMAP C5) ------------------------ #
# Each workload takes ``make(**engine_kw)`` and, for the fault runs, a
# fault plan's text, which each package parses with its own
# ``FaultPlan.parse`` (so ``repro``'s mesh engine runs them too).
FAULT_PLANS = {
    # every kind once: an allocator refusal, two dispatch failures (the
    # recovery ladder), a stall, a raising on_token, a NaN KV slot
    "parsed": "alloc@0,dispatch@1*2,stall@2=0.001,callback@3:2,"
              "nan_logits@4:1",
    # FaultPlan.seeded(3, rate=0.25): every kind, rids left to the seams
    "seeded": "seed:3:0.25",
}
OUTCOME_STATS = ("steps", "admitted", "preempted", "reclaimed",
                 "cancelled", "timed_out", "failed", "callback_errors",
                 "faults_injected", "dispatch_failures",
                 "dispatch_recoveries", "nan_rows")
# what a step record shows of the decisions (not of timing)
OUTCOME_STEP = ("decoded", "admitted", "preempted", "timed_out", "failed",
                "waiting", "running", "pages_free")


class SkewClock:
    """A fake clock the driver advances one tick a step; it reads
    ``origin + rate * ticks``.  Each rank's has its own rate and origin
    (``rank_clock``), so ranks that acted on their own readings would
    time out and admit apart."""

    def __init__(self, rate: float = 1.0, origin: float = 0.0):
        self.rate, self.origin, self.ticks = rate, origin, 0

    def __call__(self) -> float:
        return self.origin + self.rate * self.ticks


def rank_clock(rank: int) -> SkewClock:
    """Rank ``rank``'s clock; rank 0's is the plain one that the single
    controller and ``repro`` are fed."""
    return SkewClock(1.0 + 0.37 * rank, 5.0 * rank)


class Recorder:
    """The streaming callbacks: tokens by request, and each close."""

    def __init__(self):
        self.tokens, self.closed = {}, []

    def on_token(self, rid, tok):
        self.tokens.setdefault(rid, []).append(int(tok))

    def on_done(self, rid, why):
        self.closed.append((rid, why))


def outcome(eng, rec, **extra):
    """What a user sees of ``eng`` (streams, terminal states, counters,
    each step's decisions, the callbacks), then every request released:
    the pages left free on each data shard."""
    eng.check()
    out = {"streams": {r: [int(t) for t in q.generated]
                       for r, q in eng.requests.items()},
           "states": {r: (str(q.state), q.finish_reason)
                      for r, q in eng.requests.items()},
           "stats": {k: int(eng.stats[k]) for k in OUTCOME_STATS},
           "trace": [tuple(float(s.get(k, 0)) for k in OUTCOME_STEP)
                     for s in eng.step_stats],
           "on_token": rec.tokens, "on_done": rec.closed, **extra}
    if eng.injector is not None:
        out["fired"] = dict(eng.injector.fired)
    for r in list(eng.requests):
        eng.release(r)
    out["free"] = [s.num_free == s.num_pages
                   for s in eng.pool.allocator.shards]
    eng.pool.allocator.check()
    return out


def wl_deadlines(make, clock):
    """Two running slots over five requests: one ends on its deadline
    mid-decode, one on its queue timeout, the rest in EDF order; the
    clock moves one tick a step."""
    rec = Recorder()
    eng = make(max_running=2, clock=clock)
    kw = dict(on_token=rec.on_token, on_done=rec.on_done)
    eng.add_request(PROMPTS[0], max_new=8, deadline_s=2.5, **kw)
    eng.add_request(PROMPTS[1], max_new=4, **kw)
    eng.add_request(PROMPTS[2], max_new=3, deadline_s=30.0, **kw)
    eng.add_request(PROMPTS[3], max_new=4, max_queue_s=1.5, **kw)
    queue = list(eng.admission.queue)
    for i in range(40):
        if i == 2:
            eng.add_request(LATE, max_new=4, deadline_s=9.0, **kw)
        if i > 2 and not eng.has_work():
            break
        eng.step()
        clock.ticks += 1
    return outcome(eng, rec, queue=queue)


def wl_faults(make, plan):
    """``drive``'s workload, streamed, under a fault plan."""
    rec = Recorder()
    eng = make(faults=plan)
    kw = dict(on_token=rec.on_token, on_done=rec.on_done)
    for p in PROMPTS:
        eng.add_request(p, max_new=6, **kw)
    eng.step()
    eng.step()
    eng.add_request(LATE, max_new=4, **kw)
    eng.run(96)
    return outcome(eng, rec)


def c5_runs(model, mesh, rank: int = 0, device="cpu"):
    """The deadline workload on ``rank``'s clock and every fault plan, on
    ``mesh`` (a process mesh, or a ``decode_mesh`` fed rank 0's
    clock)."""
    def make(**kw):
        return DecodeEngine(CFG, model, page_size=8, num_pages=256,
                            backend="codec-cuda", max_q=8, fused=True,
                            mesh=mesh, seq_split_pages=2, device=device,
                            **kw)
    out = {"deadlines": wl_deadlines(make, rank_clock(rank))}
    for name, text in FAULT_PLANS.items():
        out[name] = wl_faults(make, FaultPlan.parse(text))
    return out


def rank_main(mesh, npz: str, cases, archs: bool = False,
              c5: bool = False):
    """A rank's part of a spawn: ``cases`` of ``CASES`` on the qwen
    weights of ``npz``, then (``archs``) the ARCH_SWEEP models and
    (``c5``) the deadline and fault runs; its coordinates and the
    slot-gather check."""
    torch.set_num_threads(1)
    model = load_model(npz)
    out = {"coords": mesh.coords, "slot_gather_exact": check_slot_gather(mesh),
           "cases": {c: run_case(model, mesh, c) for c in cases}}
    if archs:
        out["archs"] = {a: arch_streams(a, page, mesh) for a, page in ARCHS}
    if c5:
        out["c5"] = c5_runs(model, mesh, mesh.rank)
    return out


def rank_refusals(mesh, npz: str):
    """A 1x1 rank: the options a process mesh refuses and those it takes
    (deadlines, queue timeouts, a fault plan: ``None``), a world of the
    wrong size, a mesh on another device than the engine's, and the
    default device."""
    torch.set_num_threads(1)
    model = load_model(npz)
    out = {}

    def refused(fn):
        try:
            fn()
        except (ValueError, RuntimeError) as e:
            return type(e).__name__
        return None

    def engine(**kw):
        return DecodeEngine(CFG, model, page_size=8, num_pages=64,
                            fused=True, device="cpu", **kw)
    out["wrong_world"] = refused(lambda: mesh_mod.process_mesh(2, 1,
                                                               device="cpu"))
    other = mesh_mod.process_mesh(1, 1, device="cuda:0")
    out["default_device"] = str(mesh_mod.process_mesh(1, 1).device)
    out["device_mismatch"] = refused(lambda: engine(mesh=other))
    eng = engine(mesh=mesh)
    out["deadline"] = refused(lambda: eng.add_request(PROMPTS[0],
                                                      deadline_s=5.0))
    out["max_queue"] = refused(lambda: eng.add_request(PROMPTS[0],
                                                       max_queue_s=5.0))
    out["faults"] = refused(lambda: engine(
        mesh=mesh, faults=FaultPlan.parse("alloc@1")).run(16))
    out["speculative"] = refused(lambda: engine(mesh=mesh,
                                                speculative=True))
    out["nan_guard"] = refused(lambda: engine(mesh=mesh, nan_guard=True))
    out["eager"] = refused(lambda: DecodeEngine(
        CFG, model, page_size=8, num_pages=64, mesh=mesh, device="cpu"))
    return out


def rank_diverge(mesh, npz: str, what: str = "request"):
    """A 2x1 spawn whose rank 1 is fed another late request (``what ==
    "request"``), a stall that rank 0's plan lacks (``"faults"``: only
    the injectors' counts differ) or a late request that reuses the
    document where rank 0's shares nothing (``"gather"``: rank 1 alone
    gathers the context in its prefill, a host collective that rank 0
    does not issue): every rank must raise ``MeshDivergenceError``
    (returned here by name)."""
    torch.set_num_threads(1)
    model = load_model(npz)
    plan = None
    if what == "faults":
        plan = FaultPlan.parse("stall@0=0.001" if mesh.rank else "")
    eng = DecodeEngine(CFG, model, page_size=8, num_pages=256,
                       backend="codec-cuda", max_q=8, fused=True,
                       mesh=mesh, seq_split_pages=2, device="cpu",
                       faults=plan)
    late = LATE
    if mesh.rank == 1 and what == "request":
        late = LATE[:-1] + [252]
    elif mesh.rank == 0 and what == "gather":
        late = [200 + i for i in range(len(LATE))]
    try:
        for p in PROMPTS:
            eng.add_request(p, max_new=6)
        eng.step()
        eng.step()
        eng.add_request(late, max_new=4)
        eng.run(96)
    except mesh_mod.MeshDivergenceError as e:
        return type(e).__name__, str(e)
    return None, None
