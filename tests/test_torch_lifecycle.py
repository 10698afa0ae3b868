"""The request lifecycle of the port's ``DecodeEngine`` against
``repro``'s on the same weights: the prefix cache and streaming
(``tests/test_serve_cache.py``'s workloads), cancel, deadlines, EDF
admission, fault plans, the NaN guard and ``check()``
(``tests/test_faults.py``'s, without a mesh or speculation), and sampling
at temperature > 0 (under memory pressure, and ``kv_exhausted``:
``tests/test_torch_pressure.py``, which shares ``repro``'s compiled shapes
for those workloads).

Each workload is one function that drives an engine through the calls a
user makes and returns what a user can see: every stream, the tokens each
``on_token`` callback got, each ``on_done`` reason, terminal states and
reasons, the cache and fault counters, a per-step record of
``step_stats`` and the outcome of ``check()`` and ``shutdown()``.  The
same function runs on ``repro``'s ``codec-xla`` engine and on the port's
``codec-cuda`` engine (its plain path on the CPU), eager and fused, and
the two records must be equal (fused against ``repro``'s fused engine
where streaming at sync points or a NaN read at a flush makes the paths
differ; elsewhere the port's fused record must equal its eager one).
``repro`` runs once per workload and path
(cached in a module fixture): its engine compiles every new shape, so it
takes most of this file's time.  Widths are ``smoke_config("qwen3-4b")``
(2 layers, d_model 64).
"""

import types

import jax
import numpy as np
import pytest

from repro.core import scheduler as jsched
from repro.core.cost_model import CostModel as JCostModel
from repro.models import transformer as JT
from repro.serving import cache as jcache, engine as jengine
from repro.serving import faults as jfaults
from repro_torch.configs import PAPER_ARCH, smoke_config
from repro_torch.core import scheduler
from repro_torch.core.cost_model import CostModel
from repro_torch.models.transformer import Transformer
from repro_torch.serving import cache, engine, faults
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = smoke_config(PAPER_ARCH)
DOC = list(range(100, 148))          # 48 tokens = 3 pages shared prefix

REPRO = types.SimpleNamespace(
    name="repro", CachePolicy=jcache.CachePolicy, FaultPlan=jfaults.FaultPlan,
    FaultSpec=jfaults.FaultSpec, KINDS=jfaults.KINDS,
    EngineInvariantError=jfaults.EngineInvariantError,
    ResourceExhausted=jfaults.ResourceExhausted)
PORT = types.SimpleNamespace(
    name="port", CachePolicy=cache.CachePolicy, FaultPlan=faults.FaultPlan,
    FaultSpec=faults.FaultSpec, KINDS=faults.KINDS,
    EngineInvariantError=faults.EngineInvariantError,
    ResourceExhausted=faults.ResourceExhausted)

# the per-step record compared step by step
STEP_KEYS = ("decoded", "admitted", "preempted", "reclaimed",
             "prefill_tokens", "recompute_tokens", "waiting", "prefilling",
             "running", "pages_free", "occupancy", "cancelled", "timed_out",
             "failed", "callback_errors", "faults_injected",
             "dispatch_failures", "dispatch_recoveries", "cache_hits",
             "cache_hit_rate", "cache_resident_pages",
             "cache_resident_bytes", "cache_evicted_nodes")
STAT_KEYS = ("steps", "admitted", "preempted", "reclaimed",
             "prefill_tokens", "recompute_tokens", "prefill_chunks",
             "cancelled", "timed_out", "failed", "callback_errors",
             "faults_injected", "dispatch_failures", "dispatch_recoveries",
             "nan_rows", "invariant_checks")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Recorder:
    """The streaming callbacks: tokens by request, and each close."""

    def __init__(self):
        self.tokens, self.closed = {}, []

    def on_token(self, rid, tok):
        self.tokens.setdefault(rid, []).append(int(tok))

    def on_done(self, rid, why):
        self.closed.append((rid, why))


def observe(eng, rec=None, **extra):
    """What a user can see of ``eng``, in a form both packages share."""
    out = {
        "streams": {r: [int(t) for t in q.generated]
                    for r, q in eng.requests.items()},
        "states": {r: (q.state, q.finish_reason)
                   for r, q in eng.requests.items()},
        "stats": {k: eng.stats[k] for k in STAT_KEYS},
        "trace": [tuple(st.get(k) for k in STEP_KEYS)
                  for st in eng.step_stats],
        **extra,
    }
    if eng.cache is not None:
        out["cache"] = dict(eng.cache.stats)
        out["cache_resident"] = eng.cache.resident_pages()
    if rec is not None:
        out["on_token"] = rec.tokens
        out["on_done"] = rec.closed
    return out


def _finish(eng, rec=None, **extra):
    """Observe, then check and shut down (nothing may leak)."""
    eng.check()
    obs = observe(eng, rec, **extra)
    obs["shutdown"] = eng.shutdown()
    eng.pool.allocator.check()
    return obs


def _wave(i, n=3):
    return [DOC + [200 + 10 * i + k, 250 + k] for k in range(n)]


def _fprompts(n=3):
    """``test_faults.py``'s prompts, on ``_wave``'s document and prompt
    length (so ``repro`` compiles fewer shapes)."""
    return [DOC + [10 + 5 * i + j for j in range(2)] for i in range(n)]


# --------------------------------------------------------------------- #
# workloads: each takes (make, pkg) and returns an observation
# --------------------------------------------------------------------- #
def wl_two_waves(make, pkg):
    """A second wave over the same document hits the first's cache."""
    rec = Recorder()
    eng = make(cache=True)
    for p in _wave(0):
        eng.add_request(p, max_new=4, on_token=rec.on_token,
                        on_done=rec.on_done)
    eng.run(32)
    prefill_w1 = eng.stats["prefill_tokens"]
    resident_w1 = eng.cache.resident_pages()
    match = eng.forest.match_len(np.asarray(_wave(1)[0], np.int32))
    for p in _wave(1):
        eng.add_request(p, max_new=4, on_token=rec.on_token,
                        on_done=rec.on_done)
    eng.run(32)
    return _finish(eng, rec, prefill_w1=prefill_w1, resident_w1=resident_w1,
                   match=match)


def wl_release_after_detach(make, pkg):
    eng = make(cache=True)
    r = eng.add_request(DOC + [1, 2], max_new=2)
    eng.run(8)
    eng.release(r)
    return _finish(eng, match=eng.forest.match_len(
        np.asarray(DOC, np.int32)))


def wl_ttl(make, pkg):
    eng = make(cache=pkg.CachePolicy(ttl_steps=3))
    for p in _wave(0, n=2):
        eng.add_request(p, max_new=3)
    eng.run(32)
    resident = eng.cache.resident_pages()
    for _ in range(12):              # idle: the clock ticks past the TTL
        eng.step()
    return _finish(eng, resident=resident, free=eng.pool.num_free)


def wl_lru_cap(make, pkg):
    doc_a, doc_b = list(range(100, 164)), list(range(0, 64))
    eng = make(cache=pkg.CachePolicy(max_pages=5))
    eng.add_request(doc_a + [1, 2], max_new=2)
    eng.run(16)
    eng.add_request(doc_b + [3, 4], max_new=2)
    eng.run(16)
    return _finish(eng, match=[eng.forest.match_len(np.asarray(d, np.int32))
                               for d in (doc_a, doc_b)])


def wl_cache_pressure(make, pkg):
    """Cached pages are the first reclaim tier: nothing is preempted."""
    eng = make(cache=True, num_pages=12)
    eng.add_request(list(range(100, 164)) + [1, 2], max_new=2)
    eng.run(16)
    eng.add_request(list(range(0, 48)), max_new=4)
    eng.add_request(list(range(192, 240)), max_new=4)
    eng.run(32)
    return _finish(eng)


def wl_streaming(make, pkg):
    rec = Recorder()
    eng = make(cache=True)
    for p in _wave(0, n=2):
        eng.add_request(p, max_new=5, on_token=rec.on_token,
                        on_done=rec.on_done)
    eng.run(32)
    return _finish(eng, rec)


def wl_cancel(make, pkg):
    rec = Recorder()
    eng = make()
    rids = [eng.add_request(p, max_new=6, on_done=rec.on_done)
            for p in _fprompts(2)]
    eng.step()
    eng.step()
    calls = [eng.cancel(rids[0]), eng.cancel(rids[0]), eng.cancel(999)]
    eng.run(16)
    return _finish(eng, rec, calls=calls)


def wl_cancel_waiting(make, pkg):
    eng = make(max_running=1, clock=FakeClock())
    r0, r1 = (eng.add_request(p, max_new=4) for p in _fprompts(2))
    eng.step()
    waiting = eng.requests[r1].state
    calls = [eng.cancel(r1), r1 in eng.admission.queue]
    eng.run(16)
    return _finish(eng, waiting=waiting, calls=calls)


def wl_deadline(make, pkg):
    clock, rec = FakeClock(), Recorder()
    eng = make(clock=clock)
    eng.add_request(_fprompts(2)[0], max_new=8, deadline_s=2.5,
                    on_done=rec.on_done)
    eng.add_request(_fprompts(2)[1], max_new=4, on_done=rec.on_done)
    for _ in range(8):
        eng.step()
        clock.t += 1.0
    return _finish(eng, rec)


def wl_queue_timeout(make, pkg):
    clock = FakeClock()
    eng = make(max_running=1, clock=clock)
    eng.add_request(_fprompts(2)[0], max_new=8)
    eng.add_request(_fprompts(2)[1], max_new=4, max_queue_s=1.5)
    for _ in range(4):
        eng.step()
        clock.t += 1.0
    eng.run(16)
    return _finish(eng)


def wl_edf(make, pkg):
    """EDF admission: with one running slot the earliest deadline goes
    next, deadline-less requests last, a preempted request first."""
    clock, rec = FakeClock(), Recorder()
    eng = make(max_running=1, clock=clock)
    order = []
    for i, dl in enumerate((None, 30.0, 9.0, None, 20.0)):
        eng.add_request(DOC + [60 + i, 7], max_new=2, deadline_s=dl,
                        on_done=lambda r, why: order.append(r))
    queue = list(eng.admission.queue)
    eng.run(40)
    return _finish(eng, rec, queue=queue, order=order)


def wl_raising_on_token(make, pkg):
    rec = Recorder()

    def bad(rid, tok):
        raise RuntimeError("user bug")

    eng = make()
    for i, p in enumerate(_fprompts(3)):
        eng.add_request(p, max_new=4,
                        on_token=bad if i == 1 else rec.on_token,
                        on_done=rec.on_done)
    eng.run(16)
    return _finish(eng, rec)


def wl_raising_on_done(make, pkg):
    def bad_done(rid, why):
        raise RuntimeError("user bug in close")

    eng = make()
    eng.add_request(_fprompts(2)[0], max_new=3, on_done=bad_done)
    eng.add_request(_fprompts(2)[1], max_new=3)
    eng.run(16)
    return _finish(eng)


def wl_alloc_dispatch_faults(make, pkg):
    plan = pkg.FaultPlan([pkg.FaultSpec("alloc", 0),
                          pkg.FaultSpec("dispatch", 1, times=2),
                          pkg.FaultSpec("stall", 2, payload=0.001)])
    eng = make(faults=plan)
    for p in _fprompts(3):
        eng.add_request(p, max_new=4)
    eng.run(24)
    return _finish(eng, pending=eng.injector.pending(),
                   fired=eng.injector.fired)


def wl_ladder_exhaustion(make, pkg):
    plan = pkg.FaultPlan([pkg.FaultSpec("dispatch", 0, times=99)])
    eng = make(faults=plan, max_dispatch_retries=2)
    eng.add_request(_fprompts(1)[0], max_new=4)
    with pytest.raises(pkg.ResourceExhausted):
        eng.run(8)
    return _finish(eng)


def wl_nan(make, pkg):
    plan = pkg.FaultPlan([pkg.FaultSpec("nan_logits", 2, rid=1)])
    rec = Recorder()
    eng = make(nan_guard=True, faults=plan)
    for p in _fprompts(3):
        eng.add_request(p, max_new=4, on_token=rec.on_token,
                        on_done=rec.on_done)
    eng.run(24)
    return _finish(eng, rec)


def wl_check(make, pkg):
    """``check()`` passes live and lists planted corruption."""
    eng = make()
    rid = eng.add_request(_fprompts(1)[0], max_new=4)
    eng.step()
    eng.step()
    eng.check()
    found = []
    leaf = eng.forest.nodes[eng.forest.leaf_of[rid]]
    free_page = max(set(range(eng.pool.num_pages))
                    - set(eng.pool.allocator.used_page_ids()))
    leaf.page_ids.append(free_page)
    with pytest.raises(pkg.EngineInvariantError) as ei:
        eng.check()
    found.append(ei.value.failures)
    leaf.page_ids.pop()
    eng.check()
    eng.requests[rid].pinned.append(leaf.id)
    with pytest.raises(pkg.EngineInvariantError) as ei:
        eng.check()
    found.append(ei.value.failures)
    eng.requests[rid].pinned.pop()
    return _finish(eng, found=found)


def wl_check_every(make, pkg):
    eng = make(check_every=2)
    eng.add_request(_fprompts(1)[0], max_new=6)
    eng.run(16)
    return _finish(eng)


def wl_chaos(make, pkg, cached=False):
    """``test_faults.py``'s seeded chaos mix: every request ends, the
    survivors' streams stand, nothing leaks."""
    kinds = tuple(k for k in pkg.KINDS if k != "alloc")
    specs = list(pkg.FaultPlan.seeded(11, steps=6, rate=0.2,
                                      kinds=kinds).specs)
    specs += [pkg.FaultSpec("dispatch", 1), pkg.FaultSpec("nan_logits", 3),
              pkg.FaultSpec("alloc", 0)]
    clock, rec = FakeClock(), Recorder()
    eng = make(faults=pkg.FaultPlan(specs), nan_guard=True, check_every=3,
               clock=clock, cache=pkg.CachePolicy() if cached else None)
    rids = [eng.add_request(p, max_new=4, on_token=rec.on_token,
                            on_done=rec.on_done,
                            deadline_s=2.5 if i == 2 else None)
            for i, p in enumerate(_fprompts(3))]
    eng.cancel(rids[0])
    for _ in range(40):
        if not eng.has_work():
            break
        eng.step()
        clock.t += 1.0
    return _finish(eng, rec, fired=eng.injector.fired)


def wl_sampled(make, pkg):
    """Temperature 0.8: arrivals mid-decode, a shared document."""
    eng = make(temperature=0.8, seed=7)
    for p in _fprompts(3):
        eng.add_request(p, max_new=6)
    eng.step()
    eng.step()
    eng.add_request(DOC + [7, 8], max_new=5)
    eng.run(32)
    return _finish(eng)


WORKLOADS = {
    "two_waves": wl_two_waves,
    "release_after_detach": wl_release_after_detach,
    "ttl": wl_ttl,
    "lru_cap": wl_lru_cap,
    "cache_pressure": wl_cache_pressure,
    "streaming": wl_streaming,
    "cancel": wl_cancel,
    "cancel_waiting": wl_cancel_waiting,
    "deadline": wl_deadline,
    "queue_timeout": wl_queue_timeout,
    "edf": wl_edf,
    "raising_on_token": wl_raising_on_token,
    "raising_on_done": wl_raising_on_done,
    "alloc_dispatch_faults": wl_alloc_dispatch_faults,
    "ladder_exhaustion": wl_ladder_exhaustion,
    "nan": wl_nan,
    "check": wl_check,
    "check_every": wl_check_every,
    "chaos": wl_chaos,
    "chaos_cached": lambda make, pkg: wl_chaos(make, pkg, cached=True),
    "sampled": wl_sampled,
}
# the workloads whose fused runs differ from their eager ones (streams at
# sync points, NaN detection at flushes, the key split inside the step)
FUSED = ("two_waves", "streaming", "raising_on_token", "nan", "chaos",
         "alloc_dispatch_faults", "deadline", "sampled")
CASES = [(n, False) for n in WORKLOADS] + [(n, True) for n in FUSED]


@pytest.fixture(scope="module")
def shared():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        CFG, from_jax_params(CFG, jax.tree.map(np.asarray, params)))
    return params, model


def _kw(kw):
    out = dict(page_size=16, num_pages=128, max_q=8, temperature=0.0)
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def repro_run(shared):
    """``repro``'s ``codec-xla`` record of a workload, run once."""
    params, _ = shared
    runs = {}

    def get(name, fused):
        if (name, fused) not in runs:
            def make(**kw):
                return jengine.DecodeEngine(CFG, params, backend="codec-xla",
                                            fused=fused, **_kw(kw))
            runs[name, fused] = WORKLOADS[name](make, REPRO)
        return runs[name, fused]
    return get


@pytest.mark.parametrize("name,fused", CASES,
                         ids=[f"{n}-{'fused' if f else 'eager'}"
                              for n, f in CASES])
def test_lifecycle_matches_repro(shared, repro_run, name, fused):
    _, model = shared

    def make(**kw):
        eng = engine.DecodeEngine(CFG, model, backend="codec-cuda",
                                  fused=fused, device="cpu", **_kw(kw))
        assert eng.fused == fused
        return eng

    got = WORKLOADS[name](make, PORT)
    want = repro_run(name, fused)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert got["shutdown"]["used_pages"] == 0


# the other workloads' fused records equal their eager ones (``check``
# looks mid-flight, where fused tokens are still placeholders), which
# equal ``repro``'s above: the port's fused path is held to them here
PATH_FREE = [n for n in WORKLOADS if n not in FUSED and n != "check"]


@pytest.mark.parametrize("name", PATH_FREE)
def test_fused_record_equals_eager(shared, name):
    _, model = shared
    recs = []
    for fused in (False, True):
        def make(**kw):
            return engine.DecodeEngine(CFG, model, backend="codec-cuda",
                                       fused=fused, device="cpu",
                                       **_kw(kw))
        recs.append(WORKLOADS[name](make, PORT))
    assert recs[0] == recs[1]


def test_workloads_reach_their_paths(repro_run):
    """The records show each workload really took its path."""
    w = repro_run("two_waves", False)
    assert w["cache"]["hits"] >= 3 and w["match"] >= len(DOC)
    assert w["stats"]["prefill_tokens"] - w["prefill_w1"] == 3 * 2
    assert w["on_token"] == w["streams"]
    assert repro_run("ttl", False)["cache_resident"] == 0
    assert repro_run("cache_pressure", False)["stats"]["preempted"] == 0
    assert repro_run("cancel", False)["states"][0] == ("cancelled",
                                                       "cancelled")
    assert repro_run("deadline", False)["states"][0] == ("timed_out",
                                                         "deadline")
    assert repro_run("queue_timeout", False)["states"][1] == (
        "timed_out", "queue_timeout")
    for fused in (False, True):
        assert repro_run("nan", fused)["states"][1] == ("failed",
                                                        "nan_logits")
        assert repro_run("raising_on_token", fused)["states"][1] == (
            "failed", "callback_error")
    assert repro_run("alloc_dispatch_faults", False)["stats"][
        "dispatch_recoveries"] == 2


def test_sampled_streams_differ_from_greedy(shared):
    """Temperature 0.8 really samples: the streams are not the argmax."""
    _, model = shared
    got = {}
    for t in (0.0, 0.8):
        eng = engine.DecodeEngine(CFG, model, device="cpu",
                                  **_kw({"temperature": t}))
        for p in _fprompts(3):
            eng.add_request(p, max_new=6)
        got[t] = eng.run(16)
    assert got[0.0] != got[0.8]


def test_edf_queue_matches_repro():
    """``AdmissionController.push`` with deadlines, against ``repro``'s."""
    queues = []
    for sched, cm in ((scheduler, CostModel), (jsched, JCostModel)):
        ac = sched.AdmissionController(
            sched.AdmissionPolicy(),
            cm(CFG.num_heads, CFG.num_kv_heads, CFG.head_dim,
               page_size=16), 16)
        ac.push(0)
        ac.push(1, deadline=9.0)
        ac.push(2, deadline=3.0)
        ac.push(3, deadline=9.0)
        ac.requeue(7)                   # preempted: the front, always
        seen = [list(ac.queue)]
        ac.remove(1)
        ac.remove(1)
        seen += [list(ac.queue), ac.pop(), ac.pop(), list(ac.queue)]
        queues.append(seen)
    assert queues[0] == queues[1] == [[7, 2, 1, 3, 0], [7, 2, 3, 0], 7, 2,
                                      [3, 0]]


def test_fault_plan_and_injector_match_repro():
    for text in ("dispatch@3*2, nan_logits@5:1, stall@8=0.01",
                 "seed:7:0.5", "alloc@0,callback@2:1*3", ""):
        assert [tuple(vars(s).values()) for s in
                faults.FaultPlan.parse(text)] == \
            [tuple(vars(s).values()) for s in jfaults.FaultPlan.parse(text)]
    for bad in ("dispatch3", "frobnicate@1"):
        with pytest.raises(ValueError):
            faults.FaultPlan.parse(bad)
    seen = []
    for mod in (faults, jfaults):
        inj = mod.FaultInjector(mod.FaultPlan([
            mod.FaultSpec("dispatch", 2, times=2),
            mod.FaultSpec("nan_logits", 1, rid=5)]))
        out = [inj.take("dispatch")]
        inj.tick(2)
        out += [inj.take("dispatch"), inj.take("dispatch"),
                inj.take("dispatch"), inj.take("nan_logits", rid=3)]
        spec = inj.take("nan_logits", rid=5)
        inj.requeue(spec)
        out += [inj.pending(), inj.take("nan_logits", rid=5), inj.pending(),
                inj.total_fired, dict(inj.fired)]
        seen.append([(x.kind, x.step, x.rid) if hasattr(x, "kind") else x
                     for x in out])
    assert seen[0] == seen[1]


def test_add_request_rejects_malformed(shared):
    _, model = shared
    eng = engine.DecodeEngine(CFG, model, device="cpu", **_kw({}))
    for args, kw in (([], {}), ([1, 2], {"max_new": 0}),
                     ([1, CFG.vocab_size], {}), ([1, -3], {}),
                     ([1.5, 2.5], {}), ([1, 2], {"deadline_s": -1.0}),
                     ([1, 2], {"max_queue_s": 0.0})):
        with pytest.raises(ValueError):
            eng.add_request(args, **{"max_new": 4, **kw})
    assert not eng.requests
    assert eng.pool.num_free == eng.pool.num_pages


def test_split_carries_touch_to_the_lower_half_like_repro():
    """A cached node that a later insert splits keeps its LRU stamp on
    both halves, in the port's forest as in ``repro``'s, and the cache
    orders them the same."""
    from repro.core import tree as jtree
    from repro_torch.core import tree
    seen = {}
    for name, mod, cmod in (("port", tree, cache), ("repro", jtree, jcache)):
        f = mod.PrefixForest(4)
        f.insert_tokens(0, np.arange(16, dtype=np.int32))
        pc = cmod.PrefixCache(f)
        node = f.nodes[f.leaf_of[0]]
        node.page_ids = [0, 1, 2, 3]
        pc.tick()
        pc.stamp(node)
        f.detach_request(0)
        pc.tick()
        f.insert_tokens(1, np.array([0, 1, 2, 3, 4, 5, 6, 7, 90], np.int32))
        f.validate()
        seen[name] = sorted((n.length, n.meta.get("touch"))
                            for n in f.real_nodes())
        seen[name + " lru"] = [(n.length, n.meta.get("touch"))
                               for n in pc.candidates()]
    assert seen["port"] == seen["repro"]
    assert seen["port lru"] == seen["repro lru"]
    assert (8, 1) in seen["port"] and seen["port"].count((8, 1)) == 2
