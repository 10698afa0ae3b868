"""Cascade prefill: the port's ``DecodeEngine(cascade=True)`` against
``repro``'s on the same weights, and against its own sequential prefill.

``test_differential.py``'s burst workloads (a decoy head with its own
prompt, then requests sharing uncached documents, all arriving at step
0; page 8, one-page prefill chunks) run through ``repro``'s ``codec-xla``
engine with ``cascade=True`` and through the port's ``codec-cuda``
engine (its plain path on the CPU) with cascade on and off: streams,
the cascade counters, the other engine stats and the per-step records
(their non-timing keys) must equal ``repro``'s, the streams must equal
the port's sequential prefill, and no page or forest node may be left
after every request is released.  Seeds 0-2 eager, 0-1 fused and 0-1
with the prefix cache; ``test_differential.py``'s fixed workload on its
9-page pool, where a member is preempted mid cascade.  Then
``test_cascade.py``'s dense cases on the port alone (its two recurrent
cases are in ``test_torch_hybrid.py`` and ``test_torch_mamba2_engine.py``),
and the scheduler and forest pieces
cascade adds against ``repro``'s.

``repro`` runs once per record (cached in a module fixture): its engine
compiles each new shape, which takes almost all of this file's time.  Its
fused cascade record of a burst equals its eager one (streams, stats and
every step; ``test_differential.py`` holds both streams to sequential
prefill), so the port's fused runs are held to ``repro``'s eager record;
the cached burst 1 is held to it too, less the cache columns of each
step, and the cached burst 0 to ``repro``'s cached record whole.  Widths
are ``smoke_config("qwen3-4b")``.
"""

import jax
import numpy as np
import pytest

from repro.core import scheduler as jsched, tree as jtree
from repro.core.cost_model import CostModel as JCostModel
from repro.models import transformer as JT
from repro.serving import cache as jcache, engine as jengine
from repro_torch.configs import PAPER_ARCH, smoke_config
from repro_torch.core import scheduler, tree
from repro_torch.core.cost_model import CostModel
from repro_torch.models.transformer import Transformer
from repro_torch.serving import cache, engine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = smoke_config(PAPER_ARCH)
PAGE = 8

# test_differential.py's fixed pressure workload
DOC48 = list(range(10, 10 + 48))
FIXED = [(DOC48 + [100 + 3 * i + j for j in range(3)], 6, 0)
         for i in range(4)]
PRESSURE = dict(num_pages=9, prefill_chunk=8)

# test_cascade.py's shared document and decoy head
DOC = list(range(10, 10 + 3 * PAGE))
DECOY = list(range(120, 120 + 3 * PAGE)) + [99, 98]

# the per-step record compared step by step (the timing keys differ)
STEP_KEYS = ("step", "decoded", "admitted", "preempted", "reclaimed",
             "prefill_tokens", "recompute_tokens", "waiting", "prefilling",
             "running", "pages_free", "occupancy", "cache_hits",
             "cache_hit_rate", "cache_resident_pages",
             "cache_evicted_nodes")
STAT_KEYS = ("steps", "admitted", "preempted", "reclaimed",
             "prefill_tokens", "recompute_tokens", "prefill_chunks",
             "prefill_stalls", "cascade_groups", "cascade_shared_tokens",
             "cascade_suffix_tokens", "cascade_batches")


def make_burst_workload(seed):
    """Seeded burst: requests sharing uncached prefixes, all arriving at
    step 0.  A decoy head request (its own private doc) absorbs the
    initial chunked-prefill budget, so the shared doc is still uncached
    when the burst's head is admitted and cascade co-admission pulls its
    partners out of the queue (``test_differential.py``'s generator).
    """
    rng = np.random.default_rng(seed)
    decoy = rng.integers(0, CFG.vocab_size, 3 * PAGE).tolist()
    docs = [rng.integers(0, CFG.vocab_size,
                         int(rng.integers(3, 7)) * PAGE).tolist()
            for _ in range(int(rng.integers(1, 3)))]
    out = [(decoy + rng.integers(0, CFG.vocab_size, 2).tolist(), 4, 0)]
    for _ in range(int(rng.integers(3, 6))):
        doc = docs[int(rng.integers(0, len(docs)))]
        tail = rng.integers(0, CFG.vocab_size,
                            int(rng.integers(1, 5))).tolist()
        out.append((doc + tail, int(rng.integers(3, 7)), 0))
    return out


def drive(eng, workload, max_steps=96):
    """Run ``(prompt, max_new, arrival_step)`` to the end; returns the
    streams, stats and per-step records, then releases every request and
    checks that no page or forest node is left."""
    arrivals = {}
    for i, (_, _, arr) in enumerate(workload):
        arrivals.setdefault(arr, []).append(i)
    rid_of = {}
    for s in range(max_steps):
        for i in arrivals.pop(s, []):
            prompt, max_new, _ = workload[i]
            rid_of[i] = eng.add_request(prompt, max_new=max_new)
        if not arrivals and not eng.has_work():
            break
        eng.step()
    assert not arrivals and not eng.has_work(), "workload did not finish"
    rec = {
        "streams": {i: [int(t) for t in eng.requests[r].generated]
                    for i, r in rid_of.items()},
        "stats": {k: eng.stats[k] for k in STAT_KEYS},
        "trace": [tuple(st.get(k) for k in STEP_KEYS)
                  for st in eng.step_stats],
    }
    for i, (_, max_new, _) in enumerate(workload):
        assert len(rec["streams"][i]) == max_new, (i, rec["streams"][i])
    for r in list(eng.requests):
        eng.release(r)
    if eng.cache is not None:
        eng._evict_cached(eng.pool.num_pages)
    assert eng.pool.num_free == eng.pool.num_pages, "leaked pages"
    eng.pool.allocator.check()
    assert set(eng.forest.nodes) == {0}, "leaked forest nodes"
    return rec


def _kw(mode, **kw):
    out = dict(page_size=PAGE, num_pages=512, max_q=8, temperature=0.0,
               prefill_chunk=PAGE, fused=mode == "fused")
    out.update(kw)
    return out


# (mode, workload name) -> (workload, extra engine options)
CASES = {}
for _s in (0, 1, 2):
    CASES["eager", f"burst{_s}"] = (make_burst_workload(_s), {})
for _s in (0, 1):
    CASES["fused", f"burst{_s}"] = (make_burst_workload(_s), {})
    CASES["cached", f"burst{_s}"] = (make_burst_workload(_s),
                                     {"cache": True})
CASES["eager", "pressure"] = (FIXED, PRESSURE)
# the cases repro runs; the others are held to its eager record
REPRO_CASES = [k for k in CASES if k[0] == "eager"] + [("cached", "burst0")]
CACHE_COLS = [i for i, k in enumerate(STEP_KEYS) if k.startswith("cache")]


@pytest.fixture(scope="module")
def shared():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        CFG, from_jax_params(CFG, jax.tree.map(np.asarray, params)))
    return params, model


@pytest.fixture(scope="module")
def repro_run(shared):
    """``repro``'s ``codec-xla`` cascade record of a case, run once."""
    params, _ = shared
    runs = {}

    def get(mode, name):
        if (mode, name) not in runs:
            wl, extra = CASES[mode, name]
            extra = dict(extra)
            if extra.pop("cache", False):
                extra["cache"] = jcache.CachePolicy()
            eng = jengine.DecodeEngine(CFG, params, backend="codec-xla",
                                       cascade=True, **_kw(mode, **extra))
            runs[mode, name] = drive(eng, wl)
        return runs[mode, name]
    return get


def port_run(model, mode, name, cascade):
    wl, extra = CASES[mode, name]
    extra = dict(extra)
    if extra.pop("cache", False):
        extra["cache"] = cache.CachePolicy()
    eng = engine.DecodeEngine(CFG, model, backend="codec-cuda",
                              device="cpu", cascade=cascade,
                              **_kw(mode, **extra))
    assert eng.fused == (mode == "fused")
    return drive(eng, wl)


@pytest.mark.parametrize("mode,name", list(CASES),
                         ids=[f"{n}-{m}" for m, n in CASES])
def test_cascade_matches_repro_and_sequential(shared, repro_run, mode,
                                              name):
    _, model = shared
    got = port_run(model, mode, name, cascade=True)
    whole = (mode, name) in REPRO_CASES
    want = repro_run(*((mode, name) if whole else ("eager", name)))
    assert got["streams"] == want["streams"]
    assert got["stats"] == want["stats"]
    trace = got["trace"]
    if not whole:
        trace = [tuple(None if i in CACHE_COLS else v
                       for i, v in enumerate(row)) for row in trace]
    assert trace == want["trace"]
    seq = port_run(model, mode, name, cascade=False)
    assert got["streams"] == seq["streams"]
    st = got["stats"]
    assert st["cascade_groups"] >= 1, st
    if name == "pressure":
        assert st["preempted"] >= 1, st       # a member preempted
    else:
        assert st["cascade_shared_tokens"] > 0, st


def test_burst_batches_suffixes_into_one_dispatch(shared):
    """Burst over one uncached document: the group co-admits behind the
    decoy and its suffix chunks ride one padded forward."""
    _, model = shared
    wl = make_burst_workload(0)
    eng = engine.DecodeEngine(CFG, model, backend="codec-cuda",
                              device="cpu", cascade=True, **_kw("eager"))
    rec = drive(eng, wl)
    assert rec["stats"]["cascade_batches"] >= 1, rec["stats"]
    assert rec["stats"]["cascade_suffix_tokens"] >= 2, rec["stats"]


# --------------------------------------------------------------------- #
# test_cascade.py's dense cases, on the port
# --------------------------------------------------------------------- #
def _engine(model, **kw):
    out = dict(page_size=PAGE, num_pages=256, max_q=8, temperature=0.0)
    out.update(kw)
    return engine.DecodeEngine(CFG, model, backend="codec-cuda",
                               device="cpu", **out)


def _drive(eng, schedule, max_steps=96, release=True):
    """``test_cascade.py``'s ``_drive`` over ``(arrival_step, prompt,
    max_new)``; returns ``{schedule index: generated tokens}``."""
    wl = [(p, n, a) for a, p, n in schedule]
    if release:
        return drive(eng, wl, max_steps)["streams"]
    arrivals = {}
    for i, (arr, _, _) in enumerate(schedule):
        arrivals.setdefault(arr, []).append(i)
    rid_of = {}
    for s in range(max_steps):
        for i in arrivals.pop(s, []):
            _, prompt, max_new = schedule[i]
            rid_of[i] = eng.add_request(prompt, max_new=max_new)
        if not arrivals and not eng.has_work():
            break
        eng.step()
    assert not arrivals and not eng.has_work(), "schedule did not finish"
    return {i: list(eng.requests[r].generated) for i, r in rid_of.items()}


def _burst(doc=DOC, n=3, tail=2):
    """Decoy head + ``n`` requests sharing ``doc``, all arriving at 0."""
    sched = [(0, DECOY, 4)]
    sched += [(0, doc + [200 + 5 * i + j for j in range(tail)], 4)
              for i in range(n)]
    return sched


def test_chunk_boundary_mid_shared_node(shared):
    """prefill_chunk=4 < page_size=8: every shared-span chunk ends inside
    a node, so siblings resume from a mid-node boundary."""
    _, model = shared
    sched = _burst()
    seq = _drive(_engine(model, prefill_chunk=4), sched)
    eng = _engine(model, prefill_chunk=4, cascade=True)
    cas = _drive(eng, sched, release=False)
    assert cas == seq
    assert eng.stats["cascade_groups"] >= 1, eng.stats
    assert eng.stats["cascade_shared_tokens"] > 0, eng.stats


def test_on_split_mid_cascade(shared):
    """A request arriving mid prefill whose prompt diverges inside the
    shared document splits the node the cascade is filling; the pin
    bookkeeping (``on_split``) and the streams survive."""
    _, model = shared
    sched = _burst(doc=list(range(10, 10 + 4 * PAGE)))
    sched.append((2, list(range(10, 10 + 2 * PAGE)) + [210, 211], 4))
    seq = _drive(_engine(model, prefill_chunk=PAGE), sched)
    eng = _engine(model, prefill_chunk=PAGE, cascade=True)
    fired = []
    orig = eng.forest.on_split

    def spy(upper, lower):
        fired.append((upper.id, lower.id))
        orig(upper, lower)

    eng.forest.on_split = spy
    cas = _drive(eng, sched, release=False)
    assert fired, "expected a node split during the run"
    assert cas == seq
    eng.check()


def test_page_stall_one_member(shared):
    """One member's suffix chunks stall on pages for 3 chunks; its
    siblings keep cascading and every stream still matches."""
    _, model = shared
    sched = _burst()
    seq = _drive(_engine(model, prefill_chunk=PAGE), sched)
    eng = _engine(model, prefill_chunk=PAGE, cascade=True)
    rids = [eng.add_request(p, max_new=mn) for _, p, mn in sched]
    victim = rids[-1]
    orig = eng._ensure_pages_upto
    denied = {"n": 0}

    def flaky(rid, upto):
        if rid == victim and denied["n"] < 3:
            denied["n"] += 1
            return False
        return orig(rid, upto)

    eng._ensure_pages_upto = flaky
    for _ in range(96):
        if not eng.has_work():
            break
        eng.step()
    assert not eng.has_work()
    cas = {i: list(eng.requests[r].generated) for i, r in enumerate(rids)}
    assert cas == seq
    assert denied["n"] == 3
    assert eng.stats["prefill_stalls"] >= 3, eng.stats
    assert eng.stats["cascade_shared_tokens"] > 0, eng.stats


def test_preempt_member_mid_cascade(shared):
    """Undersized pool: a cascade member is preempted mid prefill and its
    recompute (through the cascade path again) reproduces the
    unconstrained sequential streams."""
    _, model = shared
    doc = list(range(10, 10 + 6 * PAGE))
    sched = [(0, doc + [200 + 3 * i + j for j in range(3)], 6)
             for i in range(4)]
    seq = _drive(_engine(model), sched)
    eng = _engine(model, num_pages=9, prefill_chunk=PAGE, cascade=True)
    cas = _drive(eng, sched, release=False)
    assert cas == seq
    assert eng.stats["preempted"] >= 1, eng.stats
    assert eng.stats["recompute_tokens"] >= 1, eng.stats


def test_sibling_allocation_preempts_a_batched_member(shared):
    """An 8-page pool: ensuring a later member's suffix pages in phase B
    preempts a member already in the batch (0 tokens generated, the
    latest such arrival with pages to give).  The port drops it from the
    batch and recomputes it later, and the streams equal sequential
    prefill; ``repro`` raises ``KeyError`` in its batch here (ROADMAP C),
    so this case has no ``repro`` record."""
    _, model = shared
    sched = [(0, DECOY, 6)] + [(0, DOC + [200 + 5 * i + j for j in range(3)],
                                6) for i in range(4)]
    seq = _drive(_engine(model, num_pages=8, prefill_chunk=PAGE), sched)
    eng = _engine(model, num_pages=8, prefill_chunk=PAGE, cascade=True)
    cas = _drive(eng, sched, release=False)
    assert cas == seq
    assert eng.stats["preempted"] >= 1 and eng.stats["cascade_batches"] >= 1
    eng.check()


def test_fully_cached_prompt_recomputes_one_token(shared):
    """A prompt whose KV is all cached recomputes exactly one token (the
    last, for its logits)."""
    _, model = shared
    eng = _engine(model, prefill_chunk=PAGE)
    prompt = list(range(10, 10 + 3 * PAGE))
    r0 = eng.add_request(prompt, max_new=4)
    first = eng.run(48)[r0]
    before = eng.stats["prefill_tokens"]
    r1 = eng.add_request(prompt, max_new=4)
    while eng.has_work():
        eng.step()
    assert eng.stats["prefill_tokens"] - before == 1, eng.stats
    assert list(eng.requests[r1].generated) == first


def test_prefill_stalls_counts_chunks(shared):
    _, model = shared
    sched = [(0, list(range(10, 10 + 3 * PAGE)), 3)]
    seq = _drive(_engine(model, prefill_chunk=PAGE), sched)
    eng = _engine(model, prefill_chunk=PAGE)
    orig = eng._ensure_pages_upto
    denied = {"n": 0}

    def flaky(rid, upto):
        if denied["n"] < 3:
            denied["n"] += 1
            return False
        return orig(rid, upto)

    eng._ensure_pages_upto = flaky
    cas = _drive(eng, sched, release=False)
    assert cas == seq
    assert eng.stats["prefill_stalls"] == 3, eng.stats


# --------------------------------------------------------------------- #
# the scheduler and forest pieces cascade adds, against repro's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("group", [1, 2, 8])
def test_cascade_policy_matches_repro(group):
    outcome = []
    for mod in (scheduler, jsched):
        try:
            p = mod.AdmissionPolicy(cascade=True, max_cascade_group=group)
            outcome.append((p.cascade, p.max_cascade_group))
        except ValueError as e:
            outcome.append(str(e))
    assert outcome[0] == outcome[1]


def test_cascade_partners_and_match_path_match_repro():
    """``match_path`` over a forest with splits, and ``cascade_partners``
    over a queue keyed by it, against ``repro``'s."""
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, 500, n * PAGE) for n in (2, 3, 4)]
    prompts = [np.concatenate([docs[i % 3][:PAGE * (1 + i % 3)],
                               rng.integers(0, 500, 3)])
               for i in range(9)]
    got = []
    for tmod, smod, cm in ((tree, scheduler, CostModel(4, 2, 16)),
                           (jtree, jsched, JCostModel(4, 2, 16))):
        f = tmod.PrefixForest(PAGE)
        for rid, p in enumerate(prompts[:4]):
            f.insert_tokens(rid, p.astype(np.int32))
        keys = {rid: f.match_path(p.astype(np.int32))
                for rid, p in enumerate(prompts)}
        ctl = smod.AdmissionController(
            smod.AdmissionPolicy(cascade=True), cm, PAGE)
        for rid in range(4, len(prompts)):
            ctl.push(rid)
        anchor = {n.id for n in f.path(0) if n.length}
        parts = [ctl.cascade_partners(
            anchor, lambda r: keys[r][0] if keys[r][1] >= PAGE else None,
            limit) for limit in (None, 1)]
        got.append((keys, parts))
    assert got[0] == got[1]
    assert any(got[0][1][0])
