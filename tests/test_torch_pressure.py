"""Serving under memory pressure: the port's ``DecodeEngine`` against
``repro``'s on the same weights and the same undersized pools.

Three workloads: ``test_differential.py``'s fixed pressure workload (a
48-token document shared by four requests, page 8, a 9-page pool, an
8-token prefill chunk, 6 tokens each) and two seeded doc-QA mixes of its
``make_workload`` (arrivals at steps 0-2), each on a pool of its need + 2
pages, where the need is the pages its largest request holds when it
finishes alone.  The seeds are ones whose pool forces a preemption (most
mixes of four or five requests fit in their need + 2).  Every port
backend, eager and fused (``ref`` eager), must give greedy streams
byte-identical to ``repro``'s ``codec-xla`` under the same pressure and
to its own unconstrained run, the same per-step admission and preemption
trace as ``repro``, really preempt, chunk and recompute, fill the pool,
and leak no page or node.  Seed 16's mix runs once more with a running
cap of two, a one-page watermark and ``"auto"`` chunks from a stub cost
model both engines share.  ``repro`` runs once per workload (cached in a
module fixture): its engine compiles each new prefill and plan shape, so
it takes most of this file's time.
"""

import types

import jax
import numpy as np
import pytest
import torch

from benchmarks import serve_replay
from repro.core import scheduler as jsched, tree as jtree
from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.configs import PAPER_ARCH, smoke_config
from repro_torch.core import scheduler, tree
from repro_torch.launch.serve import build_schedule, serve
from repro_torch.models.transformer import Transformer, build_model
from repro_torch.serving.engine import DecodeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = smoke_config(PAPER_ARCH)
PAGE = 8
CHUNK = 8
DOC = list(range(10, 10 + 48))
FIXED = [(DOC + [100 + 3 * i + j for j in range(3)], 6, 0) for i in range(4)]


def make_workload(seed):
    """Seeded random doc-QA workload: (prompt, max_new, arrival_step)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, CFG.vocab_size,
                         int(rng.integers(2, 7)) * PAGE).tolist()
            for _ in range(int(rng.integers(1, 3)))]
    out = []
    for _ in range(int(rng.integers(3, 6))):
        doc = docs[int(rng.integers(0, len(docs)))]
        tail = rng.integers(0, CFG.vocab_size,
                            int(rng.integers(1, 5))).tolist()
        out.append((doc + tail, int(rng.integers(3, 7)),
                    int(rng.integers(0, 3))))
    return out


def need_pages(workload):
    """Pages the workload's largest request holds when it finishes."""
    return max(-(-(len(p) + n) // PAGE) for p, n, _ in workload)


WORKLOADS = {"fixed": (FIXED, 9)}
for _seed in (3, 16):
    _wl = make_workload(_seed)
    WORKLOADS[f"mix{_seed}"] = (_wl, need_pages(_wl) + 2)

# the per-step record both engines keep, compared step by step
TRACE = ("admitted", "preempted", "reclaimed", "prefill_tokens",
         "recompute_tokens", "waiting", "running", "pages_free")


def drive(eng, workload, max_steps=64):
    """Run ``workload`` (arrivals by step) to the end; returns the streams
    by request index, the step trace, the stats and the pool's peak pages
    in use and pages handed out, after checking that releasing every
    request frees every page and node."""
    arrivals = {}
    for i, (_, _, step) in enumerate(workload):
        arrivals.setdefault(step, []).append(i)
    rid_of = {}
    for s in range(max_steps):
        for i in arrivals.pop(s, []):
            prompt, max_new, _ = workload[i]
            rid_of[i] = eng.add_request(prompt, max_new=max_new)
        if not arrivals and not eng.has_work():
            break
        eng.step()
    assert not arrivals and not eng.has_work(), "workload did not finish"
    outs = {i: list(eng.requests[rid_of[i]].generated)
            for i in range(len(workload))}
    for i, (_, max_new, _) in enumerate(workload):
        assert len(outs[i]) == max_new, (i, outs[i])
    trace = [tuple(st[k] for k in TRACE) for st in eng.step_stats]
    alloc = eng.pool.allocator
    stats, peak = dict(eng.stats), (alloc.peak_used, alloc.total_allocs)
    for r in list(eng.requests):
        eng.release(r)
    assert eng.pool.num_free == eng.pool.num_pages, "leaked pages"
    eng.pool.allocator.check()
    assert set(eng.forest.nodes) == {0}, "leaked forest nodes"
    return outs, trace, stats, peak


@pytest.fixture(scope="module")
def shared():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        CFG, from_jax_params(CFG, jax.tree.map(np.asarray, params)))
    return params, model


@pytest.fixture(scope="module")
def repro_run(shared):
    """``repro``'s pressured ``codec-xla`` run of a workload, run once."""
    params, _ = shared
    runs = {}

    def get(name):
        if name not in runs:
            workload, pages = WORKLOADS[name]
            runs[name] = drive(JaxEngine(
                CFG, params, backend="codec-xla", page_size=PAGE,
                num_pages=pages, max_q=8, temperature=0.0,
                prefill_chunk=CHUNK), workload)
        return runs[name]
    return get


def _engine(model, backend, fused, num_pages, prefill_chunk=CHUNK):
    return DecodeEngine(CFG, model, backend=backend, fused=fused,
                        page_size=PAGE, num_pages=num_pages, max_q=8,
                        prefill_chunk=prefill_chunk, device="cpu")


RUNS = [(b, False) for b in ("codec-cuda", "codec-torch", "flash",
                             "hydragen", "ref")] \
    + [(b, True) for b in ("codec-cuda", "codec-torch", "flash",
                           "hydragen")]


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("backend,fused", RUNS,
                         ids=[f"{b}-{'fused' if f else 'eager'}"
                              for b, f in RUNS])
def test_pressure_streams_and_trace_match_repro(shared, repro_run, workload,
                                                backend, fused):
    _, model = shared
    wl, pages = WORKLOADS[workload]
    want, want_trace, _, want_peak = repro_run(workload)
    eng = _engine(model, backend, fused, pages)
    assert eng.fused == fused
    got, trace, stats, peak = drive(eng, wl)
    assert got == want
    free, _, free_stats, _ = drive(
        _engine(model, backend, fused, 512, prefill_chunk=None), wl)
    assert got == free and free_stats["preempted"] == 0
    # the same scheduling decisions, step by step, not only the tokens
    assert trace == want_trace
    assert stats["preempted"] >= 1, stats
    assert stats["prefill_chunks"] >= 1, stats
    assert stats["recompute_tokens"] >= 1, stats
    assert peak == want_peak and peak[0] == pages
    if fused:
        assert eng.fused_step.replays == stats["steps"]
        assert stats["nonfinite_rows"] == 0


# the running cap, the watermark and cost-model chunks: seed 16's mix on a
# pool of its need + 3 pages (on need + 2 the cost model's budget never
# cuts a prompt), at most two admitted requests, one page held back and
# "auto" prefill chunks from a cost model both engines share
CAPPED = dict(prefill_chunk="auto", reserve_pages=1, max_running=2)
CAPPED_PAGES = need_pages(WORKLOADS["mix16"][0]) + 3
CAPPED_RUNS = [("codec-cuda", False), ("codec-cuda", True), ("ref", False)]


@pytest.fixture(scope="module")
def repro_capped(shared):
    params, _ = shared
    wl, _ = WORKLOADS["mix16"]
    eng = JaxEngine(CFG, params, backend="codec-xla", page_size=PAGE,
                    num_pages=CAPPED_PAGES, max_q=8, temperature=0.0, **CAPPED)
    eng.admission.cost_model = _stub_cost
    return drive(eng, wl)


@pytest.mark.parametrize("backend,fused", CAPPED_RUNS,
                         ids=[f"{b}-{'fused' if f else 'eager'}"
                              for b, f in CAPPED_RUNS])
def test_capped_auto_chunk_trace_matches_repro(shared, repro_capped,
                                               backend, fused):
    """``max_running``, ``reserve_pages`` and ``prefill_chunk="auto"`` on
    an engine: the same streams, step trace and page counts as
    ``repro``'s, the cap reached and never passed, and chunked prefill
    under the shared cost model."""
    _, model = shared
    wl, _ = WORKLOADS["mix16"]
    want, want_trace, _, want_peak = repro_capped
    eng = DecodeEngine(CFG, model, backend=backend, fused=fused,
                       page_size=PAGE, num_pages=CAPPED_PAGES, max_q=8,
                       device="cpu", **CAPPED)
    eng.admission.cost_model = _stub_cost
    got, trace, stats, peak = drive(eng, wl)
    assert got == want
    assert trace == want_trace
    assert peak == want_peak
    live = [st["running"] + st["prefilling"] for st in eng.step_stats]
    assert max(live) == CAPPED["max_running"], live
    assert stats["prefill_chunks"] >= 1, stats


# --------------------------------------------------------------------- #
# the admission policy and queue against repro's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [None, 8, 13, "auto"])
def test_min_working_pages_matches_repro(chunk):
    ours = scheduler.AdmissionPolicy(prefill_chunk=chunk)
    theirs = jsched.AdmissionPolicy(prefill_chunk=chunk)
    for page in (8, 16):
        for n in (0, 1, 7, 8, 9, 13, 40, 1000):
            assert ours.min_working_pages(n, page) \
                == theirs.min_working_pages(n, page), (chunk, page, n)


def test_admission_reserve_and_validation_match_repro():
    for reserve in (0, 3):
        ours = scheduler.AdmissionPolicy(reserve_pages=reserve)
        theirs = jsched.AdmissionPolicy(reserve_pages=reserve)
        for running in (0, 1, 5):
            assert ours.admission_reserve(running) \
                == theirs.admission_reserve(running) == reserve
    for bad in ("whole", 0, -4):
        for policy in (scheduler.AdmissionPolicy, jsched.AdmissionPolicy):
            with pytest.raises(ValueError):
                policy(prefill_chunk=bad)


def _stub_cost(n_q, n):
    """A cost model both controllers share (``auto`` chunks then agree
    whatever the packages' hardware priors)."""
    return 0.0 if n_q <= 0 or n <= 0 else 3.0 * n_q * n + 50.0 * n_q + n


@pytest.mark.parametrize("chunk", [None, 24, "auto"])
def test_prefill_budget_matches_repro(chunk):
    for ratio, cap in ((4.0, 16384), (0.5, 64), (40.0, 128)):
        kw = dict(prefill_chunk=chunk, balance_ratio=ratio,
                  max_auto_chunk=cap)
        ours = scheduler.AdmissionController(
            scheduler.AdmissionPolicy(**kw), _stub_cost, PAGE)
        theirs = jsched.AdmissionController(
            jsched.AdmissionPolicy(**kw), _stub_cost, PAGE)
        for ctx in ([], [40], [10, 300, 77], [4096] * 8):
            assert ours.prefill_budget(ctx) == theirs.prefill_budget(ctx), \
                (chunk, ratio, ctx)


def test_queue_requeues_preempted_requests_at_the_front():
    q = scheduler.AdmissionController(scheduler.AdmissionPolicy(),
                                      _stub_cost, PAGE)
    for rid in (4, 5, 6):
        q.push(rid)
    q.requeue(2)
    q.remove(5)
    q.remove(99)
    assert [q.pop() for _ in range(len(q))] == [2, 4, 6]
    assert q.peek() is None


# --------------------------------------------------------------------- #
# pins across node splits, fail-fast admission, arrival schedules
# --------------------------------------------------------------------- #
def test_split_keeps_pins_on_both_halves_like_repro():
    """A pinned node that a later insert splits keeps both halves pinned,
    in the port's forest as in ``repro``'s, and the split observer sees
    the same halves."""
    seen = {}
    for name, mod in (("port", tree), ("repro", jtree)):
        f = mod.PrefixForest(4)
        f.insert_tokens(0, np.arange(16, dtype=np.int32))
        for n in f.path(0):
            n.meta["pins"] = n.meta.get("pins", 0) + 1
        f.detach_request(0)
        splits = []
        f.on_split = lambda up, lo, s=splits: s.append((up.id, lo.id))
        f.insert_tokens(1, np.array([0, 1, 2, 3, 4, 5, 6, 7, 90, 91],
                                    np.int32))
        f.validate()
        pinned = sorted((n.id, n.length, n.meta["pins"])
                        for n in f.nodes.values()
                        if n.meta.get("pins", 0) > 0)
        seen[name] = (splits, pinned)
    assert seen["port"] == seen["repro"]
    splits, pinned = seen["port"]
    assert splits and sum(length for _, length, _ in pinned) == 16


def test_pinned_split_frees_both_halves_once_the_waiter_resumes(shared):
    """``repro``'s regression on the port's engine: a preempted waiter
    pins the shared document, a later request sharing half of it splits
    the pinned node, the releases of the others keep the whole span, and
    the waiter's resumption unpins and frees both halves."""
    _, model = shared
    eng = _engine(model, "codec-cuda", False, 64, prefill_chunk=None)
    doc = list(range(10, 42))                   # 32 tokens = 4 pages
    r0 = eng.add_request(doc + [1, 2], max_new=4)
    r1 = eng.add_request(doc + [3, 4], max_new=4)
    eng.step()
    eng._preempt(r1)                 # r1 waits, pinning the shared doc
    eng.admission.remove(r1)         # hold it out so it cannot resume yet
    assert eng.requests[r1].pinned
    r2 = eng.add_request(doc[:16] + [5, 6], max_new=2)
    eng.run(16)
    eng.release(r0)
    eng.release(r2)
    pinned = [n for n in eng.forest.nodes.values()
              if n.meta.get("pins", 0) > 0]
    assert len(pinned) == 2
    assert sum(len(n.page_ids) for n in pinned) == 4
    assert sorted(eng.requests[r1].pinned) == sorted(n.id for n in pinned)
    eng.admission.push(r1)
    eng.run(32)
    got = list(eng.requests[r1].generated)
    eng.release(r1)
    assert eng.pool.num_free == eng.pool.num_pages
    eng.pool.allocator.check()
    assert set(eng.forest.nodes) == {0}
    # the resumed stream is the one an undisturbed run gives
    alone = _engine(model, "codec-cuda", False, 64, prefill_chunk=None)
    alone.add_request(doc + [1, 2], max_new=4)
    rid = alone.add_request(doc + [3, 4], max_new=4)
    assert alone.run(16)[rid] == got


@pytest.mark.parametrize("chunk,pages,prompt_len", [(None, 4, 200),
                                                    (16, 2, 40)])
def test_oversized_prompt_fails_fast_like_repro(shared, chunk, pages,
                                                prompt_len):
    params, model = shared
    prompt = [i % 250 for i in range(prompt_len)]
    for eng in (_engine(model, "codec-cuda", False, pages, chunk),
                JaxEngine(CFG, params, backend="codec-xla", page_size=PAGE,
                          num_pages=pages, temperature=0.0,
                          prefill_chunk=chunk)):
        with pytest.raises(MemoryError):
            eng.add_request(prompt, max_new=2)


def test_chunked_prompt_larger_than_the_pool_waits(shared):
    """Only the working set decides servability: a prompt of 63 pages
    waits for an 8-page pool with 16-token chunks instead of raising."""
    _, model = shared
    eng = _engine(model, "codec-cuda", False, 8, prefill_chunk=16)
    rid = eng.add_request([i % 250 for i in range(1000)], max_new=2)
    assert eng.requests[rid].state == "waiting"


def test_lone_request_outgrowing_the_pool_raises(shared):
    """With nothing to evict and no other tenant the growing request
    cannot be preempted: it fails as ``kv_exhausted``, as ``repro``'s
    does, instead of raising, with its pages back in the pool."""
    params, model = shared
    wl, pages = WORKLOADS["fixed"]
    prompt = wl[0][0]
    seen = []
    for eng in (_engine(model, "codec-cuda", False, pages),
                JaxEngine(CFG, params, backend="codec-xla", page_size=PAGE,
                          num_pages=pages, max_q=8, temperature=0.0,
                          prefill_chunk=CHUNK)):
        rid = eng.add_request(prompt, max_new=30)
        eng.run(40)
        req = eng.requests[rid]
        seen.append((req.state, req.finish_reason, list(req.generated),
                     dict(eng.step_stats[-1])["pages_free"]))
        eng.check()
    assert seen[0] == seen[1]
    assert seen[0][:2] == ("failed", "kv_exhausted")
    assert seen[0][3] == pages and len(seen[0][2]) == pages * PAGE \
        - len(prompt) + 1                          # with its overflow token


# test_differential.py's pressure workload at temperature 0.8: sampling
# through preemption and recompute must split the key as repro's does
SAMPLED = dict(temperature=0.8, seed=3)


@pytest.fixture(scope="module")
def repro_sampled(shared):
    params, _ = shared
    wl, pages = WORKLOADS["fixed"]
    return {fused: drive(JaxEngine(
        CFG, params, backend="codec-xla", page_size=PAGE, num_pages=pages,
        max_q=8, prefill_chunk=CHUNK, fused=fused, **SAMPLED), wl)
        for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True],
                         ids=["eager", "fused"])
def test_sampled_pressure_streams_and_trace_match_repro(shared,
                                                        repro_sampled,
                                                        fused):
    _, model = shared
    wl, pages = WORKLOADS["fixed"]
    want, want_trace, _, want_peak = repro_sampled[fused]
    eng = DecodeEngine(CFG, model, backend="codec-cuda", fused=fused,
                       page_size=PAGE, num_pages=pages, max_q=8,
                       prefill_chunk=CHUNK, device="cpu", **SAMPLED)
    got, trace, stats, peak = drive(eng, wl)
    assert got == want
    assert trace == want_trace and peak == want_peak
    assert stats["preempted"] >= 1 and stats["recompute_tokens"] >= 1
    greedy, _, _, _ = drive(_engine(model, "codec-cuda", fused, pages), wl)
    assert got != greedy


@pytest.mark.parametrize("arrivals,rate", [("scripted", 2.0),
                                           ("scripted", 0.3),
                                           ("poisson", 1.5),
                                           ("poisson", 0.5)])
def test_build_schedule_matches_serve_replay(arrivals, rate):
    prompts = [[i, i + 1] for i in range(24)]
    for seed in (0, 1):
        want = serve_replay.build_schedule(
            types.SimpleNamespace(arrivals=arrivals, rate=rate),
            np.random.default_rng(seed), prompts)
        got = build_schedule(arrivals, rate, np.random.default_rng(seed),
                             len(prompts))
        assert got == [step for step, _ in want]
        assert [p for _, p in want] == prompts


# --------------------------------------------------------------------- #
# serve(): arrivals that grow and shrink the fused step's bucket
# --------------------------------------------------------------------- #
def _nan_keys_on_free(eng):
    """Fill the K of every page the engine frees with NaN: a plan or a
    step that still read a freed page's live slots would score NaN.  (V
    stays: the plain tail attention weighs a page's dead slots by zero,
    which NaN would defeat; the card's test fills both, as its kernels
    never read a dead slot.)"""
    alloc, pool = eng.pool.allocator, eng.pool
    release = alloc.release

    def release_nan(pages):
        before = alloc.num_free
        release(pages)
        if alloc._free[before:]:
            pool.k[:, torch.as_tensor(alloc._free[before:])] = float("nan")
    alloc.release = release_nan


def test_serve_arrivals_under_pressure_grow_and_shrink_the_bucket():
    """``serve`` with Poisson arrivals on an undersized pool whose freed
    pages turn NaN: the loop runs on through idle steps until every
    arrival is served, the row bucket grows and shrinks, no logit is
    non-finite, the fused streams equal the eager ones and an
    unconstrained run's, and the counters show the pressure."""
    model = build_model(CFG, seed=0, device="cpu", dtype=torch.float32)
    doc = list(range(10, 10 + 48))
    prompts = [doc + [100 + 3 * i + j for j in range(3)] for i in range(12)]
    steps = build_schedule("poisson", 0.5, np.random.default_rng(0),
                           len(prompts))
    assert steps[0] > 0                 # the loop starts idle
    res = {}
    for fused, pages in ((False, 16), (True, 16), (True, 256)):
        eng = _engine(model, "codec-cuda", fused, pages)
        _nan_keys_on_free(eng)
        finite = []
        r = serve(eng, prompts, max_new=8, arrival_steps=steps,
                  on_step=lambda e: finite.append(
                      e.last_logits is None
                      or bool(torch.isfinite(e.last_logits).all())))
        assert all(finite) and eng.stats["nonfinite_rows"] == 0
        assert r["loop_steps"] > r["steps"] > 0
        assert r["prefill_s"] == 0.0 and r["prefill_loop_s"] > 0
        assert r["tokens_per_s"] > 0 and r["step_ms"] > 0
        assert r["peak_pages"] == eng.pool.allocator.peak_used <= pages
        assert r["signatures"] == len(eng.bucket_signatures)
        assert r["graphs"] == 0                 # no graph on the CPU
        if fused:
            assert eng.fused_step.replays == r["steps"]
        res[fused, pages] = r
    pressured = res[True, 16]
    assert pressured["streams"] == res[False, 16]["streams"] \
        == res[True, 256]["streams"]
    assert all(len(t) == 8 for t in pressured["streams"].values())
    assert pressured["peak_pages"] == 16
    for k in ("preempted", "recompute_tokens", "prefill_chunks"):
        assert pressured["pressure"][k] >= 1, pressured["pressure"]
    assert res[True, 256]["pressure"]["preempted"] == 0
    for r in res.values():
        b = r["buckets"]
        assert len(set(b)) >= 3, b
        assert any(x < y for x, y in zip(b, b[1:])), b
        assert any(x > y for x, y in zip(b, b[1:])), b
