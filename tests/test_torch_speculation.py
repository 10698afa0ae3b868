"""Tree-speculative decoding of the port (``serving/speculation.py``, the
draft API of ``core/tree.py``, ``core/plan.build_verify_plan``,
``PagedKVPool.copy_slots``, ``DecodeEngine(speculative=)`` eager and
fused, ``por_epilogue(tail=False)``) against ``repro``'s on the same
inputs and weights.

* The framework-free pieces: the proposer, ``_cap_total``,
  ``accept_walk``, the draft grow/prune round trip and the draft skip in
  radix matching give ``repro``'s results; ``build_verify_plan`` equals
  ``repro``'s field by field (codec and flash kinds) over a forest with
  partial tail pages and one-token draft pages.
* The verify attention: every branch head of a draft forest through the
  port's ``codec-torch``, ``flash`` and ``hydragen`` (the backend's parts,
  then the epilogue with no tail) against ``repro``'s backends (Pallas in
  interpret mode for the codec plan) and the dense oracle, within 1e-5.
* The engine: streams, the ``spec_*`` counters and the per-step records
  equal ``repro``'s speculative ``codec-xla`` engine for every port
  backend, eager and fused (``ref`` eager only), on a repetitive prompt,
  on several requests over a shared prefix, and under memory pressure
  with ``max_nodes=1`` and chunked prefill; every stream equals plain
  greedy decode; nothing leaks.  Preempting, releasing and failing a
  request with a live draft tree leave no page, node or draft; the
  ``ValueError`` gates and the exact ``max_new`` cap; ``test_faults.py``'s
  chaos mix and ``test_telemetry.py``'s spans in speculative mode.

``repro`` runs once per workload (module fixture): its engine compiles
every new shape, which takes most of this file's time.  Widths are
``smoke_config("qwen3-4b")`` (2 layers, d_model 64).  The sliding-window
case (``test_spec_sliding_window_arch``, gemma3's smoke config) holds
speculative streams to the port's own plain greedy ones, which
``tests/test_torch_windowed.py`` holds to ``repro``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as jplan, tree as jtree
from repro.kernels import registry as jregistry
from repro.models import transformer as JT
from repro.serving import engine as jengine, faults as jfaults
from repro.serving import kv_cache as jkv, speculation as jspec
from repro.serving import telemetry as jtelemetry
from repro_torch.configs import PAPER_ARCH, LayerKind, smoke_config
from repro_torch.core import plan, tree
from repro_torch.core.cost_model import CostModel
from repro_torch.kernels import por as por_mod, ref, registry
from repro_torch.models.transformer import Transformer
from repro_torch.serving import engine, faults, speculation as spec
from repro_torch.serving import telemetry
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = smoke_config(PAPER_ARCH)
PAGE = 8
PATTERN = [5, 7, 11, 13]
REP_PROMPT = (PATTERN * 6)[:24]
REP_MAX_NEW = 12

REPRO = types.SimpleNamespace(
    SpecConfig=jspec.SpecConfig, FaultPlan=jfaults.FaultPlan,
    FaultSpec=jfaults.FaultSpec, KINDS=jfaults.KINDS,
    Telemetry=jtelemetry.Telemetry)
PORT = types.SimpleNamespace(
    SpecConfig=spec.SpecConfig, FaultPlan=faults.FaultPlan,
    FaultSpec=faults.FaultSpec, KINDS=faults.KINDS,
    Telemetry=telemetry.Telemetry)

# counters and the per-step record compared whole
STATS = ("steps", "spec_steps", "spec_proposed", "spec_accepted",
         "spec_draft_stalls", "admitted", "preempted", "reclaimed",
         "recompute_tokens", "prefill_chunks", "prefill_tokens")
STEP_KEYS = ("decoded", "admitted", "preempted", "reclaimed",
             "prefill_tokens", "recompute_tokens", "spec_proposed",
             "spec_accepted", "waiting", "prefilling", "running",
             "pages_free", "occupancy")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _kw(kw):
    out = dict(page_size=PAGE, num_pages=256, max_q=8, temperature=0.0)
    out.update(kw)
    return out


def drive(eng, prompts, max_new, release_at=None):
    """``test_speculation.py``'s ``run_engine``: run to completion
    (releasing the last request before step ``release_at``), observe,
    self-check, release everything and require an empty pool and
    forest."""
    rids = [eng.add_request(list(p), max_new=max_new) for p in prompts]
    for step in range(200):
        if release_at is not None and step == release_at:
            eng.release(rids.pop())
        if not eng.has_work():
            break
        eng.step()
    assert not eng.has_work(), "workload did not finish"
    obs = {"streams": [[int(t) for t in eng.requests[r].generated]
                       for r in rids],
           "stats": {k: eng.stats[k] for k in STATS},
           "trace": [tuple(s.get(k) for k in STEP_KEYS)
                     for s in eng.step_stats]}
    assert not eng._drafts, "draft state outlived its step"
    eng.check()
    for r in list(eng.requests):
        eng.release(r)
    assert eng.pool.num_free == eng.pool.num_pages, "leaked pages"
    eng.pool.allocator.check()
    assert set(eng.forest.nodes) == {0}, "leaked forest nodes"
    return obs


def _shared_prompts():
    rng = np.random.default_rng(0)
    doc = (list(rng.integers(0, CFG.vocab_size, 8)) * 3)[:24]
    return [doc + list(rng.integers(0, CFG.vocab_size, 2))
            for _ in range(3)]


def _pressure_prompts():
    doc = (PATTERN * 12)[:48]
    return [doc + [100 + 3 * i + j for j in range(3)] for i in range(4)]


# name -> (prompts, max_new, engine options, SpecConfig options);
# test_speculation.py's workloads
WORKLOADS = {
    "rep": ([REP_PROMPT], REP_MAX_NEW, {}, {}),
    "shared": (_shared_prompts(), 6, {}, {}),
    "pressure": (_pressure_prompts(), 12,
                 dict(num_pages=9, prefill_chunk=8), dict(max_nodes=1)),
}


def run_workload(make, pkg, name, speculative=True):
    prompts, max_new, opts, spec_opts = WORKLOADS[name]
    eng = make(speculative=(pkg.SpecConfig(**spec_opts) if speculative
                            else None), **opts)
    return drive(eng, prompts, max_new)


@pytest.fixture(scope="module")
def shared():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        CFG, from_jax_params(CFG, jax.tree.map(np.asarray, params)))
    return params, model


@pytest.fixture(scope="module")
def repro_run(shared):
    """``repro``'s speculative ``codec-xla`` record of a workload, run
    once."""
    params, _ = shared
    runs = {}

    def get(name):
        if name not in runs:
            def make(**kw):
                return jengine.DecodeEngine(CFG, params, backend="codec-xla",
                                            **_kw(kw))
            runs[name] = run_workload(make, REPRO, name)
        return runs[name]
    return get


def port_make(model, backend="codec-cuda", fused=False):
    def make(**kw):
        eng = engine.DecodeEngine(CFG, model, backend=backend, fused=fused,
                                  device="cpu", **_kw(kw))
        assert eng.fused == (fused and backend != "ref")
        return eng
    return make


# --------------------------------------------------------------------- #
# the framework-free pieces
# --------------------------------------------------------------------- #
def test_proposer_and_cap_match_repro():
    seqs = [[1, 2, 3, 9, 1, 2, 3, 4, 1, 2, 3], [1, 2, 3, 4, 5], [7], [],
            REP_PROMPT, (PATTERN * 3) + [5, 7, 99, 5, 7],
            list(np.random.default_rng(0).integers(0, 6, 64))]
    for opts in ({}, dict(depth=3, branch=2, max_nodes=5, ngram=2),
                 dict(depth=1, branch=3, max_nodes=2, ngram=1)):
        mine = spec.NGramProposer(spec.SpecConfig(**opts))
        theirs = jspec.NGramProposer(jspec.SpecConfig(**opts))
        for seq in seqs:
            for cap in (0, 1, 2, 7):
                assert mine.propose(seq, max_tokens=cap) == \
                    theirs.propose(seq, max_tokens=cap), (opts, seq, cap)
    branches = [[1, 2, 3], [4, 5], [6]]
    for budget in range(0, 8):
        assert spec._cap_total(branches, budget) == \
            jspec._cap_total(branches, budget)
    for bad in (dict(depth=0), dict(branch=0), dict(ngram=0),
                dict(max_nodes=0)):
        with pytest.raises(ValueError):
            spec.SpecConfig(**bad)


def _draft_forest(mod):
    """The same forest in either package: a shared 32-token trunk, three
    requests with partial private tails (5, 8 and 11 tokens) and a draft
    tree under each (chains, siblings at one position), each draft node
    with a virtual query.  Returns (forest, query rows)."""
    f = mod.PrefixForest(PAGE)
    trunk = f.add_node(mod.ROOT_ID, 4 * PAGE)
    rows, virt = {}, -2
    for r, tail in enumerate((5, 8, 11)):
        leaf = f.add_node(trunk.id, tail)
        f.attach_request(r, leaf.id)
        rows[r] = len(rows)
        shape = [[30 + r, 31], [40 + r]] if r != 1 else [[50, 51, 52]]
        for chain in shape:
            parent = leaf.id
            for tok in chain:
                node = f.add_draft(parent, tok)
                f.attach_request(virt, node.id)
                rows[virt] = len(rows)
                virt -= 1
                parent = node.id
    f.validate()
    return f, rows


def test_forest_draft_api_and_accept_walk_match_repro():
    for mod in (tree, jtree):
        f = mod.PrefixForest(4)
        leaf = f.add_node(mod.ROOT_ID, 4)
        d1 = f.add_draft(leaf.id, 10)
        d2 = f.add_draft(d1.id, 11)
        wrong = f.add_draft(leaf.id, 99)
        assert d1.meta["draft"] and d1.length == 1
        assert d2.start_pos == d1.end_pos == leaf.end_pos + 1
        argmax = {leaf.id: 10, d1.id: 11, d2.id: 12, wrong.id: 0}
        walks = [(dict(argmax), 8), (dict(argmax), 1), (dict(argmax), 0),
                 ({**argmax, d1.id: 77}, 8)]
        want = [([d1.id, d2.id], 12), ([d1.id], 11), ([], 10),
                ([d1.id], 77)]
        for walk in (spec.accept_walk, jspec.accept_walk):
            assert [walk(f, leaf.id, a.__getitem__, room)
                    for a, room in walks] == want
    # the grow/prune round trip leaves both forests as they were
    mine, rows = _draft_forest(tree)
    theirs, jrows = _draft_forest(jtree)
    assert rows == jrows
    for f in (mine, theirs):
        drafts = [n.id for n in f.nodes.values() if n.meta.get("draft")]
        assert f.context_len(-3) == 4 * PAGE + 5 + 2
        for virt in [r for r in rows if r < 0]:
            f.detach_request(virt)
        for nid in sorted(drafts, reverse=True):
            f.nodes[nid].page_ids = [nid]
            assert f.prune_leaf(nid) == [nid]
        f.validate()
    assert sorted(mine.nodes) == sorted(theirs.nodes)
    # radix matching never descends into unverified draft tokens
    for mod in (tree, jtree):
        f = mod.PrefixForest(1)
        f.insert_tokens(0, np.asarray([5, 6, 7], np.int32))
        d = f.add_draft(f.leaf_of[0], 8)
        f.attach_request(-2, d.id)
        assert f.match_len(np.asarray([5, 6, 7, 8, 9], np.int32)) == 3
        f.insert_tokens(1, np.asarray([5, 6, 7, 8], np.int32))
        assert all(not n.meta.get("draft") for n in f.path(1))
        f.detach_request(-2)
        f.prune_leaf(d.id)
        f.validate()
        chain = f.add_chain(7, [3, 2])
        assert f.context_len(7) == 5 and f.leaf_of[7] == chain


@pytest.mark.parametrize("kind", ["codec", "flash"])
def test_build_verify_plan_matches_repro(kind):
    mine, rows = _draft_forest(tree)
    theirs, _ = _draft_forest(jtree)
    for f in (mine, theirs):
        plan.assign_dense_pages(f)
    # one cost model for both planners (the port's is calibrated for the
    # card, ``repro``'s for the TPU: their schedules would differ)
    cm = CostModel(4, 2, 16, page_size=PAGE)
    got = plan.build_verify_plan(mine, cm, rows, 2, 8, 16, kind=kind)
    want = jplan.build_verify_plan(theirs, cm, rows, 2, 8, 16, kind=kind)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        elif field.name == "subtasks":
            assert [dataclasses.astuple(s) for s in a] == \
                [dataclasses.astuple(s) for s in b]
        else:
            assert a == b, field.name
    # nothing truncated: one-token draft pages and partial tails are read
    assert set(got.step_kvlen[got.step_valid == 1]) >= {1, 5, 3}


# port backend -> repro backend over the same verify plan
HEADS = {"codec-torch": "codec-pallas", "flash": "flash",
         "hydragen": "hydragen"}


@pytest.mark.parametrize("backend", list(HEADS))
def test_verify_branch_heads_match_repro_and_oracle(backend):
    mine, rows = _draft_forest(tree)
    theirs, _ = _draft_forest(jtree)
    pages = plan.assign_dense_pages(mine)
    jplan.assign_dense_pages(theirs)
    h_q, n_kv, d = 4, 2, 16
    be, jbe = registry.get(backend), jregistry.get(HEADS[backend])
    cm = CostModel(h_q, n_kv, d, page_size=PAGE)
    p = plan.build_verify_plan(mine, cm, rows, 2, 8, kind=be.plan_kind)
    jp = jplan.build_verify_plan(theirs, cm, rows, 2, 8, kind=jbe.plan_kind)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((len(rows), h_q, d)).astype(np.float32)
    k = rng.standard_normal((pages, PAGE, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((pages, PAGE, n_kv, d)).astype(np.float32)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = por_mod.por_epilogue(qt, *be.parts(qt, kt, vt, p), kt, vt, None,
                               None, None, tail=False)
    want = np.asarray(jbe(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jp))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    for qid, row in rows.items():
        ks, vs = [], []
        for node in mine.path(qid):
            for j, pg in enumerate(node.page_ids):
                take = min(PAGE, node.length - j * PAGE)
                ks.append(kt[pg, :take])
                vs.append(vt[pg, :take])
        o_ref, _, _ = ref.pac_ref(qt[row][None], torch.cat(ks),
                                  torch.cat(vs))
        torch.testing.assert_close(out[row], o_ref[0], rtol=1e-5, atol=1e-5)


def test_copy_slots_with_overlapping_slots_matches_repro():
    rng = np.random.default_rng(4)
    shape = (2, 5, PAGE, 2, 4)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    # (1, 0) and (2, 3) are both sources and destinations; (1, 0) -> (1, 0)
    # copies a slot onto itself
    src_p, src_o = np.array([1, 2, 3, 1]), np.array([0, 3, 0, 2])
    dst_p, dst_o = np.array([1, 1, 2, 0]), np.array([0, 2, 3, 5])
    mine = PagedKVPool(2, 4, PAGE, 2, 4, device="cpu")
    theirs = jkv.PagedKVPool(2, 4, PAGE, 2, 4)
    mine.k.copy_(torch.from_numpy(k))
    mine.v.copy_(torch.from_numpy(v))
    theirs.k, theirs.v = jnp.asarray(k), jnp.asarray(v)
    mine.copy_slots(src_p, src_o, dst_p, dst_o)
    theirs.copy_slots(src_p, src_o, dst_p, dst_o)
    np.testing.assert_array_equal(mine.k.numpy(), np.asarray(theirs.k))
    np.testing.assert_array_equal(mine.v.numpy(), np.asarray(theirs.v))
    # every destination holds its source's value from before the copy
    for s, so, dd, do in zip(src_p, src_o, dst_p, dst_o):
        np.testing.assert_array_equal(mine.k[:, dd, do].numpy(),
                                      k[:, s, so])


# --------------------------------------------------------------------- #
# the engine against repro's
# --------------------------------------------------------------------- #
CASES = ([("rep", b, f) for b in ("codec-cuda", "codec-torch", "flash",
                                   "hydragen") for f in (False, True)]
         + [("rep", "ref", False)]
         + [(w, "codec-cuda", f) for w in ("shared", "pressure")
            for f in (False, True)])


@pytest.mark.parametrize(
    "name,backend,fused", CASES,
    ids=[f"{n}-{b}-{'fused' if f else 'eager'}" for n, b, f in CASES])
def test_spec_engine_matches_repro(shared, repro_run, name, backend, fused):
    _, model = shared
    make = port_make(model, backend, fused)
    got = run_workload(make, PORT, name)
    want = repro_run(name)
    assert got == want
    # byte-identical to plain greedy decode
    assert got["streams"] == run_workload(make, PORT, name,
                                          speculative=False)["streams"]
    st = got["stats"]
    assert st["spec_steps"] == st["steps"] >= 1
    if name == "rep":
        # drafts accepted: fewer dispatches than committed tokens
        assert 1 <= st["spec_accepted"] <= st["spec_proposed"]
        assert st["spec_steps"] < sum(map(len, got["streams"]))
    if name == "pressure":
        assert st["preempted"] >= 1 and st["spec_accepted"] >= 1
    if fused and backend != "ref":
        assert got["stats"]["spec_steps"] >= 1


def test_preempt_release_and_fail_mid_speculation(shared, repro_run):
    """A request holding a live draft tree is preempted, released, or
    quarantined: its draft nodes, virtual queries and pages all go; a
    preempted one resumes to ``repro``'s stream.  A virtual query without
    a draft tree fails ``check()``.  A request admitted while another's
    draft tree is live never shares its draft KV."""
    _, model = shared
    want = repro_run("rep")["streams"][0]
    for fused in (False, True):
        eng = port_make(model, fused=fused)(speculative=True, num_pages=64)
        r = eng.add_request(list(REP_PROMPT), max_new=REP_MAX_NEW)
        for _ in range(6):
            eng.step()
        eng._grow_drafts([r])
        n_draft = len(eng._drafts[r].nodes)
        assert n_draft >= 1, "repetitive stream must draft"
        # admitted mid-tree: its prompt extends into the draft tokens
        draft_tok = int(eng.forest.nodes[eng._drafts[r].nodes[0]].tokens[0])
        r2 = eng.add_request(list(eng.requests[r].seq) + [draft_tok, 251],
                             max_new=2)
        assert all(not n.meta.get("draft") for n in eng.forest.path(r2))
        eng.check()
        used = eng.pool.allocator.num_used
        eng._preempt(r)
        assert r not in eng._drafts
        assert not any(n.meta.get("draft") for n in eng.forest.nodes.values())
        assert all(q >= 0 for q in eng.forest.leaf_of)
        assert eng.pool.allocator.num_used <= used - n_draft
        eng.check()
        eng.run(64)
        assert eng.requests[r].generated == want
        assert len(eng.requests[r2].generated) == 2
        # release and quarantine with a live tree
        r3 = eng.add_request(list(REP_PROMPT), max_new=6)
        r4 = eng.add_request(list(REP_PROMPT) + [5], max_new=6)
        eng.step()
        eng.step()
        eng._grow_drafts([r3, r4])
        assert eng._drafts
        # plant a virtual query whose tree the engine does not know
        leaf = eng.forest.leaf_of[r3]
        eng.forest.attach_request(-999, leaf)
        with pytest.raises(faults.EngineInvariantError, match="virtual"):
            eng.check()
        eng.forest.detach_request(-999)
        eng.release(r3)
        eng._fail_request(r4, "nan_logits")
        assert not eng._drafts
        eng.check()
        assert eng.shutdown()["used_pages"] == 0
        assert set(eng.forest.nodes) == {0}


def test_spec_gates_and_exact_max_new_cap(shared):
    params, model = shared
    with pytest.raises(ValueError, match="greedy-only"):
        engine.DecodeEngine(CFG, model, device="cpu", temperature=0.7,
                            speculative=True)
    mamba = dataclasses.replace(CFG, layer_pattern=(
        LayerKind(mixer="mamba", ffn="none"),))
    with pytest.raises(ValueError, match="Mamba"):
        engine.DecodeEngine(mamba, model, device="cpu", speculative=True)
    eng = engine.DecodeEngine(CFG, model, device="cpu", speculative=True,
                              num_pages=64, reserve_pages=2)
    assert eng.policy.draft_reserve_pages == spec.SpecConfig().max_nodes
    assert eng.policy.admission_reserve(3) == 2 + 3 * 6
    # accepted drafts never overshoot max_new (the walk's room cap)
    for max_new in (1, 2, 3):
        got = []
        for mod, make in (
                (PORT, port_make(model)),
                (REPRO, lambda **kw: jengine.DecodeEngine(
                    CFG, params, backend="codec-xla", **_kw(kw)))):
            eng = make(speculative=mod.SpecConfig())
            got.append(drive(eng, [REP_PROMPT], max_new))
        assert got[0] == got[1], max_new
        assert [len(s) for s in got[0]["streams"]] == [max_new]


@pytest.fixture(scope="module")
def gemma3_plain():
    """gemma3's smoke model (5 local : 1 global layers) on ``repro``'s
    weights, and a function serving ``REP_PROMPT`` through it; its plain
    greedy stream (eager) is computed once."""
    cfg = smoke_config("gemma3-1b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))

    def serve(speculative, fused):
        eng = engine.DecodeEngine(cfg, model, backend="codec-cuda",
                                  fused=fused, device="cpu",
                                  speculative=speculative, **_kw({}))
        assert eng._windows() == [0, cfg.sliding_window]
        obs = drive(eng, [REP_PROMPT], REP_MAX_NEW)
        return obs["streams"][0], obs["stats"]
    return serve, serve(None, False)[0]


@pytest.mark.parametrize("fused", [False, True])
def test_spec_sliding_window_arch(gemma3_plain, fused):
    """``test_speculation.py::test_spec_sliding_window_arch`` on the port:
    sliding-window layers route through per-window verify plans (window
    pruning in ``build_verify_plan``, one plan slot a window in the fused
    verify step); streams equal plain greedy and drafts are accepted."""
    serve, base = gemma3_plain
    got, stats = serve(spec.SpecConfig(), fused)
    assert got == base
    assert stats["spec_accepted"] > 0
    assert stats["spec_steps"] < len(got), "window arch must accept drafts"


def chaos(make, pkg):
    """``test_faults.py``'s chaos mix in speculative mode: every request
    ends, nothing leaks (``alloc`` faults are gated off under
    speculation).  Returns what a user can see."""
    kinds = tuple(k for k in pkg.KINDS if k != "alloc")
    specs = list(pkg.FaultPlan.seeded(11, steps=6, rate=0.2,
                                      kinds=kinds).specs)
    specs += [pkg.FaultSpec("dispatch", 1), pkg.FaultSpec("nan_logits", 3)]
    clock = FakeClock()
    eng = make(faults=pkg.FaultPlan(specs), nan_guard=True, check_every=3,
               clock=clock,
               speculative=pkg.SpecConfig(depth=2, branch=2, max_nodes=3))
    rids = [eng.add_request(REP_PROMPT + [100 + 5 * i + j for j in range(2)],
                            max_new=4, deadline_s=2.5 if i == 2 else None)
            for i in range(3)]
    eng.cancel(rids[0])
    for _ in range(40):
        if not eng.has_work():
            break
        eng.step()
        clock.t += 1.0
    assert not eng.has_work(), "chaos mix did not drain"
    assert all(q.finished for q in eng.requests.values())
    eng.check()
    out = {"streams": {r: [int(t) for t in q.generated]
                       for r, q in eng.requests.items()},
           "states": {r: (q.state, q.finish_reason)
                      for r, q in eng.requests.items()},
           "fired": dict(eng.injector.fired),
           "stats": {k: eng.stats[k] for k in STATS + (
               "faults_injected", "nan_rows", "dispatch_recoveries",
               "failed", "cancelled", "timed_out", "invariant_checks")},
           "trace": [tuple(s.get(k) for k in STEP_KEYS)
                     for s in eng.step_stats]}
    out["shutdown"] = eng.shutdown()
    assert not eng._drafts and set(eng.forest.nodes) == {0}
    return out


def test_spec_chaos_mix_quiesces_eager_and_fused(shared):
    """``test_faults.py``'s chaos property in speculative mode, on the
    port's eager and fused engines: both drain, leak nothing and give the
    same record (a NaN is quarantined before the commit on both paths)."""
    _, model = shared
    got = [chaos(port_make(model, fused=f), PORT) for f in (False, True)]
    assert got[0] == got[1]
    assert got[0]["shutdown"]["used_pages"] == 0
    assert got[0]["stats"]["faults_injected"] >= 2
    assert got[0]["stats"]["spec_steps"] >= 1
    assert got[0]["states"][0] == ("cancelled", "cancelled")
    for state, why in got[0]["states"].values():
        if state == "failed":
            assert why in ("nan_logits", "callback_error")


def traced_spec(make, pkg, tm, prompts=(REP_PROMPT,), max_new=REP_MAX_NEW,
                **spec_opts):
    """A speculative workload on a fake clock one unit a step: streams,
    trace events and the registry's counters."""
    clock = FakeClock()
    eng = make(telemetry=tm, clock=clock,
               speculative=pkg.SpecConfig(**spec_opts))
    rids = [eng.add_request(list(p), max_new=max_new) for p in prompts]
    for _ in range(100):
        if not eng.has_work():
            break
        eng.step()
        clock.t += 1.0
    eng.flush_tokens()
    eng._stream_ready()
    eng._notify_done()
    snap = eng.publish_metrics().snapshot() if tm is not None else None
    return {"streams": [[int(t) for t in eng.requests[r].generated]
                        for r in rids],
            "events": None if tm is None else [
                (e["name"], e["ph"], e["pid"], e["tid"], e["ts"],
                 e.get("dur"), e.get("args")) for e in tm.trace_events()],
            "counters": None if snap is None else {
                k: s["value"] for k, s in snap.items()
                if s["type"] == "counter"}}


def test_spec_telemetry_matches_repro(shared):
    """``test_telemetry.py``'s speculative on/off case (its prompts and
    draft shape: streams equal with telemetry on and off); then spans and
    counters on the repetitive workload equal ``repro``'s eager engine's,
    eager and fused (the fused engine also counts its verify
    dispatches)."""
    params, model = shared
    small = dict(prompts=(REP_PROMPT, REP_PROMPT + [9]), max_new=6,
                 depth=2, branch=2, max_nodes=3)
    want = traced_spec(lambda **kw: jengine.DecodeEngine(
        CFG, params, backend="codec-xla", **_kw(kw)), REPRO,
        jtelemetry.Telemetry(profile_every=3))
    for fused in (False, True):
        make = port_make(model, fused=fused)
        off = traced_spec(make, PORT, None, **small)
        on = traced_spec(make, PORT, telemetry.Telemetry(profile_every=3),
                         **small)
        assert on["streams"] == off["streams"] and all(off["streams"])
        got = traced_spec(make, PORT, telemetry.Telemetry(profile_every=3))
        assert got["streams"] == want["streams"]
        assert got["events"] == want["events"], fused
        counters = dict(got["counters"])
        dispatches = counters.pop("fused_dispatches")
        assert dispatches == (counters["spec_steps"] if fused else 0)
        assert counters == {k: v for k, v in want["counters"].items()
                            if k != "fused_dispatches"}, fused
        names = {e[0] for e in got["events"]}
        assert {"spec_propose", "spec_verify", "spec_accept"} <= names
        assert counters["spec_steps"] >= 1 and counters["spec_accepted"] >= 1
