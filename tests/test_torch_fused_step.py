"""The port's fused decode step (``repro_torch.serving.step_fn``) on the
CPU, where its step body runs eagerly over the same fixed buffers that a
captured CUDA graph replays on the card.

Held here: greedy streams byte-identical to the port's eager engine for
every jit-safe backend across a bucket crossing (rows 2 -> 3 -> 5, buckets
2 -> 4 -> 8), and to ``repro``'s fused engine; ``bucket_plan`` against
``repro``'s field by field, the padded CSR included; deferred tokens
(placeholders between sync points, a ring of output slices that wraps);
the signature bound; and a leak-free pool after release.  Weights come
from ``repro.models.transformer.init_params`` through ``from_jax_params``.
"""

import dataclasses
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.core import plan as jplan, tree as jtree
from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.configs import PAPER_ARCH, smoke_config
from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import ops, por as por_mod
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import PENDING_DEVICE, DecodeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

FUSED_BACKENDS = ["codec-cuda", "codec-torch", "flash", "hydragen"]
PAGE = 8
DOC = list(range(10, 10 + 32))


@pytest.fixture(scope="module")
def shared():
    cfg = smoke_config(PAPER_ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
    return cfg, params, model


def _engine(model, backend="codec-cuda", fused=True, **kw):
    kwargs = dict(page_size=PAGE, num_pages=256, max_q=8, fused=fused,
                  device="cpu")
    kwargs.update(kw)
    return DecodeEngine(model.cfg, model, backend=backend, **kwargs)


def _bucket_crossing_run(eng):
    """2 requests decode, then arrivals push the batch to 3 and 5 rows:
    the fused row bucket crosses 2 -> 4 -> 8 mid-decode (the workload of
    ``tests/test_fused_step.py``)."""
    rids = [eng.add_request(DOC + [100 + i], max_new=10) for i in range(2)]
    eng.step(); eng.step()
    rids.append(eng.add_request(DOC + [200], max_new=8))   # bucket 2 -> 4
    eng.step(); eng.step()
    rids.append(eng.add_request(DOC + [210], max_new=6))
    rids.append(eng.add_request(DOC + [220], max_new=6))   # bucket 4 -> 8
    eng.run(32)
    outs = {i: list(eng.requests[r].generated) for i, r in enumerate(rids)}
    assert all(outs[i] for i in outs)
    return outs


@pytest.fixture(scope="module")
def eager_crossing(shared):
    _, _, model = shared
    runs = {}

    def get(backend):
        if backend not in runs:
            runs[backend] = _bucket_crossing_run(
                _engine(model, backend, fused=False))
        return runs[backend]
    return get


@pytest.mark.parametrize("backend", FUSED_BACKENDS)
def test_fused_matches_eager_across_bucket_boundary(shared, eager_crossing,
                                                    backend):
    _, _, model = shared
    eng = _engine(model, backend)
    assert eng.fused
    got = _bucket_crossing_run(eng)
    assert got == eager_crossing(backend)
    assert eng.stats["fused_calls"] == eng.stats["steps"]
    assert eng.fused_cache_size == len(eng.bucket_signatures)
    assert eng.stats["nonfinite_rows"] == 0
    # every deferred token landed: no placeholder left anywhere
    assert all(t >= 0 for s in got.values() for t in s)


def test_ref_backend_decodes_eagerly(shared):
    _, _, model = shared
    eng = _engine(model, "ref")
    assert not eng.fused              # not jit-safe: the eager loop runs
    eng.add_request(DOC + [100], max_new=3)
    outs = eng.run(8)
    assert len(next(iter(outs.values()))) == 3
    assert eng.stats["fused_calls"] == 0 and eng.fused_cache_size == 0


# test_torch_engine.py's workload: shared-document prompts, a fully shared
# prompt, and a late request that splits a cached node mid-run
KW = dict(page_size=16, num_pages=512, max_q=8, temperature=0.0)
_DOC48 = list(range(10, 58))
PROMPTS = [_DOC48 + [100 + 3 * i + j for j in range(3)] for i in range(3)]
PROMPTS.append(PROMPTS[0])
LATE = [list(range(10, 50)) + [7, 8, 9, 11, 12]]


def _drive(engine, max_new=6, steps=12):
    for p in PROMPTS:
        engine.add_request(p, max_new=max_new)
    for _ in range(2):
        engine.step()
    for p in LATE:
        engine.add_request(p, max_new=max_new)
    return engine.run(steps)


@pytest.fixture(scope="module")
def repro_fused_streams(shared):
    cfg, params, _ = shared
    eng = JaxEngine(cfg, params, backend="codec-xla", fused=True, **KW)
    streams = _drive(eng)
    assert eng.fused and eng.stats["fused_calls"] == eng.stats["steps"]
    return streams


def test_fused_streams_match_repro_fused(shared, repro_fused_streams):
    cfg, _, model = shared
    eng = DecodeEngine(cfg, model, backend="codec-cuda", fused=True,
                       device="cpu", **KW)
    got = _drive(eng)
    assert got == repro_fused_streams
    assert all(len(t) == 6 for t in got.values())
    assert eng.stats["fused_calls"] == eng.stats["steps"]
    assert eng.plan_rebuilds >= 2


# --------------------------------------------------------------------- #
# bucket_plan and the padded CSR
# --------------------------------------------------------------------- #
FORESTS = {
    "two-level": lambda t: t.two_level(3, 5 * 16 + 3, 16 + 5, 16),
    "3-ary": lambda t: t.full_kary(3, 3, 2 * 16 - 4, 16),
    "single": lambda t: t.two_level(1, 40, 9, 16),
}


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_bucket_plan_equals_repro(name):
    ft, fj = FORESTS[name](tree), FORESTS[name](jtree)
    plan_mod.assign_dense_pages(ft)
    jplan.assign_dense_pages(fj)
    cm = cost_model.CostModel(8, 2, 16, page_size=16)
    B = len(ft.request_ids)
    bucket = plan_mod.bucket_pow2(B) * 2            # rows beyond the batch
    got = plan_mod.bucket_plan(plan_mod.build_plan(ft, cm, 4, 8, 32), bucket)
    want = jplan.bucket_plan(jplan.build_plan(fj, cm, 4, 8, 32), bucket)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "subtasks":
            assert [dataclasses.astuple(s) for s in a] == \
                [dataclasses.astuple(s) for s in b]
        else:
            assert a == b, f.name
    # the CSR the fused step uploads: built from repro's seg_ids, padded
    # to one entry per task slot, whatever the number of live slots
    arrs = ops.plan_host_arrays(got, padded=True)
    offsets, rows = arrs[-2:]
    seg = np.asarray(want.seg_ids)
    live = np.nonzero(seg < bucket)[0]
    assert rows.shape == (got.task_qnum.shape[0] * got.max_q,)
    assert offsets.shape == (bucket + 1,) and offsets[-1] == live.size
    np.testing.assert_array_equal(
        rows[:live.size], live[np.argsort(seg[live], kind="stable")])
    np.testing.assert_array_equal(np.diff(offsets),
                                  np.bincount(seg[live], minlength=bucket))
    assert (np.diff(offsets)[B:] == 0).all()        # padded rows: empty
    with pytest.raises(ValueError):
        plan_mod.bucket_plan(plan_mod.build_plan(ft, cm, 4, 8, 32), B - 1)


def test_epilogue_ignores_padded_csr_and_rows():
    """The plain epilogue over a bucketed plan (padded CSR, padded rows at
    ``q_pos = -1`` on the trash page) equals it over the unpadded plan on
    the live rows, and the padded rows come out finite (zero)."""
    f = tree.two_level(3, 40, 9, block_size=16)
    pages = plan_mod.assign_dense_pages(f)
    cm = cost_model.CostModel(8, 2, 16, page_size=16)
    plan = plan_mod.pad_plan(plan_mod.build_plan(f, cm, 4, 8, 32))
    bplan = plan_mod.bucket_plan(plan, 4)
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.standard_normal((pages + 1, 16, 2, 16))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((pages + 1, 16, 2, 16))
                         .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    tail_page = torch.tensor([0, 1, 2, pages])     # pages: the trash page
    tail_base = torch.tensor([0, 16, 32, 0])
    q_pos = torch.tensor([5, 20, 40, -1])

    def parts(p, n):
        pa = ops.upload(ops.PlanArrays, ops.plan_host_arrays(p, padded=True),
                        "cpu")
        return ops.codec_parts_arrays(q[:n], k, v, pa, impl="cuda")

    got = por_mod.por_epilogue(q, *parts(bplan, 4), k, v, tail_page,
                               tail_base, q_pos)
    want = por_mod.por_epilogue(q[:3], *parts(plan, 3), k, v, tail_page[:3],
                                tail_base[:3], q_pos[:3])
    torch.testing.assert_close(got[:3], want, rtol=0, atol=0)
    assert torch.equal(got[3], torch.zeros_like(got[3]))


class _Two(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_static_arrays_keep_their_address():
    a = [np.arange(6, dtype=np.int64).reshape(2, 3), np.zeros((), np.int64)]
    st = ops.StaticArrays(_Two, a, "cpu")
    ptr = st.arrays[0].data_ptr()
    st.load([a[0] + 10, np.ones((), np.int64)])
    assert st.arrays[0].data_ptr() == ptr
    assert st.arrays[0].tolist() == [[10, 11, 12], [13, 14, 15]]
    assert int(st.arrays[1]) == 1 and st.arrays[1].dim() == 0
    with pytest.raises(ValueError):
        st.load([np.zeros((3, 2), np.int64), np.zeros((), np.int64)])


# --------------------------------------------------------------------- #
# deferred tokens, signatures, release
# --------------------------------------------------------------------- #
def test_fused_defers_tokens_between_sync_points(shared):
    _, _, model = shared
    eng = _engine(model)
    rid = eng.add_request(DOC + [100], max_new=8)
    eng._attend = None          # the eager-only helper is never touched
    eng.step(); eng.step(); eng.step()
    req = eng.requests[rid]
    assert eng.stats["fused_calls"] == eng.stats["steps"] == 3
    assert req.pending is PENDING_DEVICE
    assert any(t < 0 for t in req.generated)      # placeholders
    leaf = eng.forest.nodes[eng.forest.leaf_of[rid]]
    assert (leaf.tokens < 0).any()
    flushes = eng.stats["token_flushes"]
    assert flushes < eng.stats["steps"]
    eng.flush_tokens()
    assert eng.stats["token_flushes"] == flushes + 1
    assert all(t >= 0 for t in req.generated) and (leaf.tokens >= 0).all()
    assert isinstance(req.pending, int)
    eng.flush_tokens()                            # nothing left: a no-op
    assert eng.stats["token_flushes"] == flushes + 1
    outs = eng.run(16)
    eager = _engine(model, fused=False)
    eager.add_request(DOC + [100], max_new=8)
    assert outs == eager.run(16)
    assert eng.stats["token_flushes"] < eng.stats["steps"]
    assert eng.stats["decode_dispatch_time"] > 0


def test_output_ring_wraps_without_losing_tokens(shared, eager_crossing):
    """A ring of two output slices: the engine flushes before a slice is
    reused, and the streams stay those of the eager engine."""
    _, _, model = shared
    eng = _engine(model)
    eng.fused_step.ring_size = 2
    got = _bucket_crossing_run(eng)
    assert got == eager_crossing("codec-cuda")
    assert eng.stats["token_flushes"] >= eng.stats["steps"] // 2


def test_output_slices_stay_contiguous_as_the_bucket_shrinks(
        shared, monkeypatch):
    """Each step's output slice is one contiguous block of the ring (a
    strided slice would make the card's copy to the host synchronous),
    also once completions shrink the bucket below the widest one seen."""
    from repro_torch.serving import step_fn
    _, _, model = shared
    seen = []
    call = step_fn.FusedStep.__call__

    def spy(self):
        host, event = call(self)
        seen.append((host.shape[1], host.is_contiguous(),
                     host.data_ptr() - self._ring.data_ptr()))
        return host, event
    monkeypatch.setattr(step_fn.FusedStep, "__call__", spy)

    def run(eng):               # 5 rows finish in turn: buckets 8, 4, 2
        for i, n in enumerate([2, 3, 3, 6, 9]):
            eng.add_request(DOC + [100 + i], max_new=n)
        return eng.run(16)
    outs = run(_engine(model))
    buckets = [b for b, _, _ in seen]
    assert buckets[0] == 8 and {4, 2} <= set(buckets)
    assert all(ok for _, ok, _ in seen)
    # every slice starts a ring row: a smaller bucket takes a row's front
    row = 2 * 8 * 8                 # bytes of a ring row: 2 x 8 int64
    assert all(off % row == 0 for _, _, off in seen)
    assert outs == run(_engine(model, fused=False))


def test_signatures_bounded_and_release_leak_free(shared):
    _, _, model = shared
    eng = _engine(model)
    _bucket_crossing_run(eng)
    sigs = eng.bucket_signatures
    # the three row buckets of the crossing, each with one step state;
    # two page crossings grow the plan's step/task/page buckets inside row
    # bucket 8 (``repro``'s fused engine gives the same five signatures
    # on this workload): more would mean a bucket no longer holds
    assert sorted({s[0] for s in sigs}) == [2, 4, 8]
    assert len(sigs) == 5
    assert eng.fused_cache_size == len(sigs) <= eng.stats["replans"]
    for rid in list(eng.requests):
        eng.release(rid)
    eng.forest.validate()
    eng.pool.allocator.check()
    assert eng.pool.num_free == eng.pool.num_pages


def test_arrivals_and_completions_inside_a_bucket_reuse_one_state(shared):
    """Four rows (bucket 4) lose one to completion, gain one arrival and
    lose one again: four plan epochs, one signature."""
    _, _, model = shared
    eng = _engine(model, page_size=16)
    doc = list(range(10, 58))
    for i, n in enumerate([3, 12, 12, 12]):
        eng.add_request(doc + [100 + i, 7], max_new=n)
    for _ in range(5):
        eng.step()
    eng.add_request(doc + [200, 7], max_new=4)
    outs = eng.run(32)
    assert eng.stats["replans"] >= 4
    assert len(eng.bucket_signatures) <= 3
    assert eng.fused_cache_size == len(eng.bucket_signatures) == 1
    eager = _engine(model, page_size=16, fused=False)
    for i, n in enumerate([3, 12, 12, 12]):
        eager.add_request(doc + [100 + i, 7], max_new=n)
    for _ in range(5):
        eager.step()
    eager.add_request(doc + [200, 7], max_new=4)
    assert outs == eager.run(32)


def test_serve_times_fused_and_eager_alike(shared):
    """``launch.serve.serve`` on the fused engine: the streams of the eager
    engine, TPOT from the host clock, graph captures accounted apart."""
    from repro_torch.launch.serve import serve
    cfg, _, model = shared
    prompts = [DOC + [100 + i] for i in range(3)]
    res = {}
    for fused in (False, True):
        eng = _engine(model, fused=fused)
        res[fused] = serve(eng, prompts, max_new=5)
        assert res[fused]["tpot_ms"] > 0 and res[fused]["steps"] == 5
        assert res[fused]["capture_s"] == 0.0       # no graph on the CPU
    assert res[True]["streams"] == res[False]["streams"]
