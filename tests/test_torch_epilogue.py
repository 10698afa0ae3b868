"""The port's decode-attention epilogue (``por.por_epilogue``) against the
JAX package's composition of the same steps.

On the CPU the wrapper takes its plain version.  ``repro``'s side is the
engine's epilogue as it stands there: the dead-slot select of
``codec_partials_arrays``, ``ops.combine_partials_stats``,
``ops.single_page_attention`` over the gathered tail pages and the Pallas
``por`` kernel in interpret mode, then the cast.  Both take the same
numpy inputs: PAC partials of an engine-shaped plan (every leaf cut to its
full pages, each request's last page as its tail), with NaN written into
every dead task slot.  The CUDA kernel is held against the plain version
on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import por as jpor
from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import ops, pac as pac_mod, por as por_mod, ref

HQ, HKV, D = 4, 2, 16


def _forest(case, page):
    """The two-level shared document, a prompt every request shares whole
    (one leaf, one tail page for all), a request that lives in its tail
    page alone (an empty segment), a plan with no task at all, and a
    two-level forest under a window of 24."""
    if case == "two-level":
        return tree.two_level(3, 2 * page + 5, page + 3, block_size=page)
    if case == "window24":
        return tree.two_level(3, 4 * page, 2 * page, block_size=page)
    f = tree.PrefixForest(page)
    if case == "fully-shared":
        doc = f.add_node(tree.ROOT_ID, 2 * page + 7)
        for r in range(3):
            f.attach_request(r, doc.id)
    elif case == "tail-only":
        doc = f.add_node(tree.ROOT_ID, 2 * page)
        for r in range(2):
            f.attach_request(r, f.add_node(doc.id, page + 4).id)
        f.attach_request(2, f.add_node(tree.ROOT_ID, 5).id)
    elif case == "zero-task":
        for r in range(3):
            f.attach_request(r, f.add_node(tree.ROOT_ID, 3 + r).id)
    return f


def engine_state(forest, window=0, flash=False, lanes=2, max_q=8, hq=HQ,
                 hkv=HKV):
    """The plan and tail arrays the engine would build for this forest:
    each leaf cut to its full pages, its last (partial) page the tail."""
    ps = forest.block_size
    pages = plan_mod.assign_dense_pages(forest)
    rows = sorted(forest.request_ids)
    truncate = {}
    tail = np.zeros((3, len(rows)), np.int64)
    for i, r in enumerate(rows):
        leaf = forest.nodes[forest.leaf_of[r]]
        tp = (leaf.length - 1) // ps
        truncate[leaf.id] = tp * ps
        tail[:, i] = (leaf.page_ids[tp], leaf.start_pos + tp * ps,
                      forest.context_len(r) - 1)
    make = plan_mod.flash_plan if flash else plan_mod.build_plan
    plan = plan_mod.pad_plan(make(
        forest, cost_model.CostModel(hq, hkv, D, page_size=ps), lanes,
        max_q, 2 * ps, req_rows={r: i for i, r in enumerate(rows)},
        window=window, truncate=truncate))
    return plan, pages, tail


def _inputs(case, page, seed=0, hq=HQ, hkv=HKV):
    forest = _forest(case, page)
    window = 24 if case == "window24" else 0
    plan, pages, tail = engine_state(forest, window, hq=hq, hkv=hkv)
    rng = np.random.default_rng(seed + page)
    k, v = (rng.standard_normal((pages, page, hkv, D)).astype(np.float32)
            for _ in range(2))
    q = rng.standard_normal((plan.num_queries, hq, D)).astype(np.float32)
    return plan, window, q, k, v, tail


def _dead(plan):
    return ~(np.arange(plan.max_q)[None, :] < plan.task_qnum[:, None])


def _repro_epilogue(q, o, m, l, plan, k, v, tail, window, jdt):
    """``repro``'s engine epilogue on task-major partials."""
    live = jnp.asarray(~_dead(plan))
    m = jnp.where(live[..., None], m, ref.MASK_VALUE)
    l = jnp.where(live[..., None], l, 0.0)
    o = jnp.where(live[..., None, None], o, 0.0)
    o_f, m_f, l_f = jops.combine_partials_stats(
        o, m, l, jnp.asarray(plan.seg_ids), plan.num_queries)
    jq = jnp.asarray(q, jdt)
    tp, tb, qp = (jnp.asarray(x) for x in tail)
    o_t, m_t, l_t = jops.single_page_attention(
        jq, jnp.asarray(k, jdt)[tp], jnp.asarray(v, jdt)[tp], tb, qp,
        window=window)
    o, m, l = jpor.por(o_f, m_f, l_f, o_t, m_t, l_t, interpret=True)
    return o.astype(jdt), m, l


CASES = ("two-level", "fully-shared", "tail-only", "zero-task", "window24")


def _check_epilogue(case, page, bf16, hq=HQ, hkv=HKV):
    plan, window, q, k, v, tail = _inputs(case, page, hq=hq, hkv=hkv)
    if case == "zero-task":
        assert plan.num_tasks == 0
    if case == "tail-only":
        seg = np.asarray(plan.seg_ids)
        assert not (seg == 2).any(), "request 2 should have no task"
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    pa = ops.plan_arrays(plan, "cpu")
    o, m, l = (x.numpy().copy() for x in
               pac_mod.pac(qt, pa, kt, vt, window=window))
    dead = _dead(plan)
    o[dead], m[dead], l[dead] = np.nan, np.nan, np.nan
    P = o.shape[0] * o.shape[1]
    parts = ops.Parts(torch.from_numpy(o).reshape(P, hq, D),
                      torch.from_numpy(m).reshape(P, hq),
                      torch.from_numpy(l).reshape(P, hq),
                      pa.seg_offsets, pa.seg_rows)
    got = por_mod.por_epilogue(qt, *parts, kt, vt,
                               *map(torch.from_numpy, tail), window=window,
                               stats=True)
    want = _repro_epilogue(q, o, m, l, plan, k, v, tail, window, jdt)
    assert got[0].dtype == tdt
    # bf16 KV: the tolerance tests/test_kernels.py holds bf16 to
    tol = 3e-2 if bf16 else 1e-5
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


# pages the CUDA kernel takes beyond 16 and 64: partial 32-token rounds (8,
# 24), one whole round (32), and 128 (f32 KV at d 256 staged 64 tokens at
# a time on the card)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("page", [16, 64, 8, 24, 32, 128])
@pytest.mark.parametrize("case", CASES)
def test_epilogue_matches_repro(case, page, bf16):
    _check_epilogue(case, page, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("case", ["two-level", "window24"])
def test_epilogue_group_32_matches_repro(case, page, bf16):
    """32 query heads over one KV head (fig13's MQA end): the kernel's
    warps take four heads each in turn."""
    _check_epilogue(case, page, bf16, hq=32, hkv=1)


@pytest.mark.parametrize("case", ["two-level", "tail-only", "kary",
                                  "padding"])
@pytest.mark.parametrize("flash", [False, True], ids=["codec", "flash"])
def test_plan_csr_lists_every_live_slot_once(case, flash):
    """``seg_rows`` lists every live task slot exactly once, under its own
    query and in ascending order, and no dead slot or trash row."""
    if case == "kary":
        forest = tree.full_kary(3, 2, 40, block_size=16)
    elif case == "padding":   # more queries than a task holds, pad tasks
        forest = tree.two_level(11, 100, 20, block_size=16)
    else:
        forest = _forest(case, 16)
    plan, _, _ = engine_state(forest, flash=flash, max_q=4)
    offsets, rows = ops.plan_csr(plan)
    pa = ops.plan_arrays(plan, "cpu")
    assert pa.seg_offsets.tolist() == offsets.tolist()
    assert pa.seg_rows.tolist() == rows.tolist()
    seg = np.asarray(plan.seg_ids)
    live = ~_dead(plan).ravel()
    assert sorted(rows.tolist()) == np.nonzero(live)[0].tolist()
    assert offsets[0] == 0 and offsets[-1] == len(rows)
    for b in range(plan.num_queries):
        mine = rows[offsets[b]:offsets[b + 1]]
        assert (seg[mine] == b).all()
        assert (np.diff(mine) > 0).all()
    assert (seg[~live] == plan.num_queries).all()


def test_codec_partials_are_parts_plus_plain_combine():
    """``codec_partials_arrays`` is the raw parts reduced by
    ``combine_parts``, and its NaN-free result equals ``repro``'s."""
    plan, window, q, k, v, _ = _inputs("two-level", 16, seed=3)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    pa = ops.plan_arrays(plan, "cpu")
    got = ops.codec_partials_arrays(qt, kt, vt, pa, plan.num_queries)
    again = ops.combine_parts(ops.codec_parts_arrays(qt, kt, vt, pa))
    want = jops.codec_partials_arrays(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jops.plan_arrays(plan),
        plan.num_queries, impl="pallas")
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="queries"):
        ops.codec_partials_arrays(qt, kt, vt, pa, plan.num_queries + 1)


def test_identity_parts_reduce_to_themselves():
    """One part a query (hydragen, ref): the plain reduction hands each
    query's statistics back to within rounding, an empty one exactly."""
    rng = np.random.default_rng(4)
    o = torch.from_numpy(rng.standard_normal((3, HQ, D)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((3, HQ)).astype(np.float32))
    l = torch.from_numpy(rng.random((3, HQ)).astype(np.float32) + 0.5)
    o[2], m[2], l[2] = 0.0, ref.MASK_VALUE, 0.0
    parts = ops.identity_parts(o, m, l)
    assert parts.seg_offsets.tolist() == [0, 1, 2, 3]
    assert parts.seg_rows.tolist() == [0, 1, 2]
    got = ops.combine_parts(parts)
    for g, w in zip(got, (o, m, l)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    assert (got[0][2] == 0).all() and (got[2][2] == 0).all()


def test_epilogue_refuses_what_it_cannot_take():
    """No silent fallback: a device without a kernel raises, and so do
    shapes that do not fit together, on every device."""
    plan, window, q, k, v, tail = _inputs("two-level", 16)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    pa = ops.plan_arrays(plan, "cpu")
    parts = ops.codec_parts_arrays(qt, kt, vt, pa)
    tail_t = list(map(torch.from_numpy, tail))
    with pytest.raises(ValueError, match="seg_offsets"):
        por_mod.por_epilogue(qt, *parts[:3], parts.seg_offsets[:-1],
                             parts.seg_rows, kt, vt, *tail_t)
    with pytest.raises(ValueError, match="m_parts"):
        por_mod.por_epilogue(qt, parts.o, parts.m[1:], *parts[2:], kt, vt,
                             *tail_t)
    with pytest.raises(ValueError, match="pool"):
        por_mod.por_epilogue(qt, *parts, kt[..., :8], vt[..., :8], *tail_t)
    meta = [x.to("meta") for x in (qt, *parts, kt, vt, *tail_t)]
    with pytest.raises(ValueError, match="no kernel"):
        por_mod.por_epilogue(*meta)
