"""The port's baseline backends (``flash``, ``hydragen``), ``flash_plan``
and the forest's IO counters against the JAX package, and every port
backend against the dense oracle.

Inputs are made with numpy from a seed.  Plans are compared field by field
with the same cost model handed to both packages, so what is held is the
plan function, not the hardware priors.  Tolerances: 1e-5 against
``repro`` (float32, summation order), 1e-4 against the dense oracle (as
``tests/test_registry.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dense_from_pool
from repro.core import plan as jplan, tree as jtree
from repro.kernels import hydragen as jhydragen
from repro_torch.core import cost_model, plan as plan_mod, tree
from repro_torch.kernels import hydragen, ops, ref, registry

PAGE = 16
BACKENDS = registry.names()

FORESTS = {
    "two-level": lambda t: t.two_level(4, 5 * PAGE + 3, PAGE + 5, PAGE),
    "3-ary": lambda t: t.full_kary(3, 3, 2 * PAGE - 4, PAGE),
}


def _pool(forest, n_kv, d, seed):
    pages = plan_mod.assign_dense_pages(forest)
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((pages, PAGE, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((pages, PAGE, n_kv, d)).astype(np.float32)
    return k, v


def _queries(forest, hq, d, seed):
    B = len(forest.request_ids)
    return np.random.default_rng(seed).standard_normal((B, hq, d)).astype(
        np.float32)


def _engine_kw(forest, window):
    """The keywords the engine passes: rows, window and each leaf's tail
    page truncated out."""
    rows = forest.request_ids[::-1]            # rows not in id order
    truncate = {}
    for r in rows:
        leaf = forest.nodes[forest.leaf_of[r]]
        truncate[leaf.id] = max(0, ((leaf.length - 1) // PAGE) * PAGE)
    return dict(req_rows={r: i for i, r in enumerate(rows)}, window=window,
                truncate=truncate)


# --------------------------------------------------------------------- #
# flash_plan and the IO counters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("engine_kw", [False, True])
@pytest.mark.parametrize("name", sorted(FORESTS))
def test_flash_plan_equals_repro(name, engine_kw):
    ft, fj = FORESTS[name](tree), FORESTS[name](jtree)
    plan_mod.assign_dense_pages(ft)
    jplan.assign_dense_pages(fj)
    cm = cost_model.CostModel(8, 2, 16, page_size=PAGE)
    kw = _engine_kw(ft, window=24 if engine_kw else 0) if engine_kw else {}
    args = (cm, 4, 8, 2 * PAGE)            # lanes, max_q, max_kv_per_task
    got = plan_mod.flash_plan(ft, *args, **kw)
    want = jplan.flash_plan(fj, *args, **kw)
    assert int(got.task_qnum[:got.num_tasks].max()) == 1
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "subtasks":
            assert [dataclasses.astuple(s) for s in a] == \
                [dataclasses.astuple(s) for s in b]
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_io_bytes_equal_repro(name):
    ft, fj = FORESTS[name](tree), FORESTS[name](jtree)
    assert ft.total_tokens() == fj.total_tokens()
    assert ft.total_context() == fj.total_context()
    for esize in (2, 4):
        assert ft.codec_io_bytes(8, 128, esize) == \
            fj.codec_io_bytes(8, 128, esize)
        assert ft.flash_io_bytes(8, 128, esize) == \
            fj.flash_io_bytes(8, 128, esize)
    assert ft.codec_io_bytes(8, 128) == fj.codec_io_bytes(8, 128)
    # sharing makes CoDec's read strictly smaller
    assert ft.codec_io_bytes(8, 128) < ft.flash_io_bytes(8, 128)


# --------------------------------------------------------------------- #
# hydragen against repro's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("name", sorted(FORESTS))
def test_hydragen_partials_match_repro(name, window):
    f = FORESTS[name](tree)
    hq, hkv, d = 8, 2, 16
    k, v = _pool(f, hkv, d, seed=3 + window)
    q = _queries(f, hq, d, seed=4 + window)
    p = plan_mod.build_plan(f, cost_model.CostModel(hq, hkv, d,
                                                    page_size=PAGE),
                            num_lanes=2, max_q=8, window=window,
                            **({} if not window else
                               {"truncate": _engine_kw(f, 0)["truncate"]}))
    ha = hydragen.prepare(p, "cpu")
    # unwindowed both phases run; the window prunes the 3-ary forest's
    # shared nodes away, which leaves the prefix phase empty (skipped)
    assert ha.sf_pages.shape[0] >= 1
    assert (ha.px_pages.shape[0] >= 1) == (not window or name != "3-ary")
    got = hydragen.hydragen_partials(
        *map(torch.from_numpy, (q, k, v)), p, ha, window)
    want = jhydragen.hydragen_partials(*map(jnp.asarray, (q, k, v)), p,
                                       window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    out = hydragen.hydragen_attention(*map(torch.from_numpy, (q, k, v)), p,
                                      window=window, prepared=ha)
    np.testing.assert_array_equal(out.numpy(), got[0].numpy())
    # advance moves every query position, as repro's does
    ha2 = hydragen.advance(ha, 3)
    jha2 = jhydragen.advance(jhydragen.prepare(p), 3)
    np.testing.assert_array_equal(ha2.px_qpos.numpy(),
                                  np.asarray(jha2.px_qpos))
    np.testing.assert_array_equal(ha2.sf_qpos.numpy(),
                                  np.asarray(jha2.sf_qpos))


def test_hydragen_zero_task_plan_is_all_trash():
    """A plan with no task at all (every row's KV is in its tail page)
    gives every query the empty partial."""
    f = tree.two_level(2, 0, 5, PAGE)
    plan_mod.assign_dense_pages(f)
    leaves = {f.leaf_of[r]: 0 for r in f.request_ids}
    p = plan_mod.build_plan(f, cost_model.CostModel(4, 2, 16,
                                                    page_size=PAGE),
                            num_lanes=2, max_q=4, truncate=leaves)
    assert p.num_tasks == 0
    q = torch.randn(2, 4, 16)
    pool = torch.zeros(2, PAGE, 2, 16)
    o, m, l = hydragen.hydragen_partials(q, pool, pool, p)
    assert (o == 0).all() and (l == 0).all()
    assert (m == ref.MASK_VALUE).all()


# --------------------------------------------------------------------- #
# every port backend against the dense oracle
# --------------------------------------------------------------------- #
def test_registry_has_five_backends():
    assert BACKENDS == sorted(["codec-cuda", "codec-torch", "flash",
                               "hydragen", "ref"])
    for name in BACKENDS:
        be = registry.get(name)
        assert be.needs_plan and be.supports_gqa and be.supports_window
    assert registry.get("flash").plan_kind == "flash"
    assert registry.get("hydragen").plan_kind == "codec"
    assert registry.get("hydragen").prepare is hydragen.prepare
    assert registry.get("flash").jit_safe and registry.get("hydragen").jit_safe


CASES = {
    # name: (forest, hq, hkv, max_q, window)
    "shared": (lambda: tree.two_level(4, 4 * PAGE, PAGE + 5, PAGE),
               4, 2, 8, 0),
    "gqa-8/2": (lambda: tree.full_kary(3, 2, 2 * PAGE, PAGE), 8, 2, 8, 0),
    "gqa-6/1": (lambda: tree.full_kary(3, 2, 2 * PAGE, PAGE), 6, 1, 8, 0),
    "window": (lambda: tree.two_level(3, 4 * PAGE, 2 * PAGE, PAGE),
               4, 2, 4, 24),
    "single": (lambda: tree.two_level(1, 2 * PAGE, 7, PAGE), 4, 2, 4, 0),
}


def _build(backend, forest, cm, max_q, **kw):
    build = (plan_mod.flash_plan if registry.get(backend).plan_kind ==
             "flash" else plan_mod.build_plan)
    return build(forest, cm, num_lanes=2, max_q=max_q,
                 max_kv_per_task=2 * PAGE, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_dense_oracle(backend, case):
    make, hq, hkv, max_q, window = CASES[case]
    f = make()
    d = 16
    k, v = _pool(f, hkv, d, seed=hq + window)
    q = _queries(f, hq, d, seed=hq + 1)
    cm = cost_model.CostModel(hq, hkv, d, page_size=PAGE)
    p = _build(backend, f, cm, max_q, window=window)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = registry.get(backend)(qt, kt, vt, p, window=window)
    kd, vd, lens = dense_from_pool(f, k, v)
    want = ref.decode_attention_ref(qt, torch.from_numpy(kd),
                                    torch.from_numpy(vd),
                                    torch.from_numpy(lens), window=window)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_partials_por_merge_with_tail(backend):
    """Frozen-plan partials POR-merged with the tail page == full
    attention (the engine's decomposition), on the engine's plan kind."""
    f = tree.two_level(3, 2 * PAGE, 2 * PAGE, PAGE)
    hq, hkv, d = 4, 2, 16
    k, v = _pool(f, hkv, d, seed=11)
    q = _queries(f, hq, d, seed=12)
    kw = _engine_kw(f, 0)
    rows = sorted(kw["req_rows"], key=kw["req_rows"].get)
    p = _build(backend, f, cost_model.CostModel(hq, hkv, d, page_size=PAGE),
               8, **kw)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    q_rows = qt[torch.as_tensor(rows)]        # row i is request rows[i]
    o_f, m_f, l_f = registry.get(backend).partials(q_rows, kt, vt, p)
    tails = [f.nodes[f.leaf_of[r]] for r in rows]
    tp = torch.as_tensor([leaf.page_ids[(leaf.length - 1) // PAGE]
                          for leaf in tails])
    tb = torch.as_tensor([leaf.start_pos + kw["truncate"][leaf.id]
                          for leaf in tails])
    qp = torch.as_tensor([f.context_len(r) - 1 for r in rows])
    o_t, m_t, l_t = ops.single_page_attention(q_rows, kt[tp], vt[tp], tb, qp)
    o, _, _ = ref.por_ref(o_f, m_f, l_f, o_t, m_t, l_t)
    kd, vd, lens = dense_from_pool(f, k, v)
    want = ref.decode_attention_ref(qt, *map(torch.from_numpy,
                                             (kd, vd, lens)))
    np.testing.assert_allclose(o.numpy(), want[torch.as_tensor(rows)].numpy(),
                               rtol=1e-4, atol=1e-4)
