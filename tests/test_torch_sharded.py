"""The mesh's host pieces, the cross-shard merge and the epilogue's mesh
options: the port against ``repro`` on the same inputs.

* the sharded allocator: ``tests/test_sharded.py``'s and
  ``tests/test_calibration.py``'s cases, run through both packages, must
  hand out the same page rows and keep the same affinity state;
* ``build_sharded_plan`` field by field on ``tests/test_sharded.py``'s
  forests (and with a replicated node), ``replicated_node_set``,
  ``split_at_shard_boundaries`` and ``divide_and_schedule_sharded``;
* the cost model's mesh terms (``merge_cost``, ``replicate_gain``,
  ``fit``, ``bound``) on ``tests/test_calibration.py``'s planted cases;
* ``naive_divide``, ``shared_ratio``, ``degenerate`` and
  ``mean_sharing_degree``;
* the merge: ``repro``'s ``por_allmerge`` and ``por_subgroup_merge`` run
  under ``shard_map`` in one subprocess with four host devices, for every
  contributor pattern at D = 2 and 4; the port's stacked versions on the
  same partials match at 1e-6, bitwise where one shard contributes;
* the mesh step's merge of one layer (``mesh_merge``, its plain version
  here): the same ``repro`` merges, placed at rows of a layer's
  ``(D, M, B, h, hd)`` partials through gather / scatter indices, give
  ``repro``'s shard-0 rows at 1e-6 with ``m`` bitwise, a lone
  contributor's rows bitwise; padded slots write nothing and rows that
  are not merged come out as shard 0's, cast; the step calls it once a
  layer and never the pairwise ``por``;
* the epilogue's tail-owner flag and float32 output against ``repro``'s
  sharded-step arithmetic (``combine_partials_stats``,
  ``single_page_attention``, the identity select, ``por_ref``), and its
  ``out_m`` / ``out_l``;
* the mesh's and the engine's guards, and the serve CLI on a 2x2 mesh.

Every cost model on both sides takes one explicit ``HardwareSpec`` (the
two packages' default priors differ on purpose: a TPU's against an
H100's).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm, plan as jplan, tree as jtree
from repro.core import scheduler as jsched
from repro.distributed.kv_pool import ShardedPageAllocator as JAllocator
from repro.kernels import ops as jops, ref as jref
from repro_torch.core import cost_model as cm, plan as plan_mod, tree
from repro_torch.core import scheduler
from repro_torch.distributed import (ShardedPageAllocator, decode_mesh,
                                     parse_mesh)
from repro_torch.kernels import ops, por as por_mod, registry
from torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
HW = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
          grid_step_overhead=1e-6, launch_overhead=5e-6)


def both_models(h_q=4, h_kv=2, d=16, page=8, **hw):
    """The same cost model in both packages, under one HardwareSpec."""
    spec = dict(HW, **hw)
    return (cm.CostModel(h_q, h_kv, d, page_size=page,
                         hw=cm.HardwareSpec(**spec)),
            jcm.CostModel(h_q, h_kv, d, page_size=page,
                          hw=jcm.HardwareSpec(**spec)))


# --------------------------------------------------------------------- #
# the sharded allocator
# --------------------------------------------------------------------- #
def _alloc_script(al):
    """tests/test_sharded.py:59-118 and tests/test_calibration.py:223-265
    as one sequence of operations; returns what each handed out."""
    out = []
    a = al(2, 8)
    rows = a.alloc(5, hint=7)
    a.retain(rows[:2])
    a.release(rows[:2])
    out += [rows, a.num_used, a.num_free]
    a.release(rows)
    out.append(a.num_free)
    for call in (lambda: a.release([rows[0]]),
                 lambda: a.release([a.pages_per_shard]),
                 lambda: a.alloc(17)):
        try:
            call()
            out.append("ok")
        except (ValueError, MemoryError) as e:
            out.append(type(e).__name__)
    a.check()
    a = al(2, 8, seq_split_pages=2)
    out += [a.alloc(6, hint=1), a.alloc(2, hint=2)]
    a = al(2, 4)
    out.append(a.alloc(6, hint=3))
    a = al(2, 64, seq_split_pages=4)
    out.append(a.alloc(2, hint=1))
    for h in range(10_000):
        a.release(a.alloc(1, hint=1000 + h))
    out += [a.alloc(2, hint=1), a.alloc(1, hint=1), len(a._affinity)]
    a = al(2, 8, seq_split_pages=2)
    rows = a.alloc(2, hint=5)
    out.append(list(a._affinity[5]))
    a.release(rows)
    out.append(list(a._affinity[5]))
    for h in range(9_000):
        a.release(a.alloc(1, hint=100_000 + h))
    out += [5 in a._affinity, len(a._affinity)]
    a = al(2, 8)
    taken = a.alloc(5)
    reps = a.alloc_replicas(3, hint=9)
    out.append(reps)
    try:
        a.alloc_replicas(4, hint=10)
    except MemoryError:
        out.append("MemoryError")
    out.append(a.num_free)
    for v in reps.values():
        a.release(v)
    a.release(taken)
    out += [a.num_free, a.used_page_ids(), a.shard_occupancy()]
    a.check()
    return out


def test_sharded_allocator_matches_repro():
    assert _alloc_script(ShardedPageAllocator) == _alloc_script(JAllocator)


def test_page_allocator_retain():
    from repro_torch.serving.kv_cache import PageAllocator
    a = PageAllocator(4)
    pages = a.alloc(2, hint=3)
    a.retain(pages)
    a.release(pages)
    assert a.num_used == 2
    a.release(pages)
    assert a.num_free == 4
    with pytest.raises(ValueError, match="retain"):
        a.retain([0])
    a.check()


# --------------------------------------------------------------------- #
# the sharded plan and schedule
# --------------------------------------------------------------------- #
def _forests(num_shards=2, quota=2, replicate=None):
    """tests/test_sharded.py:120-135's forest (a 6-page document shared by
    three requests), in both packages, its pages placed by each package's
    allocator; ``replicate`` names nodes copied onto every shard (by
    their position among the real nodes)."""
    ps = 8
    out = []
    for tmod, al in ((tree, ShardedPageAllocator), (jtree, JAllocator)):
        forest = tmod.PrefixForest(ps)
        doc = np.arange(100, 100 + 6 * ps, dtype=np.int32)
        for r in range(3):
            forest.insert_tokens(r, np.concatenate(
                [doc, np.asarray([200 + r, 201 + r], np.int32)]))
        a = al(num_shards, 32, seq_split_pages=quota)
        for i, node in enumerate(forest.real_nodes()):
            npages = -(-node.length // ps)
            if replicate and i in replicate:
                reps = a.alloc_replicas(npages, hint=node.id)
                node.meta["replicas"] = reps
                node.page_ids = list(reps[0])
            else:
                node.page_ids = a.alloc(npages, hint=node.id)
        out.append((forest, a))
    return out


def _same_plan(p, j):
    for f in dataclasses.fields(j):
        a, b = getattr(p, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "subtasks":
            assert [dataclasses.astuple(s)[:5] for s in a] == \
                [dataclasses.astuple(s)[:5] for s in b]
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12), f.name
        elif f.name == "lane_costs":
            assert a == pytest.approx(b, rel=1e-12)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("num_shards,quota,replicate,rows", [
    (2, 2, None, None), (1, 0, None, None), (4, 1, None, 8),
    (2, 2, {0, 1, 2, 3}, 4), (2, 2, {0}, None)])
def test_build_sharded_plan_matches_repro(num_shards, quota, replicate,
                                          rows):
    (pf, pa), (jf, ja) = _forests(num_shards, quota, replicate)
    pm, jm = both_models()
    sp = plan_mod.build_sharded_plan(pf, pm, num_shards, pa.stride,
                                     num_lanes=2, max_q=8, num_rows=rows)
    sj = jplan.build_sharded_plan(jf, jm, num_shards, ja.stride,
                                  num_lanes=2, max_q=8, num_rows=rows)
    assert len(sp.shards) == len(sj.shards) == num_shards
    for p, j in zip(sp.shards, sj.shards):
        _same_plan(p, j)
    assert sp.makespan == pytest.approx(sj.makespan, rel=1e-12)
    assert sp.merge_cost == pytest.approx(sj.merge_cost, rel=1e-12)
    assert sp.seq_splits == sj.seq_splits
    np.testing.assert_array_equal(sp.merge_rows, sj.merge_rows)
    np.testing.assert_array_equal(sp.row_shards, sj.row_shards)
    assert sp.replicated == sj.replicated
    assert sp.stats() == pytest.approx(sj.stats(), rel=1e-12)
    if num_shards > 1 and not replicate:
        assert sp.seq_splits >= 1
    if replicate == {0, 1, 2, 3}:
        assert sp.replicated and not sp.merge_rows.any()


def test_replicated_node_set_matches_repro():
    # a replicated document whose leaves are not: no row is fully
    # replicated, so the fixpoint drops the document
    for replicate in ({0}, {0, 1, 2, 3}, {1, 2, 3}):
        (pf, _), (jf, _) = _forests(2, 2, replicate)
        rows = {r: i for i, r in enumerate(sorted(pf.request_ids))}
        assert plan_mod.replicated_node_set(pf, 2, rows) == \
            jplan.replicated_node_set(jf, 2, rows)


def _same_subs(got, want):
    """Subtask lists equal: their slices exactly, their costs to 1e-12."""
    assert [dataclasses.astuple(s)[:5] for s in got] == \
        [dataclasses.astuple(s)[:5] for s in want]
    assert [s.cost for s in got] == pytest.approx([s.cost for s in want],
                                                  rel=1e-12)


def test_sharded_schedule_matches_repro():
    """tests/test_calibration.py:192-220's two schedules, and a subtask
    list cut at shard boundaries."""
    pm, jm = both_models()
    pages = {1: list(range(4)) + list(range(16, 20)),
             2: list(range(16, 18))}
    for kw in (dict(tasks=[(1, 4, 64)], num_queries=4),
               dict(tasks=[(1, 4, 64)], num_queries=4,
                    num_merge_queries=1),
               dict(tasks=[(1, 4, 32), (2, 4, 16)], num_queries=4,
                    replicated={2}, num_merge_queries=0)):
        tasks = kw.pop("tasks")
        got = scheduler.divide_and_schedule_sharded(
            [scheduler.TaskSpec(*t) for t in tasks], pm, 2, 2, 8,
            node_pages=lambda nid: pages[nid],
            shard_of_page=lambda g: g // 16, **kw)
        want = jsched.divide_and_schedule_sharded(
            [jsched.TaskSpec(*t) for t in tasks], jm, 2, 2, 8,
            node_pages=lambda nid: pages[nid],
            shard_of_page=lambda g: g // 16, **kw)
        assert got.seq_splits == want.seq_splits
        assert got.merge_cost == pytest.approx(want.merge_cost, rel=1e-12)
        assert got.makespan == pytest.approx(want.makespan, rel=1e-12)
        for g, w in zip(got.shards, want.shards):
            _same_subs(g.subtasks, w.subtasks)
            assert g.lane_of == w.lane_of
    subs = [(1, 0, 4, 0, 64, 1.0), (1, 0, 4, 8, 40, 1.0),
            (2, 1, 3, 0, 16, 1.0)]
    got = scheduler.split_at_shard_boundaries(
        [scheduler.SubTask(*s) for s in subs], lambda nid: pages[nid],
        lambda g: g // 16, 8, pm)
    want = jsched.split_at_shard_boundaries(
        [jsched.SubTask(*s) for s in subs], lambda nid: pages[nid],
        lambda g: g // 16, 8, jm)
    assert got[1] == want[1] == 1
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        _same_subs(g, w)


# --------------------------------------------------------------------- #
# the cost model's mesh terms, the figure helpers
# --------------------------------------------------------------------- #
def _planted(hw, rng):
    rows = []
    for _ in range(48):
        hbm = float(rng.uniform(1e6, 5e8))
        steps = float(rng.integers(4, 400))
        mb = float(rng.uniform(0, 2e6))
        mr = float(rng.integers(0, 12))
        secs = (hbm / hw["hbm_bw"] + steps * hw["grid_step_overhead"]
                + mb / hw["ici_bw"] + mr * hw["launch_overhead"])
        rows.append(dict(hbm_bytes=hbm, grid_steps=steps, merge_bytes=mb,
                         merge_rounds=mr, seconds=secs))
    return rows


def test_cost_model_mesh_terms_match_repro():
    pm, jm = both_models(8, 2, 64, 16)
    for splits in (1, 2, 3, 4, 8):
        for n_q in (0, 1, 16, 64):
            assert pm.merge_cost(splits, n_q) == jm.merge_cost(splits, n_q)
    for n_q, n, shards in ((8, 64, 4), (2, 65536, 4), (8, 64, 1),
                           (4, 4096, 2)):
        assert pm.replicate_gain(n_q, n, shards) == pytest.approx(
            jm.replicate_gain(n_q, n, shards), rel=1e-12)
        assert pm.bound(n_q, n) == jm.bound(n_q, n)
    assert pm.replicate_gain(8, 64, 4) > 0 > pm.replicate_gain(2, 65536, 4)
    # fit: planted coefficients, a column without variation, too few rows
    true = dict(HW, hbm_bw=123e9, ici_bw=7e9, grid_step_overhead=3e-6,
                launch_overhead=11e-6)
    flat = [dict(hbm_bytes=h, grid_steps=0.0, merge_bytes=0.0,
                 merge_rounds=0.0, seconds=h / 200e9)
            for h in np.random.default_rng(1).uniform(1e7, 4e8, 32)]
    for samples in (_planted(true, np.random.default_rng(0)), flat,
                    _planted(true, np.random.default_rng(2))[:5]):
        pm, jm = both_models(8, 2, 64, 16)
        assert pm.fit(samples) == jm.fit(samples)
        assert pm.calibrated == jm.calibrated
        assert dataclasses.asdict(pm.hw) == pytest.approx(
            dataclasses.asdict(jm.hw), rel=1e-9)
    pm, _ = both_models(8, 2, 64, 16)
    assert pm.fit(_planted(true, np.random.default_rng(0)))
    assert pm.hw.ici_bw == pytest.approx(7e9, rel=1e-3)
    assert pm.hw.launch_overhead == pytest.approx(11e-6, rel=1e-3)
    # the port's own prior: NVLink 4, marked uncalibrated
    assert cm.HardwareSpec().ici_bw == 450e9
    assert not cm.CostModel(8, 2, 64).calibrated


def test_naive_divide_and_tree_helpers_match_repro():
    pm, jm = both_models(8, 2, 64, 16)
    tasks = [(1, 4, 1000), (2, 1, 70), (3, 40, 512)]
    for k in (1, 3, 8):
        got = scheduler.naive_divide([scheduler.TaskSpec(*t) for t in tasks],
                                     k, pm, 16, max_q=32)
        want = jsched.naive_divide([jsched.TaskSpec(*t) for t in tasks], k,
                                   jm, 16, max_q=32)
        _same_subs(got, want)
    for args in ((4, 4096, 0.5), (8, 2048, 0.9), (2, 100, 0.0),
                 (16, 8192, 0.25)):
        f, g = tree.shared_ratio(*args), jtree.shared_ratio(*args)
        assert [(n.parent, n.length) for n in f.real_nodes()] == \
            [(n.parent, n.length) for n in g.real_nodes()]
    for depth, n in ((3, 64), (5, 100)):
        f, g = tree.degenerate(depth, n), jtree.degenerate(depth, n)
        assert f.leaf_of == g.leaf_of
        assert [(n.parent, n.length) for n in f.real_nodes()] == \
            [(n.parent, n.length) for n in g.real_nodes()]
        assert f.mean_sharing_degree() == g.mean_sharing_degree()
    for f, g in ((tree.full_kary(3, 3, 40), jtree.full_kary(3, 3, 40)),
                 (tree.two_level(4, 100, 9), jtree.two_level(4, 100, 9))):
        assert f.mean_sharing_degree() == g.mean_sharing_degree()


# --------------------------------------------------------------------- #
# the cross-shard merge against repro's, under shard_map
# --------------------------------------------------------------------- #
# the contributor patterns of a 32-shard axis (every pattern of 2 and 4):
# lone contributors, aligned blocks, the whole axis, pairs across block
# edges of every size, and three seeded subsets
_rng32 = np.random.default_rng(32)
MASKS_32 = ([[s] for s in (0, 5, 31)]
            + [list(range(a, b)) for a, b in ((0, 2), (4, 8), (16, 32),
                                              (0, 32))]
            + [[3, 4], [1, 30], [7, 8, 9], [15, 16]]
            + [sorted(_rng32.choice(32, n, replace=False).tolist())
               for n in (3, 11, 29)])
SHARD_AXES = (2, 4, 32)


def _n_patterns(D):
    return len(MASKS_32) if D == 32 else 2 ** D - 1


POR_MERGE = textwrap.dedent("""\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    import itertools
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.kernels import por
    from repro.kernels.ref import MASK_VALUE

    rng = np.random.default_rng(0)
    out = {}
    MASKS_32 = %r
    for D in %r:
        mesh = Mesh(np.asarray(jax.devices()[:D]), ("data",))
        spec = (P("data"),) * 3

        def sub(o, m, l, c, D=D):
            r = por.por_subgroup_merge(o[0], m[0], l[0], "data", D, c)
            return tuple(x[None] for x in r)

        def full(o, m, l, D=D):
            r = por.por_allmerge(o[0], m[0], l[0], "data", D)
            return tuple(x[None] for x in r)
        f_sub = jax.jit(shard_map(sub, mesh=mesh, in_specs=spec + (P(),),
                                  out_specs=spec, check_rep=False))
        f_full = jax.jit(shard_map(full, mesh=mesh, in_specs=spec,
                                   out_specs=spec, check_rep=False))
        if D == 32:
            masks = [tuple(s in ones for s in range(D)) for ones in MASKS_32]
        else:
            masks = list(itertools.product([False, True], repeat=D))
        for i, mask in enumerate(masks):
            if not any(mask):
                continue
            o = rng.standard_normal((D, 5, 2, 16)).astype(np.float32)
            m = (3.0 * rng.standard_normal((D, 5, 2))).astype(np.float32)
            l = rng.uniform(0.5, 4.0, (D, 5, 2)).astype(np.float32)
            for s in range(D):
                if not mask[s]:
                    o[s], m[s], l[s] = 0.0, MASK_VALUE, 0.0
            c = np.asarray(mask)
            args = [jnp.asarray(x) for x in (o, m, l)]
            key = f"{D}_{i}"
            for name, x in (("o", o), ("m", m), ("l", l), ("c", c)):
                out[f"{key}_{name}"] = x
            for name, r in (("sub", f_sub(*args, jnp.asarray(c))),
                            ("full", f_full(*args))):
                for part, x in zip("oml", r):
                    out[f"{key}_{name}_{part}"] = np.asarray(x)
    np.savez(sys.argv[1], **out)
    print("POR_MERGE_OK")
""") % (MASKS_32, SHARD_AXES)


@pytest.fixture(scope="module")
def repro_merges(tmp_path_factory):
    path = tmp_path_factory.mktemp("por") / "merges.npz"
    script = path.parent / "por_merge.py"
    script.write_text(POR_MERGE)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "POR_MERGE_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("D", SHARD_AXES)
def test_por_merges_match_repro(D, repro_merges):
    z = repro_merges
    keys = sorted({k.rsplit("_", 1)[0] for k in z
                   if k.startswith(f"{D}_") and k.endswith("_c")})
    assert len(keys) == _n_patterns(D)
    for key in keys:
        o, m, l, c = (z[f"{key}_{x}"] for x in "omlc")
        args = [torch.from_numpy(x) for x in (o, m, l)]
        got_sub = por_mod.por_subgroup_merge(*args, torch.from_numpy(c))
        got_full = por_mod.por_allmerge(*args)
        for name, got in (("sub", got_sub), ("full", got_full)):
            for part, g in zip("oml", got):
                w = z[f"{key}_{name}_{part}"]
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                           atol=1e-6, err_msg=(key, name))
        # the max-space statistic: the same bits as repro's
        np.testing.assert_array_equal(got_sub[1].numpy(), z[f"{key}_sub_m"])
        if c.sum() == 1:
            src = int(np.argmax(c))
            for g, x, part in zip(got_sub, (o, m, l), "oml"):
                for s in range(D):
                    np.testing.assert_array_equal(g[s].numpy(), x[src])
                np.testing.assert_array_equal(g.numpy(),
                                              z[f"{key}_sub_{part}"])


MERGE_ROWS = [6, 1, 4, 2, 5]      # the fixture's 5 rows, in a 7-row layer


def _layer(z, key, B=7, M=2, seed=0):
    """A layer's ``(D, M, B, h, hd)`` partials holding the fixture's rows
    of ``key`` at ``MERGE_ROWS`` (model shard 1 in reverse order), every
    other row random on every shard; gather / scatter padded to 8 as
    ``sharded_step_base`` pads them."""
    o, m, l = (z[f"{key}_{x}"] for x in "oml")
    D, _, h, hd = o.shape
    rng = np.random.default_rng(seed)
    O = rng.standard_normal((D, M, B, h, hd)).astype(np.float32)
    Mx = (3.0 * rng.standard_normal((D, M, B, h))).astype(np.float32)
    Lx = rng.uniform(0.5, 4.0, (D, M, B, h)).astype(np.float32)
    for X, x in ((O, o), (Mx, m), (Lx, l)):
        X[:, 0, MERGE_ROWS] = x
        X[:, 1, MERGE_ROWS] = x[:, ::-1]
    n = len(MERGE_ROWS)
    gather = np.array(MERGE_ROWS + [0] * (8 - n), np.int64)
    scatter = np.array(MERGE_ROWS + [B] * (8 - n), np.int64)
    c = z[f"{key}_c"].astype(np.int64)
    return [torch.from_numpy(x) for x in (O, Mx, Lx, gather, scatter, c)]


@pytest.mark.parametrize("D", SHARD_AXES)
def test_mesh_merge_matches_repro(D, repro_merges):
    """Every contributor pattern (at 32 shards, ``MASKS_32``): the merged
    rows are ``repro``'s shard-0 rows (1e-6, ``m`` and a lone contributor
    bitwise), the others shard 0's own, cast to f32 and bf16."""
    z = repro_merges
    keys = sorted({k.rsplit("_", 1)[0] for k in z
                   if k.startswith(f"{D}_") and k.endswith("_c")})
    assert len(keys) == _n_patterns(D)
    rest = [0, 3]
    for key in keys:
        args = _layer(z, key)
        o = args[0]
        want = [z[f"{key}_sub_{x}"][0] for x in "oml"]
        got = por_mod.mesh_merge(*args, torch.float32, stats=True)
        assert got[0].shape == o.shape[1:]
        for g, x in zip(got, args[:3]):
            assert torch.equal(g[:, rest], x[0][:, rest])
        for mi, order in ((0, slice(None)), (1, slice(None, None, -1))):
            for part, (g, w) in enumerate(zip(got, want)):
                w = np.ascontiguousarray(w[order])
                g = g[mi, MERGE_ROWS].numpy()
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg=(key, part))
                if part == 1:
                    np.testing.assert_array_equal(g, w)
        # the cast comes after the merge
        bf = por_mod.mesh_merge(*args, torch.bfloat16)
        assert bf.dtype == torch.bfloat16
        assert torch.equal(bf, got[0].to(torch.bfloat16))
        c = z[f"{key}_c"]
        if c.sum() == 1:
            src = int(np.argmax(c))
            for g, x in zip(got, args[:3]):
                assert torch.equal(g[:, MERGE_ROWS], x[src][:, MERGE_ROWS])


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mesh_merge_pads_and_leaves_other_rows(n, dtype):
    """``Bm < B`` with padded slots (from ``sharded_step_base``: gather 0,
    scatter B): row 0 and every row not merged is shard 0's, cast, though
    the padding gathers row 0; each merged row is shard 0's result of
    ``por_subgroup_merge`` over that row alone; ``Bm = 0`` merges
    nothing."""
    from repro_torch.distributed.step_fn import sharded_step_base
    D, M, B, h, hd = 4, 2, 8, 3, 16
    rng = np.random.default_rng(n)
    merge_rows = sorted(rng.choice(np.arange(1, B), n, replace=False)
                        .tolist())
    base = sharded_step_base([0] * B, [0] * B, np.zeros((D, B), np.int64),
                             [0] * B, [0] * B, np.ones((D, B), np.int64),
                             merge_rows, np.array([1, 0, 1, 1]), B, 0)
    gather, scatter, c = (torch.from_numpy(x) for x in base[7:10])
    assert gather.shape[0] == (0 if n == 0 else 1 << (n - 1).bit_length())
    o = torch.from_numpy(rng.standard_normal((D, M, B, h, hd)).astype(
        np.float32))
    m = torch.from_numpy((3 * rng.standard_normal((D, M, B, h))).astype(
        np.float32))
    l = torch.from_numpy(rng.uniform(0.5, 4, (D, M, B, h)).astype(
        np.float32))
    m[1], l[1], o[1] = -1e30, 0.0, 0.0      # shard 1 does not contribute
    got, gm, gl = por_mod.mesh_merge(o, m, l, gather, scatter, c, dtype,
                                     stats=True)
    keep = [r for r in range(B) if r not in merge_rows]
    assert 0 in keep
    assert torch.equal(got[:, keep], o[0][:, keep].to(dtype))
    assert torch.equal(gm[:, keep], m[0][:, keep])
    assert torch.equal(gl[:, keep], l[0][:, keep])
    for r in merge_rows:
        wo, wm, wl = por_mod.por_subgroup_merge(
            o[:, :, r:r + 1], m[:, :, r:r + 1], l[:, :, r:r + 1], c)
        assert torch.equal(got[:, r], wo[0][:, 0].to(dtype))
        assert torch.equal(gm[:, r], wm[0][:, 0])
        assert torch.equal(gl[:, r], wl[0][:, 0])
    if n:
        assert not torch.equal(got[:, merge_rows],
                               o[0][:, merge_rows].to(dtype))


def test_mesh_merge_guards():
    o = torch.zeros(3, 1, 2, 1, 64)
    ml = torch.zeros(3, 1, 2, 1)
    idx = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="power-of-two"):
        por_mod.mesh_merge(o, ml, ml, idx, idx, torch.ones(3),
                           torch.float32)
    with pytest.raises(ValueError, match="power-of-two"):
        por_mod.mesh_merge(*(torch.zeros((12,) + t.shape[1:])
                             for t in (o, ml, ml)), idx, idx,
                           torch.ones(12), torch.float32)
    with pytest.raises(ValueError, match="merge_scatter shape"):
        por_mod.mesh_merge(o[:2], ml[:2], ml[:2], idx,
                           torch.zeros(2, dtype=torch.int64), torch.ones(2),
                           torch.float32)
    with pytest.raises(ValueError, match="m shape"):
        por_mod.mesh_merge(o[:2], ml[:1], ml[:2], idx, idx, torch.ones(2),
                           torch.float32)


def test_mesh_step_merges_once_a_layer(monkeypatch):
    """The fused mesh step (its body runs eagerly on the CPU) calls
    ``mesh_merge`` once an attention layer on a 2x2 mesh whose document
    spans the data shards, and never the pairwise ``por``; its streams
    equal the 1x1 mesh's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine
    cfg = smoke_config("qwen2.5-14b")
    model = build_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    calls = {"merge": 0, "por": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(por_mod, "mesh_merge",
                        counted("merge", por_mod.mesh_merge))
    monkeypatch.setattr(por_mod, "por", counted("por", por_mod.por))

    def run(d, m):
        eng = DecodeEngine(cfg, model, device="cpu", mesh=decode_mesh(
            d, m, device="cpu"), fused=True, num_pages=64, page_size=8,
            max_q=8, seq_split_pages=2)
        doc = list(range(10, 58))
        rids = [eng.add_request(doc + [100 + i], max_new=4)
                for i in range(3)]
        eng.run(32)
        return eng, [list(eng.requests[r].generated) for r in rids]
    _, want = run(1, 1)
    assert calls == {"merge": 0, "por": 0}
    eng, got = run(2, 2)
    assert got == want
    layers = len(eng.attn_layer_idx)
    decode_steps = eng.stats["fused_calls"]
    assert decode_steps > 0 and calls["por"] == 0
    assert calls["merge"] == layers * decode_steps, (calls, decode_steps)


def test_exchange_is_the_xor_permutation():
    x = torch.arange(8 * 3).view(8, 3)
    for shift in (1, 2, 4):
        want = x[[i ^ shift for i in range(8)]]
        assert torch.equal(por_mod.exchange(x, shift), want)
    with pytest.raises(ValueError, match="power-of-two"):
        por_mod.por_allmerge(*(torch.zeros(3, 1, 1, 4),
                               torch.zeros(3, 1, 1), torch.zeros(3, 1, 1)))


# --------------------------------------------------------------------- #
# the epilogue's mesh options against repro's sharded-step arithmetic
# --------------------------------------------------------------------- #
HQ, HKV, D_HEAD = 4, 2, 16


@pytest.mark.parametrize("window", [0, 12])
def test_epilogue_owner_f32_matches_repro(window):
    page = 8
    forest = tree.two_level(5, 3 * page + 2, page + 5, block_size=page)
    pages = plan_mod.assign_dense_pages(forest)
    rows = sorted(forest.request_ids)
    truncate = {}
    tail = np.zeros((3, len(rows)), np.int64)
    for i, r in enumerate(rows):
        leaf = forest.nodes[forest.leaf_of[r]]
        tp = (leaf.length - 1) // page
        truncate[leaf.id] = tp * page
        tail[:, i] = (leaf.page_ids[tp], leaf.start_pos + tp * page,
                      forest.context_len(r) - 1)
    plan = plan_mod.pad_plan(plan_mod.build_plan(
        forest, cm.CostModel(HQ, HKV, D_HEAD, page_size=page), 2, 8,
        2 * page, window=window, truncate=truncate))
    rng = np.random.default_rng(7)
    k, v = (rng.standard_normal((pages, page, HKV, D_HEAD)).astype(
        np.float32) for _ in range(2))
    q = rng.standard_normal((len(rows), HQ, D_HEAD)).astype(np.float32)
    owner = np.array([1, 0, 0, 1, 0], np.int64)
    for qdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        qt = torch.from_numpy(q).to(qdt)
        pa = ops.plan_arrays(plan, "cpu")
        parts = ops.codec_parts_arrays(qt, torch.from_numpy(k),
                                       torch.from_numpy(v), pa, impl="cuda")
        got = por_mod.por_epilogue(
            qt, *parts, torch.from_numpy(k), torch.from_numpy(v),
            *map(torch.from_numpy, tail), window=window, stats=True,
            owner=torch.from_numpy(owner), o_f32=True)
        assert got[0].dtype == torch.float32
        # repro's sharded step: its shard's partials, the tail, the
        # identity where the shard does not own it, por_ref; no cast
        P = plan.task_qnum.shape[0] * plan.max_q
        dead = ~(np.arange(plan.max_q)[None, :]
                 < plan.task_qnum[:, None]).reshape(-1)
        o_p, m_p, l_p = (x.numpy().reshape((P,) + x.shape[1:]).copy()
                         for x in parts[:3])
        o_p[dead], m_p[dead], l_p[dead] = 0.0, jref.MASK_VALUE, 0.0
        T = plan.task_qnum.shape[0]
        o_f, m_f, l_f = jops.combine_partials_stats(
            jnp.asarray(o_p.reshape(T, plan.max_q, HQ, D_HEAD)),
            jnp.asarray(m_p.reshape(T, plan.max_q, HQ)),
            jnp.asarray(l_p.reshape(T, plan.max_q, HQ)),
            jnp.asarray(plan.seg_ids), plan.num_queries)
        tp, tb, qp = (jnp.asarray(x) for x in tail)
        jq = jnp.asarray(q, jdt)
        o_t, m_t, l_t = jops.single_page_attention(
            jq, jnp.asarray(k)[tp], jnp.asarray(v)[tp], tb, qp,
            window=window)
        own = jnp.asarray(owner.astype(bool))
        m_t = jnp.where(own[:, None], m_t, jref.MASK_VALUE)
        l_t = jnp.where(own[:, None], l_t, 0.0)
        o_t = jnp.where(own[:, None, None], o_t, 0.0)
        want = jref.por_ref(o_f, m_f, l_f, o_t, m_t, l_t)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


def test_epilogue_writes_out_m_and_out_l():
    """``por_epilogue(out_m=, out_l=)`` on the plain path writes the ``m``
    and ``l`` it computes into the given tensors, returns them with
    ``stats`` and leaves ``o`` as without them."""
    rng = np.random.default_rng(3)
    B, h, d, page, P = 3, HQ, D_HEAD, 8, 5

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    q, o_p, m_p = t(B, h, d), t(P, h, d), 3 * t(P, h)
    l_p = torch.from_numpy(rng.uniform(0.5, 4, (P, h)).astype(np.float32))
    k, v = t(4, page, HKV, d), t(4, page, HKV, d)
    seg = (torch.tensor([0, 2, 3, 5], dtype=torch.int32),
           torch.arange(5, dtype=torch.int32))
    tails = (torch.tensor([0, 2, 3]), torch.tensor([16, 24, 40]),
             torch.tensor([19, 24, 47]))
    owner = torch.tensor([1, 0, 1])
    args = (q, o_p, m_p, l_p, *seg, k, v, *tails)
    kw = dict(owner=owner, o_f32=True)
    want = por_mod.por_epilogue(*args, stats=True, **kw)
    om, ol = torch.full((2, B, h), float("nan")).unbind(0)
    got = por_mod.por_epilogue(*args, stats=True, out_m=om, out_l=ol, **kw)
    assert got[1] is om and got[2] is ol
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    om.fill_(float("nan"))
    ol.fill_(float("nan"))
    o = por_mod.por_epilogue(*args, out_m=om, out_l=ol, **kw)
    assert torch.equal(o, want[0])
    assert torch.equal(om, want[1]) and torch.equal(ol, want[2])
    with pytest.raises(ValueError, match="together"):
        por_mod.por_epilogue(*args, out_m=om, **kw)
    with pytest.raises(ValueError, match="out_l shape"):
        por_mod.por_epilogue(*args, out_m=om, out_l=ol[:2], **kw)


# --------------------------------------------------------------------- #
# guards, the registry, the serve CLI
# --------------------------------------------------------------------- #
def test_registry_shardable_flags():
    assert set(registry.names(shardable=True)) == {"codec-cuda",
                                                   "codec-torch"}
    for n in ("flash", "hydragen", "ref"):
        assert not registry.get(n).shardable
    for n in registry.names(shardable=True):
        assert registry.get(n).jit_safe


def test_parse_and_decode_mesh():
    assert parse_mesh("2x2") == (2, 2)
    assert parse_mesh("1X4") == (1, 4)
    for bad in ("2", "0x2", "ax1"):
        with pytest.raises(ValueError):
            parse_mesh(bad)
    with pytest.raises(ValueError, match="power of two"):
        decode_mesh(3, 1, device="cpu")
    mesh = decode_mesh(2, 1, device="cpu")
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.device == torch.device("cpu")
    assert decode_mesh(1, 1).device == torch.device("cuda")


def test_mesh_engine_guards():
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.speculation import SpecConfig
    cfg = smoke_config("qwen2.5-14b")
    model = build_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    mesh = decode_mesh(1, 1, device="cpu")

    def make(**kw):
        return DecodeEngine(cfg, model, device="cpu", **{
            "mesh": mesh, "fused": True, "num_pages": 64, **kw})
    with pytest.raises(ValueError, match="fused"):
        make(fused=False)
    for backend in ("hydragen", "flash", "ref"):
        with pytest.raises(ValueError, match="shardable"):
            make(backend=backend)
    with pytest.raises(ValueError, match="power of two"):
        make(mesh=dataclasses.replace(mesh, data=3))
    with pytest.raises(ValueError, match="divide heads"):
        make(mesh=decode_mesh(1, 3, device="cpu"))
    with pytest.raises(ValueError, match="nan_guard"):
        make(nan_guard=True)
    with pytest.raises(ValueError, match="sharded speculation"):
        make(speculative=SpecConfig())
    with pytest.raises(ValueError, match="mesh on"):
        make(mesh=decode_mesh(1, 1, device="cuda"))
    with pytest.raises(ValueError, match="multiple of the data axis"):
        make(mesh=decode_mesh(4, 1, device="cpu"), num_pages=66)
    eng = make(mesh=decode_mesh(2, 2, device="cpu"), replicate=True)
    assert eng.replicate and eng.pool.num_shards == 2
    assert not make(replicate=True).replicate      # one data shard
    with pytest.raises(TypeError, match="shard_pools"):
        eng.pool.layer_pools(0)


def test_serve_cli_on_a_2x2_mesh(monkeypatch, capsys):
    """``serve --mesh 2x2 --replicate --calibrate --device cpu`` (at the
    smoke widths), then ``--compare`` on the mesh: codec-cuda against
    codec-torch."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as serve_mod
    monkeypatch.setattr(serve_mod, "get_config",
                        lambda arch: smoke_config(arch))
    argv = ["--device", "cpu", "--requests", "3", "--doc-len", "48",
            "--q-len", "4", "--max-new", "5", "--page-size", "8",
            "--max-pages", "64", "--num-lanes", "2", "--no-telemetry",
            "--mesh", "2x2", "--seq-split-pages", "2"]
    assert serve_mod.main(argv + ["--replicate", "--calibrate"]) == 0
    out = capsys.readouterr().out
    assert "mesh 2x2: shard occupancy" in out
    assert "seq-split nodes" in out and "replica promotions" in out
    assert '"tokens": {"0": 5, "1": 5, "2": 5}' in out
    assert serve_mod.main(argv + ["--compare"]) == 0
    assert "outputs codec == codec-torch: True" in capsys.readouterr().out


def test_distributed_modules_stand_alone():
    """``distributed/`` imports with ``jax`` and ``repro`` unimportable
    (``test_torch_imports.py`` walks every module of the port; this names
    the mesh's)."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "for m in ('mesh', 'kv_pool', 'step_fn'):\n"
        "    importlib.import_module('repro_torch.distributed.' + m)\n"
        "import repro_torch.distributed as d\n"
        "print(d.decode_mesh(2, 2, device='cpu').shape)\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "{'data': 2, 'model': 2}"
