"""The port's training units (``repro_torch.training``) against
``repro.training`` on the same numpy inputs: the schedule, the norm and
clip, AdamW and Adafactor, the int8 compression, the data stream, both
cross-entropy forms and the checkpoint files."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro.training import optimizer as JO
from repro.training import trainer as JTr
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticLM as JSyntheticLM
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as O
from repro_torch.training import trainer as Tr
from repro_torch.training.data import DataConfig, SyntheticLM
from torch_threads import one_torch_thread  # noqa: F401

BF16 = jnp.bfloat16


def _tree(seed, dtype=np.float32):
    """0-d, 1-d, 2-d and 3-d leaves, nested one level."""
    rng = np.random.default_rng(seed)
    shapes = {"s": (), "b": (7,), "w": (6, 5), "e": (3, 4, 5)}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    tree["sub"] = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    return tree


def _as_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _as_torch(tree, dtype):
    return O._map(lambda a: torch.from_numpy(np.asarray(a, np.float32))
                  .to(dtype), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


def bf16_steps(got, want):
    """|got - want| in units of one bf16 step at |want|."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got - want) / step


def assert_tree_close(got, want, dtype, tol=1e-6):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (set(g), set(w))
    for k in w:
        a, b = _np(g[k]), _np(w[k])
        assert a.shape == b.shape, k
        if dtype == torch.bfloat16:
            assert bf16_steps(a, b).max() <= 1.0, k
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)


# --------------------------------------------------------------------- #
# schedule, norm, clip
# --------------------------------------------------------------------- #
def test_cosine_schedule_matches_repro_at_every_step():
    want_fn = JO.cosine_schedule(3e-4, warmup=10, total=100, min_ratio=0.1)
    got_fn = O.cosine_schedule(3e-4, warmup=10, total=100, min_ratio=0.1)
    steps = np.arange(111)
    want = np.asarray(jax.vmap(want_fn)(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(got_fn(torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    # every op is float32 as in repro; only cos may differ (XLA's
    # polynomial against libm, by one ulp), and near the end of the decay
    # 1 + cos cancels: allow one cos ulp, scaled by lr (1 - min_ratio) / 2
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=3e-4 * 0.45 * 2.0 ** -23)
    np.testing.assert_array_equal(got[:11], want[:11])     # the warmup
    assert got.dtype == np.float32 and got[0] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_repro(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (BF16, torch.bfloat16))
    tree = jax.tree.map(lambda a: 3 * a, _tree(0))
    jt, tt = _as_jax(tree, jdt), _as_torch(tree, tdt)
    np.testing.assert_allclose(float(O.global_norm(tt)),
                               float(JO.global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        want, wn = JO.clip_by_global_norm(jt, max_norm)
        got, gn = O.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        for leaf in O.leaves(got):
            assert leaf.dtype == tdt
        assert_tree_close(got, want, tdt)


# --------------------------------------------------------------------- #
# optimizers: three updates, state and updates compared after each
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_three_updates_match_repro(name, dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (BF16, torch.bfloat16))
    kw = {"weight_decay": 0.05} if name == "adafactor" else {}
    jopt = JO.make_optimizer(name, JO.cosine_schedule(1e-2, 2, 10), **kw)
    topt = O.make_optimizer(name, O.cosine_schedule(1e-2, 2, 10), **kw)
    params = _tree(1)
    jp, tp = _as_jax(params, jdt), _as_torch(params, tdt)
    js, ts = jopt.init(jp), topt.init(tp)
    assert_tree_close(ts, js, torch.float32)
    jupdate = jax.jit(jopt.update)
    for i in range(3):
        grads = _tree(10 + i)
        jg, tg = _as_jax(grads, jdt), _as_torch(grads, tdt)
        ju, js = jupdate(jg, js, jp)
        tu, ts = topt.update(tg, ts, tp)
        for leaf in O.leaves(tu):
            assert leaf.dtype == tdt
        assert_tree_close(tu, ju, tdt)
        # the moments are float32 at any weight dtype
        assert_tree_close(ts, js, torch.float32)
        jp = jax.tree.map(jnp.add, jp, ju)
        tp = O._map(torch.add, tp, tu)
        assert_tree_close(tp, jp, tdt)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_adafactor_slots_factor_two_or_more_dims():
    opt = O.adafactor(lambda s: torch.tensor(0.1))
    st = opt.init({"w": torch.zeros(64, 32), "e": torch.zeros(3, 4, 5),
                   "b": torch.zeros(7), "s": torch.zeros(())})
    assert st["slots"]["w"]["vr"].shape == (64,)
    assert st["slots"]["w"]["vc"].shape == (32,)
    assert st["slots"]["e"]["vr"].shape == (3, 4)
    assert st["slots"]["e"]["vc"].shape == (3, 5)
    assert st["slots"]["b"]["v"].shape == (7,)
    assert st["slots"]["s"]["v"].shape == ()


# --------------------------------------------------------------------- #
# int8 compression
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_compression_matches_repro(seed):
    rng = np.random.default_rng(seed)
    g = np.clip(rng.standard_normal(257), -3, 3).astype(np.float32)
    # max |g| = 127 / 16 makes the scale exactly 1/16, so two elements
    # land exactly on a .5: round half to even
    g[:3] = [127 / 16, 2.5 / 16, -3.5 / 16]
    err = (1e-3 * rng.standard_normal(257)).astype(np.float32)
    err[:3] = 0.0
    jq, js, je = JO.compress_int8(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = O.compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(float(ts) - float(js)) <= 1e-7 * abs(float(js))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-7)
    assert int(tq[1]) == 2 and int(tq[2]) == -4      # 2.5 -> 2, -3.5 -> -4
    np.testing.assert_allclose(O.decompress_int8(tq, ts).numpy(),
                               np.asarray(JO.decompress_int8(jq, js)),
                               rtol=1e-7, atol=0)


def test_int8_error_feedback_stays_within_a_step():
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(128)
                         .astype(np.float32))
    err, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(20):
        q, scale, err = O.compress_int8(g, err)
        total += O.decompress_int8(q, scale)
    resid = 20 * g - total
    assert float(resid.abs().max()) <= 2 * float(g.abs().max()) / 127 + 1e-5


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [1, 2, 4])
def test_synthetic_batches_are_byte_identical(world):
    cfg, jcfg = (DataConfig(vocab_size=777, seq_len=9, global_batch=8,
                            seed=5),
                 JDataConfig(vocab_size=777, seq_len=9, global_batch=8,
                             seed=5))
    for rank in range(world):
        got = SyntheticLM(cfg, dp_rank=rank, dp_world=world, start_step=2)
        want = JSyntheticLM(jcfg, dp_rank=rank, dp_world=world,
                            start_step=2)
        for step in (0, 3, 17):
            for a, b in zip(got.batch(step), want.batch(step)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert [x[0].tobytes() for x in (next(got), next(got))] == \
            [x[0].tobytes() for x in (next(want), next(want))]
        assert got.state_dict() == want.state_dict()
    full = SyntheticLM(cfg).batch(3)[0]
    np.testing.assert_array_equal(np.concatenate(
        [SyntheticLM(cfg, dp_rank=r, dp_world=world).batch(3)[0]
         for r in range(world)]), full)


# --------------------------------------------------------------------- #
# cross entropy
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_cross_entropy_matches_repro(impl):
    rng = np.random.default_rng(4)
    logits = (4 * rng.standard_normal((3, 11, 257))).astype(np.float32)
    labels = rng.integers(0, 257, (3, 11))
    want = float(JTr.CE_IMPLS[impl](jnp.asarray(logits),
                                    jnp.asarray(labels)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = Tr.CE_IMPLS[impl](lt, torch.from_numpy(labels))
    assert abs(float(got.detach()) - want) <= 1e-6 * abs(want)
    jg = jax.grad(lambda x: JTr.CE_IMPLS[impl](x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    got.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-8)
    other = Tr.CE_IMPLS["onehot" if impl == "gather" else "gather"](
        lt.detach(), torch.from_numpy(labels))
    assert abs(float(other) - float(got)) <= 1e-6 * abs(want)


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #
def _ck_tree(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn(16, 8, generator=g).to(dtype),
                      "b": torch.randn(8, generator=g).to(dtype)},
            "step": torch.tensor(5, dtype=torch.int32),
            "stack": [torch.randn(4, 4, generator=g).to(dtype)]}


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros_like(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip_is_bit_exact(tmp_path, dtype):
    tdt = getattr(torch, dtype)
    tree = _ck_tree(0, tdt)
    ckpt.save_checkpoint(str(tmp_path), 7, tree, num_shards=2)
    assert ckpt.latest_step(str(tmp_path)) == 7
    got, manifest = ckpt.load_checkpoint(str(tmp_path), 7,
                                         _zeros_like_tree(tree))
    assert manifest["step"] == 7
    assert manifest["arrays"]["layer/w"] == {"shape": [16, 8],
                                             "dtype": dtype, "sharded": True}
    assert manifest["arrays"]["step"]["sharded"] is False
    for a, b in zip(O.leaves(_flat_ck(got)), O.leaves(_flat_ck(tree))):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def _flat_ck(tree):
    return {"w": tree["layer"]["w"], "b": tree["layer"]["b"],
            "step": tree["step"], "s0": tree["stack"][0]}


def test_checkpoint_layout_matches_repro(tmp_path):
    """The same tree saved by both packages: the same files, keys, shard
    pieces and manifest entries."""
    tree = _ck_tree(1)
    jtree = {"layer": {"w": jnp.asarray(tree["layer"]["w"].numpy()),
                       "b": jnp.asarray(tree["layer"]["b"].numpy())},
             "step": jnp.asarray(5, jnp.int32),
             "stack": [jnp.asarray(tree["stack"][0].numpy())]}
    d1, d2 = str(tmp_path / "port"), str(tmp_path / "repro")
    ckpt.save_checkpoint(d1, 3, tree, num_shards=3)
    jckpt.save_checkpoint(d2, 3, jtree, num_shards=3)
    assert sorted(os.listdir(os.path.join(d1, "step_000003"))) == \
        sorted(os.listdir(os.path.join(d2, "step_000003")))
    m1, m2 = (json.load(open(os.path.join(d, "step_000003",
                                          "MANIFEST.json")))
              for d in (d1, d2))
    assert m1["arrays"] == m2["arrays"]
    for s in range(3):
        f1, f2 = (np.load(os.path.join(d, "step_000003",
                                       f"shard_{s:05d}.npz"))
                  for d in (d1, d2))
        assert sorted(f1.files) == sorted(f2.files)
        for k in f1.files:
            np.testing.assert_array_equal(f1[k], f2[k])
    # each package reads the other's files
    back, _ = ckpt.load_checkpoint(d2, 3, _zeros_like_tree(tree))
    assert torch.equal(back["layer"]["w"], tree["layer"]["w"])


def test_checkpoint_gc_latest_and_incomplete(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(d, s, _ck_tree(s), keep=3)
    assert ckpt.all_steps(d) == [3, 4, 5]
    os.makedirs(os.path.join(d, "step_000009"))      # no manifest
    assert ckpt.latest_step(d) == 5
    step, tree, _ = ckpt.load_latest(d, _zeros_like_tree(_ck_tree(0)))
    assert step == 5
    assert torch.equal(tree["stack"][0], _ck_tree(5)["stack"][0])
    assert ckpt.load_latest(str(tmp_path / "none"), _ck_tree(0)) is None


@pytest.mark.parametrize("num_shards", [2, 3, 4, 32])
def test_checkpoint_shard_reassembly_matches_single(tmp_path, num_shards):
    tree = _ck_tree(2, torch.bfloat16)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ckpt.save_checkpoint(d1, 1, tree, num_shards=1)
    ckpt.save_checkpoint(d2, 1, tree, num_shards=num_shards)
    r1, _ = ckpt.load_checkpoint(d1, 1, tree)
    r2, m2 = ckpt.load_checkpoint(d2, 1, tree)
    assert m2["arrays"]["layer/w"]["sharded"] == (num_shards <= 16)
    for a, b in zip(O.leaves(_flat_ck(r1)), O.leaves(_flat_ck(r2))):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
