"""The port's launch layer (``repro_torch.launch.{mesh,sharding,specs,
op_stats,dryrun}``) against ``repro.launch``.

Specs: every parameter of every config on both production meshes, the
batch, cache and pool specs and the optimizer's slots equal ``repro``'s
(its meshes built abstract, with no device).  Bytes: shard shapes and
argument bytes equal a numpy reckoning from ``repro``'s specs.  FLOPs:
``count_flops`` is affine in the period count and counts each product as
2 M N K.  Records: ``run_cell`` keeps ``repro``'s keys, with
collectives, a per-device total and a fit on every mesh (the partition
itself: ``test_torch_partition.py``).
"""

import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import (ASSIGNED_ARCHS, PAPER_ARCH, get_config,
                           skip_reason)
from repro.launch import hlo_stats
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro.training import trainer as jtrainer

from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun, op_stats
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as TT
from repro_torch.training import trainer as ttrainer

from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ASSIGNED_ARCHS + [PAPER_ARCH]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def jmesh(multi_pod):
    return AbstractMesh(*MESHES[multi_pod])


def tmesh_of(multi_pod):
    return tmesh.make_production_mesh(multi_pod=multi_pod)


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


_STATES = {}


def jstate(arch):
    """``repro``'s abstract train state (its params and optimizer slots)
    for the arch's full config, and the optimizer's kind."""
    if arch not in _STATES:
        cfg = get_config(arch)
        opt, kind = jspecs.make_optimizer_for(arch, cfg)
        _STATES[arch] = (jtrainer.abstract_state(cfg, opt), kind)
    return _STATES[arch]


def port_to_repro(arch, tree):
    """Port state-dict name -> (``repro`` path, stacked?), through
    ``weights.from_jax_params`` over a tree of leaf ids."""
    cfg = get_config(arch)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    ids = {}

    def tag(path, leaf):
        k = len(ids)
        ids[k] = (_path(path), _path(path).startswith("blocks/"))
        n = leaf.shape[0] if ids[k][1] else None
        return np.full((n,), k) if n else np.array(k)
    id_tree = jax.tree_util.tree_map_with_path(tag, tree)
    assert len(ids) == len(leaves)
    return {name: ids[int(t.reshape(-1)[0])]
            for name, t in weights.from_jax_params(cfg, id_tree).items()}


def drop_stacked(spec, stacked):
    spec = tuple(spec)
    if stacked:
        assert spec[0] is None
        return spec[1:]
    return spec


# --------------------------------------------------------------------- #
# meshes
# --------------------------------------------------------------------- #
def test_meshes():
    m = tmesh.make_production_mesh()
    assert (m.axis_names, m.shape, m.size, m.name) == (
        ("data", "model"), {"data": 16, "model": 16}, 256, "16x16")
    m2 = tmesh.make_production_mesh(multi_pod=True)
    assert (tmesh.mesh_axis_sizes(m2), m2.size, m2.name) == (
        (2, 16, 16), 512, "2x16x16")
    for mp in (False, True):
        assert tuple(jmesh(mp).axis_names) == tmesh_of(mp).axis_names
        assert dict(jmesh(mp).shape) == tmesh_of(mp).shape
    # the CPU sees no card: one device, all of it on data
    host = tmesh.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.name == "1x1"
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(2, 2)


# --------------------------------------------------------------------- #
# parameter specs: every leaf of every config, both meshes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_repro(arch):
    cfg = get_config(arch)
    tcfg = tconfigs.get_config(arch)
    jparams = jstate(arch)[0].params
    names = port_to_repro(arch, jparams)
    tparams = ttrainer.meta_params(tcfg)
    assert set(names) == set(tparams)
    jleaves = {_path(p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for mp in (False, True):
        mesh = tmesh_of(mp)
        tspec = tsh.params_shardings(tparams, mesh, tcfg)
        for name, (jpath, stacked) in names.items():
            leaf = jleaves[jpath]
            want = jsh.legalize(
                jsh.param_pspec(jpath, len(leaf.shape), cfg),
                leaf.shape, mesh)
            assert tspec[name] == drop_stacked(want, stacked), (name, mp)
            t = tparams[name]
            for i, e in enumerate(tspec[name]):
                assert t.shape[i] % tsh._axis_size(mesh, e) == 0
            # big weights must be sharded, not silently replicated
            if t.numel() >= (1 << 22):
                assert any(e is not None for e in tspec[name]), \
                    (name, t.shape)


def test_param_spec_rules_by_name():
    cfg = tconfigs.get_config("qwen3-4b")
    assert tsh.param_pspec("embed", 2, cfg) == ("data", "model")
    assert tsh.param_pspec("layers.0.attn.wq.w", 2, cfg) == ("data",
                                                             "model")
    assert tsh.param_pspec("layers.0.attn.wo.w", 2, cfg) == ("model",
                                                             "data")
    assert tsh.param_pspec("layers.0.ln.scale", 1, cfg) == ()
    kimi = tconfigs.get_config("kimi-k2-1t-a32b")
    assert tsh.param_pspec("layers.3.ffn.wi", 3, kimi) == ("model", "data",
                                                          None)
    assert tsh.param_pspec("layers.3.ffn.router", 2, kimi) == ("data", None)
    assert tsh.param_pspec("embed", 2, cfg, fsdp=False) == (None, "model")


# --------------------------------------------------------------------- #
# batch, cache, pool and optimizer-slot specs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_and_pool_specs_equal_repro(multi_pod):
    jm, tm = jmesh(multi_pod), tmesh_of(multi_pod)
    for ndim in (1, 2, 3):
        for batch in (1, 2, 3, 8, 16, 32, 128, 256):
            want = tuple(jsh.batch_sharding(jm, ndim, batch).spec)
            assert tsh.batch_sharding(tm, ndim, batch) == want
    for sizes in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 8), (16, 16)):
        jm2 = AbstractMesh(sizes, ("data", "model"))
        tm2 = tmesh.LaunchMesh(("data", "model"), sizes)
        for n_kv in (1, 2, 4, 8, 16, 32):
            assert tsh.paged_pool_spec(tm2, n_kv) == tuple(
                jsh.paged_pool_spec(jm2, n_kv))


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-v0.1-52b",
                                  "mamba2-2.7b", "whisper-base",
                                  "gemma3-1b"])
def test_cache_specs_equal_repro(arch):
    cfg, tcfg = get_config(arch), tconfigs.get_config(arch)
    model = TT.Transformer.from_state_dict(tcfg, ttrainer.meta_params(tcfg))
    enc = cfg.frontend_seq if cfg.cross_attention else 0
    for batch, seq in ((128, 32768), (1, 524288), (3, 64)):
        jcache = jax.eval_shape(
            lambda: JT.init_cache(cfg, batch, seq, enc_len=enc))
        tcache = TT.init_cache(model, batch, seq, enc_len=enc)
        layers = []          # repro's leaves in the port's layer order
        for pi in range(cfg.num_periods):
            for s in range(cfg.period):
                layers.append((("blocks", f"sub{s}"), pi))
        for r in range(cfg.remainder_layers):
            layers.append((("rem", r), None))
        for mp in (False, True):
            jspec = jsh.cache_shardings(jcache, jmesh(mp), cfg, batch)
            tspec = tsh.cache_shardings(tcache, tmesh_of(mp), tcfg, batch)
            assert len(tspec) == len(layers)
            for (keys, pi), tl, ts in zip(layers, tcache, tspec):
                jl, js = jcache, jspec
                for k in keys:
                    jl, js = jl[k], js[k]
                assert set(jl) == set(tl)
                for key in tl:
                    shape = jl[key].shape[1:] if pi is not None else \
                        jl[key].shape
                    assert tuple(tl[key].shape) == shape
                    assert ts[key] == drop_stacked(js[key].spec,
                                                   pi is not None), \
                        (arch, batch, mp, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_slot_specs_equal_repro(arch):
    jst, kind = jstate(arch)
    cfg = get_config(arch)
    jm, mesh = jmesh(False), tmesh_of(False)
    jp = jsh.params_shardings(jst.params, jm, cfg)
    jopt = jspecs._opt_shardings(jst.opt_state, jp, jm)
    cell = tspecs.input_specs(arch, "train_4k", mesh)
    names = port_to_repro(arch, jst.params)
    jslots = {_path(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        jopt["m" if kind == "adamw" else "slots"])[0]}
    skipped = 0
    for name, (jpath, stacked) in names.items():
        if kind == "adamw":
            for slot in ("m", "v"):
                got = cell.arg_specs[f"opt.{slot}.{name}"]
                want = jopt[slot]
                for k in jpath.split("/"):
                    want = want[int(k)] if isinstance(want, list) else \
                        want[k]
                assert got == drop_stacked(want.sharding.spec, stacked)
            continue
        tslots = {s for s in ("vr", "vc", "v")
                  if f"opt.slots.{name}.{s}" in cell.arg_specs}
        jkeys = {s for s in ("vr", "vc", "v") if f"{jpath}/{s}" in jslots}
        if stacked and tslots == {"v"} and jkeys == {"vr", "vc"}:
            # the one known difference (ROADMAP C, "Adafactor on
            # period-stacked leaves"): repro stacks a period's layers, so
            # its Adafactor factors a per-layer 1-d leaf (a norm's scale)
            # jointly across periods as a (periods, n) leaf; the port's
            # leaf is 1-d and keeps a full ``v``
            skipped += 1
            continue
        assert tslots == jkeys, (name, tslots, jkeys)
        for s in tslots:
            want = jslots[f"{jpath}/{s}"].sharding.spec
            assert cell.arg_specs[f"opt.slots.{name}.{s}"] == \
                drop_stacked(want, stacked), (name, s)
    if kind == "adafactor":
        n_1d = sum(1 for n, (_, st) in names.items()
                   if st and cell.flat_args()[f"params.{n}"].dim() == 1)
        assert skipped == n_1d
    assert cell.arg_specs["opt.count"] == ()
    assert cell.arg_specs["step"] == ()


# --------------------------------------------------------------------- #
# byte reckoning
# --------------------------------------------------------------------- #
def test_shard_shape_equals_named_sharding():
    rng = np.random.default_rng(0)
    for mp in (False, True):
        jm, tm = jmesh(mp), tmesh_of(mp)
        axes = [None, "data", "model", ("data", "model")] + (
            [("pod", "data"), "pod"] if mp else [])
        for _ in range(200):
            nd = int(rng.integers(1, 5))
            spec = tuple(axes[int(rng.integers(len(axes)))]
                         for _ in range(nd))
            used = [a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            if len(used) != len(set(used)):
                continue
            shape = tuple(int(rng.choice([1, 2, 16, 32, 48, 512]))
                          for _ in range(nd))
            spec = tsh.legalize(spec, shape, tm)
            want = NamedSharding(jm, P(*spec)).shard_shape(shape)
            assert tsh.shard_shape(shape, spec, tm) == tuple(want)


def _numpy_bytes(leaves, specs_of, mesh):
    total = 0
    for leaf in leaves:
        shard = NamedSharding(mesh, P(*specs_of(leaf))).shard_shape(
            leaf.shape)
        total += int(np.prod(shard, dtype=np.int64)) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_argument_bytes_equal_numpy_reckoning(multi_pod):
    """qwen3-4b at full width: the decode cell's and the train cell's
    argument bytes equal the sum of ``repro``'s shard shapes (token ids
    and cache lengths counted at the port's int64)."""
    arch = "qwen3-4b"
    cfg = get_config(arch)
    jm, tm = jmesh(multi_pod), tmesh_of(multi_pod)
    B, S = 128, 32768
    jparams = jstate(arch)[0].params
    psh = jsh.params_shardings(jparams, jm, cfg)
    pbytes = sum(
        int(np.prod(s.shard_shape(l.shape), dtype=np.int64))
        * l.dtype.itemsize for l, s in zip(jax.tree.leaves(jparams),
                                           jax.tree.leaves(psh)))
    jcache = jax.eval_shape(lambda: JT.init_cache(cfg, B, S))
    csh = jsh.cache_shardings(jcache, jm, cfg, B)
    cbytes = sum(
        int(np.prod(s.shard_shape(l.shape), dtype=np.int64))
        * l.dtype.itemsize for l, s in zip(jax.tree.leaves(jcache),
                                           jax.tree.leaves(csh)))
    tok = jsh.batch_sharding(jm, 2, B).shard_shape((B, 1))
    lens = jsh.batch_sharding(jm, 1, B).shard_shape((B,))
    want = pbytes + cbytes + 8 * (int(np.prod(tok)) + int(np.prod(lens)))
    cell = tspecs.input_specs(arch, "decode_32k", tm)
    assert op_stats.argument_bytes(cell) == want

    jst, _ = jstate(arch)
    jopt = jspecs._opt_shardings(jst.opt_state, psh, jm)
    obytes = sum(
        int(np.prod(s.sharding.shard_shape(s.shape), dtype=np.int64))
        * s.dtype.itemsize for s in jax.tree.leaves(jopt))
    Bt, St = 256, 4096
    tok = jsh.batch_sharding(jm, 2, Bt).shard_shape((Bt, St))
    want = pbytes + obytes + 4 + 2 * 8 * int(np.prod(tok))
    cell = tspecs.input_specs(arch, "train_4k", tm)
    assert op_stats.argument_bytes(cell) == want


# --------------------------------------------------------------------- #
# FLOP counts
# --------------------------------------------------------------------- #
def _steps(cfg):
    """The smoke config's prefill, decode and train steps and their meta
    arguments (2 x 24 tokens; a 40-token cache)."""
    model = TT.Transformer.from_state_dict(cfg, ttrainer.meta_params(cfg))
    tok = torch.empty((2, 24), dtype=torch.int64, device="meta")
    opt, _ = tspecs.make_optimizer_for("qwen3-4b", cfg)
    state = ttrainer.abstract_state(cfg, opt)
    cache = TT.init_cache(model, 2, 40)
    one = torch.empty((2, 1), dtype=torch.int64, device="meta")
    lens = torch.empty((2,), dtype=torch.int64, device="meta")
    return {"prefill": (ttrainer.make_prefill_step(cfg), (model, tok)),
            "decode": (ttrainer.make_serve_step(cfg),
                       (model, one, cache, lens)),
            "train": (ttrainer.make_train_step(cfg, opt),
                      (state, (tok, tok)))}


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama4-scout-17b-a16e",
                                  "mamba2-2.7b"])
def test_flops_affine_in_periods(arch):
    base = tconfigs.smoke_config(arch)
    flops = {kind: [] for kind in ("prefill", "decode", "train")}
    for k in (1, 2, 3):
        cfg = tspecs.reduced_config(base, k)
        for kind, (fn, args) in _steps(cfg).items():
            flops[kind].append(op_stats.count_flops(fn, args)[0])
    for kind, (f1, f2, f3) in flops.items():
        assert f2 > f1 > 0, kind
        assert f3 - f2 == f2 - f1, (kind, f1, f2, f3)


def test_flops_are_2mnk_per_product():
    cfg = tconfigs.smoke_config("qwen3-4b")
    fn, args = _steps(cfg)["prefill"]
    total, by_op = op_stats.count_flops(fn, args)
    B, T, d, V = 2, 24, cfg.d_model, cfg.vocab_size
    hq, hkv, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.d_ff
    per_layer = d * (hq + 2 * hkv) * hd + hq * hd * d + d * 2 * ff + ff * d
    mm = 2 * B * T * per_layer * cfg.num_layers + 2 * B * 1 * d * V
    bmm = cfg.num_layers * 2 * (2 * B * hq * T * T * hd)
    assert by_op == {"aten.mm": mm, "aten.bmm": bmm}
    assert total == mm + bmm
    a = torch.empty((7, 5), device="meta")
    b = torch.empty((5, 3), device="meta")
    assert op_stats.count_flops(torch.mm, (a, b))[0] == 2 * 7 * 5 * 3
    # unfused: both inputs read and the output written, float32
    assert op_stats.unfused_bytes(torch.mm, (a, b)) == 4 * (35 + 15 + 21)


def test_temp_bytes_track_live_intermediates():
    def step(x):
        a = torch.zeros(1000, device="meta")      # 4000 bytes
        b = a + x                                 # 8000 live
        del a
        c = b.view(10, 100) * 2                   # 8000 live (b, c)
        return c.sum()
    x = torch.empty(1000, device="meta")
    st = op_stats.run_counted(step, (x,), exclude=[x])
    assert st.peak_bytes == 8004 and st.flops == 0
    # zeros 4000 + add (8000 in, 4000 out) + mul 8000 + sum 4004
    assert st.unfused_bytes == 4000 + 12000 + 8000 + 4004


# --------------------------------------------------------------------- #
# records
# --------------------------------------------------------------------- #
def assert_hbm_keys(rec):
    """``state_bytes`` is exact; on a partitioned mesh
    ``per_device_bytes`` is the state plus the local program's temp bytes
    and ``fits_hbm`` a boolean; on a mesh of three axes, not partitioned,
    both are null with the reason, as the temp bytes are."""
    m = rec["memory"]
    state = (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
             - m["alias_size_in_bytes"])
    assert rec["state_bytes"] == state
    assert rec["state_fits_hbm"] == (state <= 80e9)
    assert "fits_hbm_reason" not in rec
    if rec["mesh"].count("x") == 2:
        assert rec["per_device_bytes"] is None and rec["fits_hbm"] is None
        assert m["temp_size_in_bytes"] is None
        assert rec["unpartitioned_reason"] == dryrun.UNPARTITIONED_REASON
        return
    assert m["temp_size_in_bytes"] > 0
    assert rec["per_device_bytes"] == state + m["temp_size_in_bytes"]
    assert isinstance(rec["fits_hbm"], bool)
    assert rec["fits_hbm"] == (rec["per_device_bytes"] <= 80e9)


REPRO_KEYS = {"arch", "shape", "mesh", "multi_pod", "tag", "microbatches",
              "remat", "ce_impl", "fsdp", "moe_groups", "status", "chips",
              "cost", "memory", "collectives", "roofline", "model_flops",
              "model_flops_per_chip", "useful_flops_ratio",
              "per_device_bytes", "fits_hbm"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "alias_size_in_bytes", "temp_size_in_bytes"}


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-4b", "decode_32k"), ("qwen3-4b", "prefill_32k"),
    ("qwen3-4b", "train_4k"), ("llama4-scout-17b-a16e", "decode_32k"),
    ("mamba2-2.7b", "long_500k")])
def test_run_cell_records(arch, shape, tmp_path):
    """Each cell on a 2x2 mesh, partitioned (production meshes of 16x16
    are ``test_torch_partition.py``'s), and on the two-pod production
    mesh, whose three axes are not partitioned: one unpartitioned count
    shared by both, and a local count from the 2x2 mesh's program."""
    counts = {}
    meshes = [tmesh.LaunchMesh(("data", "model"), (2, 2)),
              tmesh_of(True)]
    recs = [dryrun.run_cell(arch, shape, mesh=m, num_periods=1,
                            counts=counts) for m in meshes]
    assert len(counts) == 1              # the unpartitioned count, shared
    (whole,) = counts.values()
    cfg = tspecs.reduced_config(tconfigs.get_config(arch), 1)
    for rec, chips in zip(recs, (4, 512)):
        assert REPRO_KEYS <= set(rec), REPRO_KEYS - set(rec)
        assert rec["status"] == "ok" and rec["chips"] == chips
        assert set(rec["memory"]) == MEMORY_KEYS
        r = rec["roofline"]
        assert r["t_compute_s"] == rec["cost"]["flops"] / 989e12
        assert r["t_memory_s"] == rec["cost"]["bytes_min"] / 3.35e12
        assert rec["cost"]["flops_total"] == whole.flops
        assert rec["torch_version"] == torch.__version__
        if chips == 512:
            assert rec["collectives"] is None and not rec["partitioned"]
            assert rec["unpartitioned_reason"] == \
                dryrun.UNPARTITIONED_REASON
            assert r["t_collective_s"] is None
            assert r["bound_s"] == max(r["t_compute_s"], r["t_memory_s"])
            assert rec["cost"]["flops"] == whole.flops / chips
            continue
        c = rec["collectives"]
        assert set(c["count"]) == set(hlo_stats.COLLECTIVE_OPS)
        assert sum(c["count"].values()) > 0
        assert c["by_link"]["network"] == 0     # 4 cards: one node
        assert r["t_collective_s"] == c["by_link"]["nvlink"] / 450e9 > 0
        assert r["bound_s"] == max(r["t_compute_s"], r["t_memory_s"],
                                   r["t_collective_s"])
        assert whole.flops / chips <= rec["cost"]["flops"] < whole.flops
        assert rec["hardware"]["hbm_bytes"] == 80e9
        n = cfg.active_param_count()
        kind = tconfigs.SHAPES[shape].kind
        toks = tconfigs.SHAPES[shape].global_batch * (
            1 if kind == "decode" else tconfigs.SHAPES[shape].seq_len)
        assert rec["model_flops"] == (6.0 if kind == "train" else 2.0) \
            * n * toks
        m = rec["memory"]
        assert_hbm_keys(rec)
        if kind == "prefill":
            assert m["alias_size_in_bytes"] == 0
        else:            # the train state and the decode cache in place
            assert m["alias_size_in_bytes"] > 0
        json.dumps(rec)
    cell = tspecs.input_specs(arch, shape, meshes[0], num_periods=1)
    mem = op_stats.extract_memory(cell, temp=0.0)
    assert mem["argument_size_in_bytes"] == op_stats.argument_bytes(cell)
    assert mem["argument_size_in_bytes"] == \
        recs[0]["memory"]["argument_size_in_bytes"]


def test_skipped_cell_and_cli(tmp_path):
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in tconfigs.SHAPES:
            if skip_reason(cfg, shape):
                rec = dryrun.run_cell(arch, shape, False)
                assert rec["status"] == "skip"
                assert rec["reason"] == skip_reason(cfg, shape)
    out = tmp_path / "dr"
    assert dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                        "--multi-pod", "--out", str(out)]) == 0
    rec = json.loads((out / "whisper-base__decode_32k__2x16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert_hbm_keys(rec)
    assert dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                        "--mesh", "2x2", "--out", str(out)]) == 0
    rec = json.loads((out / "whisper-base__decode_32k__2x2.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 4
    assert not dist.is_initialized()
    assert_hbm_keys(rec)
    assert dryrun.main(["--table", "--out", str(out)]) == 0
    assert dryrun.parse_mesh("2x4x2").axis_names == ("pod", "data",
                                                     "model")
    # an InputShape and a host mesh, as the card's check builds them
    shape = InputShape("decode_small", "decode", 64, 2)
    rec = dryrun.run_cell("qwen3-4b", shape, mesh=tmesh.make_host_mesh(),
                          num_periods=1)
    assert rec["mesh"] == "1x1" and rec["chips"] == 1
    assert rec["local_batch"] == 2
    assert_hbm_keys(rec)
    assert isinstance(rec["fits_hbm"], bool)


def test_run_all_writes_every_cell_once(tmp_path):
    """``run_all`` over one arch (one period of it), two shapes and two
    small meshes: every (shape x mesh) cell is written, the supported
    ones ``ok`` with the pool's counts and local programs equal to what
    ``run_cell`` reckons in this process, the skipped one with
    ``repro``'s reason; a second call finds them all cached."""
    out, logs = tmp_path / "all", []
    arch, shapes = "whisper-base", ["decode_32k", "long_500k"]
    meshes = [dryrun.parse_mesh("1x2"), tmesh_of(True)]
    recs = dryrun.run_all(str(out), archs=[arch], shapes=shapes,
                          log=logs.append, meshes=meshes, num_periods=1)
    assert [(r["shape"], r["mesh"], r["status"]) for r in recs] == [
        ("decode_32k", "1x2", "ok"), ("decode_32k", "2x16x16", "ok"),
        ("long_500k", "1x2", "skip"), ("long_500k", "2x16x16", "skip")]
    assert recs[2]["reason"] == skip_reason(get_config(arch), "long_500k")
    assert sorted(p.name for p in out.iterdir()) == sorted(
        dryrun.cell_filename(arch, s, m.name) for s in shapes
        for m in meshes)
    here = dryrun.run_cell(arch, "decode_32k", mesh=meshes[0],
                           num_periods=1)
    for key in ("memory", "cost", "roofline", "collectives",
                "state_bytes"):
        assert recs[0][key] == here[key], key
    assert recs[1]["collectives"] is None and not recs[1]["partitioned"]
    assert not dist.is_initialized()
    assert dryrun.run_all(str(out), archs=[arch], shapes=shapes,
                          log=logs.append, meshes=meshes,
                          num_periods=1) == []
    assert sum(line.startswith("[skip-cached]") for line in logs) == 4
