"""The dry run's SPMD half: a cell's step partitioned with DTensor over a
fake world (``launch.mesh.device_mesh``), its collectives priced by
``repro``'s ring rule, and the counters reading rank 0's local program;
and the mesh engine at 16 and 32 data shards (ROADMAP C2, repaired).

Pricing: each collective the port records is rendered as one HLO line
with its replica group and fed to ``repro.launch.hlo_stats``'
``collect_collectives``; counts and link bytes agree, except a
reduce-scatter's, which ``repro`` prices by its result shard where its
docstring (and the port) price the operand: n times more (ROADMAP C3).
Structure: a one-layer dense smoke cell's collectives at 1x2 and 2x1,
written out by hand from the specs and the partition's rules.  Local
counts: FLOPs x chips equal the unpartitioned count where every product
splits evenly, and the local peak is below the unpartitioned one on a
model-split mesh.  Beside ``repro``: its 2x2 mini dry run (XLA's SPMD
partition of the same smoke train step) and the port's partition of it
agree on temp bytes, the local share of the FLOPs and the link bytes of
the collectives both issue, within stated limits.  Two pods: a cell on
(pod, data, model) is its pod's block on (data, model) (the same ops,
FLOPs and temp as that cell at the pod's batch, exactly) plus the
all-reduces over the pod group that the specs imply, held by hand, on
production cells, and beside ``repro``'s 2x2x2 mini dry run.
"""

import dataclasses
import os
import subprocess
import sys

import torch
import torch.distributed as dist
import pytest

from repro.launch import hlo_stats
from repro_torch import configs as tconfigs
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import InputShape
from repro_torch.distributed import decode_mesh
from repro_torch.kernels import por as por_mod
from repro_torch.launch import dryrun, op_stats
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import DecodeEngine

from torch_threads import one_torch_thread  # noqa: F401

# one layer; a vocabulary of 256 splits evenly over 2 (the smoke's 257
# does not: rank 0's head would hold 129 words)
DENSE1 = dataclasses.replace(
    tspecs.reduced_config(smoke_config("qwen3-4b"), 1), vocab_size=256)
PREFILL = InputShape("prefill_s", "prefill", 64, 4)
DECODE = InputShape("decode_s", "decode", 16, 4)
TRAIN = InputShape("train_s", "train", 32, 4)
SHAPES = {"prefill": PREFILL, "decode": DECODE, "train": TRAIN}


def lmesh(*sizes):
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                       "model")
    return tmesh.LaunchMesh(names, tuple(sizes))


_RUNS = {}


def partitioned(kind, sizes, cfg=DENSE1, batch=None):
    """The smoke cell's local program on ``sizes`` (cached; no remat, so
    a train cell runs its forward once); ``batch`` in place of the
    shape's; on three axes, its pod-local program."""
    shape = SHAPES[kind]
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    key = (kind, sizes, cfg.name, cfg.num_layers, shape.global_batch)
    if key not in _RUNS:
        mesh = lmesh(*sizes)
        with tmesh.device_mesh(tmesh.pod_block(mesh)) as dm:
            cell = tspecs.input_specs(cfg.name, shape, mesh, cfg=cfg,
                                      remat=False, partitioned=True,
                                      device_mesh=dm)
            _RUNS[key] = op_stats.count_cell(cell)
        assert not dist.is_initialized()
        assert set(_RUNS[key].rules) <= set(op_stats.RULES), \
            _RUNS[key].rules
    return _RUNS[key]


def whole(kind, cfg=DENSE1):
    """The unpartitioned step at its global batch (cached)."""
    key = (kind, "whole", cfg.name, cfg.num_layers)
    if key not in _RUNS:
        cell = tspecs.input_specs(cfg.name, SHAPES[kind], lmesh(1, 1),
                                  cfg=cfg, remat=False)
        _RUNS[key] = op_stats.count_cell(cell)
    return _RUNS[key]


# --------------------------------------------------------------------- #
# C2 (repaired): the mesh serves a data axis wider than 16
# --------------------------------------------------------------------- #
C2_CFG = smoke_config("qwen2.5-14b")
C2_DOC = [3 + (7 * i) % 240 for i in range(320)]     # 40 pages of 8


def c2_streams(mesh):
    model = build_model(C2_CFG, seed=0, device="cpu", dtype=torch.float32)
    eng = DecodeEngine(C2_CFG, model, page_size=8, num_pages=512,
                       backend="codec-cuda", max_q=8, fused=True,
                       mesh=mesh, seq_split_pages=1 if mesh else 0,
                       device="cpu")
    rids = [eng.add_request(C2_DOC + [245 + i], max_new=4)
            for i in range(4)]
    eng.run(64)
    eng.check()
    return [list(eng.requests[r].generated) for r in rids]


def test_c2_sixteen_shards_serve_the_single_shard_streams():
    one = c2_streams(None)
    assert all(len(s) == 4 for s in one)
    assert c2_streams(decode_mesh(16, 1, device="cpu")) == one


def test_c2_thirty_two_shards_serve_the_single_shard_streams(monkeypatch):
    """C2 repaired: a data axis wider than 16 serves (repro takes any
    power of two), and the document's 40 pages span all 32 shards, so
    each layer's merge runs over 32 contributors."""
    calls = []
    merge = por_mod.mesh_merge

    def counted(o, *a, **k):
        calls.append(int(a[4].sum()))       # contributing shards
        return merge(o, *a, **k)
    monkeypatch.setattr(por_mod, "mesh_merge", counted)
    got = c2_streams(decode_mesh(32, 1, device="cpu"))
    monkeypatch.undo()
    assert got == c2_streams(None)
    assert calls and max(calls) == 32


# --------------------------------------------------------------------- #
# the fake world and the placements
# --------------------------------------------------------------------- #
def test_device_mesh_is_a_fake_world_torn_down_after():
    mesh = lmesh(2, 4, 2)
    with tmesh.device_mesh(mesh) as dm:
        assert dist.get_world_size() == 16 and dist.get_rank() == 0
        assert dm.mesh_dim_names == ("pod", "data", "model")
        assert tuple(dm.mesh.shape) == (2, 4, 2)
        # ranks in row-major order: model groups of rank 0 are adjacent
        assert dm.mesh.flatten().tolist() == list(range(16))
        assert dist.get_process_group_ranks(dm.get_group("model")) == [0, 1]
        assert dist.get_process_group_ranks(dm.get_group("data")) == [
            0, 2, 4, 6]
        assert dist.get_process_group_ranks(dm.get_group("pod")) == [0, 8]
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with tmesh.device_mesh(lmesh(1, 2)):
            raise KeyError("a cell that fails")
    assert not dist.is_initialized()
    # the link a group crosses: 8 cards a node
    assert tmesh.group_link(range(8)) == "nvlink"
    assert tmesh.group_link([0, 16, 32]) == "network"
    assert tmesh.group_link(range(16)) == "network"
    assert tmesh.nodes_of(range(0, 256, 16)) == 16


def test_placements_tile_like_shard_shape():
    """DTensor's local shape of every spec equals ``shard_shape``, and a
    dimension split over (pod, data) is pod-major, as ``NamedSharding``
    tiles it: rank 5 of a 2x4x2 world, coordinates (0, 2, 1), holds
    block 2 of the batch split 8 ways."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.device_mesh import init_device_mesh
    mesh = lmesh(2, 4, 2)
    axes = [None, "data", "model", ("data", "model"), ("pod", "data"),
            "pod", ("pod", "data", "model")]
    shapes = [(16, 8), (8, 16, 4), (32,), (16, 2, 8)]
    with tmesh.device_mesh(mesh) as dm:
        for shape in shapes:
            for i, a in enumerate(axes):
                for b in axes[:3]:
                    spec = tsh.legalize((a, b), shape, mesh)
                    used = [x for e in spec if e is not None
                            for x in (e if isinstance(e, tuple) else (e,))]
                    if len(used) != len(set(used)):
                        continue
                    t = DTensor.from_local(
                        torch.empty(tsh.shard_shape(shape, spec, mesh),
                                    device="meta"),
                        dm, tsh.placements(spec, mesh), run_check=False,
                        shape=torch.Size(shape),
                        stride=torch.empty(shape, device="meta").stride())
                    assert tuple(t.to_local().shape) == tsh.shard_shape(
                        shape, spec, mesh), (shape, spec)
        assert tsh.placements((("pod", "data"), "model"), mesh) == (
            Shard(0), Shard(0), Shard(1))
        assert tsh.placements((None,), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="mesh's order"):
            tsh.placements((("data", "pod"),), mesh)
    # the offset of a (pod, data) split, seen from rank 5
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dist.init_process_group(tmesh._fake_backend(), store=dist.HashStore(),
                            rank=5, world_size=16)
    try:
        dm = init_device_mesh("cpu", (2, 4, 2),
                              mesh_dim_names=("pod", "data", "model"))
        assert list(dm.get_coordinate()) == [0, 2, 1]
        shape, offset = compute_local_shape_and_global_offset(
            (64, 6), dm, tsh.placements((("pod", "data"), None), mesh))
        assert tuple(shape) == (8, 6) and tuple(offset) == (16, 0)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# collectives: repro's ring rule, and the structure of a smoke cell
# --------------------------------------------------------------------- #
_HLO_TYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.int64: "s64", torch.int32: "s32", torch.bool: "pred"}
_HLO_OP = {k: k for k in hlo_stats.COLLECTIVE_OPS}


def hlo_lines(colls, dtype=torch.float32):
    """Each recorded collective as one HLO line: its result a flat array
    of its result bytes, its replica group its ranks."""
    out = []
    for i, c in enumerate(colls):
        n = c.out_bytes // dtype.itemsize
        m = c.in_bytes // dtype.itemsize
        t = _HLO_TYPE[dtype]
        groups = ",".join(map(str, c.ranks))
        where = (f"source_target_pairs={{{{{c.ranks[0]},{c.ranks[1]}}}}}"
                 if c.kind == "collective-permute" else
                 f"replica_groups={{{{{groups}}}}}")
        out.append(f"  %c.{i} = {t}[{n}]{{0}} {_HLO_OP[c.kind]}("
                   f"{t}[{m}]{{0}} %p.{i}), {where}")
    return "\n".join(out)


def test_reduce_scatter_priced_by_its_operand():
    """C3: ``repro``'s docstring prices a reduce-scatter at (n-1)/n S_in,
    its code at (n-1)/n of the result shard.  One line, a group of 4:
    a ring moves 3/4 of 512 bytes = 384; ``repro`` gives 96."""
    line = ("  %rs = f32[4,8]{1,0} reduce-scatter(f32[16,8]{1,0} %x), "
            "replica_groups={{0,1,2,3}}, dimensions={0}")
    st = hlo_stats.collect_collectives(line, 4)
    assert st.count["reduce-scatter"] == 1
    assert st.link_bytes["reduce-scatter"] == 96.0
    port = op_stats.Collective("reduce-scatter", 16 * 8 * 4, 4 * 8 * 4,
                               (0, 1, 2, 3))
    assert port.link_bytes == 384.0 == 4 * 96.0


@pytest.mark.parametrize("kind,sizes", [("train", (2, 2)),
                                        ("decode", (2, 2)),
                                        ("prefill", (1, 2))])
def test_collectives_priced_as_repro(kind, sizes):
    """The port's collectives of a partitioned smoke cell, rendered as
    HLO and read back by ``repro``'s parser: counts and result bytes
    equal for every kind; link bytes equal for every kind but
    reduce-scatter, where the port's are ``repro``'s times n (C3)."""
    colls = partitioned(kind, sizes).collectives
    port = op_stats.collect_collectives(colls)
    assert sum(port.count.values()) == len(colls) > 0
    n_chips = lmesh(*sizes).size
    # a permute names no group: repro takes every device as its group,
    # whose size does not enter its price
    theirs = hlo_stats.collect_collectives(hlo_lines(colls), n_chips)
    assert theirs.count == port.count
    assert theirs.result_bytes == port.result_bytes
    assert {c.n for c in colls} == {2}        # every group of 2 here
    for op in hlo_stats.COLLECTIVE_OPS:
        if op == "reduce-scatter":
            assert port.link_bytes[op] == pytest.approx(
                2 * theirs.link_bytes[op])
        else:
            assert theirs.link_bytes[op] == pytest.approx(
                port.link_bytes[op]), op
    assert port.count["reduce-scatter"] or kind != "train"
    assert op_stats.COLLECTIVE_OPS == hlo_stats.COLLECTIVE_OPS


def ag(in_b):
    """An all-gather over a group of 2 of ``in_b`` bytes a rank."""
    return ("all-gather", in_b, 2 * in_b)


def ar(b):
    return ("all-reduce", b, b)


def perm(b):
    return ("collective-permute", b, b)


def test_one_layer_prefill_collectives_by_hand():
    """The one-layer dense smoke cell (d 64, 4 heads of 16 over 2 KV
    heads, a SwiGLU of 2 x 96, a tied vocabulary of 256), prefill of 4 x
    64 tokens, float32: the collectives its specs imply under the
    partition's rules (``op_stats.OpStats``), in the order the step runs.

    2x1 (data 2): FSDP only.  Each weight split over ``data`` is gathered
    before it computes, in the layer's order: the embedding (256 x 64)
    for the lookup, wq (64 x 64), wk and wv (64 x 32), wo (64 x 64), the
    fused SwiGLU wi (64 x 192), the FFN's wo (96 x 64), and the
    embedding again for the tied head.

    1x2 (model 2): Megatron's tensor parallelism.
    - the lookup's output, split on d_model over ``model`` as the
      embedding's spec splits it, is gathered: the residual stream is
      replicated over ``model`` (256 tokens x 64);
    - wq, wk and wv are split on their columns (heads): nothing moves;
    - wo is split on its rows: its partial sum is all-reduced;
    - wi is split on its 192 columns, so each shard holds one half of
      the gate | up pair: the gate's and the up's halves each move by a
      collective-permute (256 x 48 a shard);
    - the FFN's wo: all-reduced as wo;
    - the tied head is vocabulary-parallel: the embedding, split on
      d_model, is gathered on ``model`` and keeps its vocabulary block,
      so the logits stay split on the vocabulary."""
    f32 = 4
    got = [(c.kind, c.in_bytes, c.out_bytes)
           for c in partitioned("prefill", (2, 1)).collectives]
    assert got == [ag(256 * 64 * f32 // 2), ag(64 * 64 * f32 // 2),
                   ag(64 * 32 * f32 // 2), ag(64 * 32 * f32 // 2),
                   ag(64 * 64 * f32 // 2), ag(64 * 192 * f32 // 2),
                   ag(96 * 64 * f32 // 2), ag(256 * 64 * f32 // 2)]
    tokens = 4 * 64
    got = [(c.kind, c.in_bytes, c.out_bytes)
           for c in partitioned("prefill", (1, 2)).collectives]
    assert got == [
        ag(tokens * 64 * f32 // 2),                          # lookup
        ar(tokens * 64 * f32),                               # wo
        perm(tokens * 48 * f32), perm(tokens * 48 * f32),    # gate, up
        ar(tokens * 64 * f32),                               # FFN's wo
        ag(256 * 64 * f32 // 2)]                             # tied head
    for sizes in ((2, 1), (1, 2)):
        assert all(c.ranks == (0, 1) for c in
                   partitioned("prefill", sizes).collectives)


# --------------------------------------------------------------------- #
# the counters read the local program
# --------------------------------------------------------------------- #
def test_counters_see_local_shards():
    """A product of a row-split DTensor: ``OpStats`` counts the local
    product's FLOPs, bytes and peak (a mode outside DTensor would see
    the global shapes), and none of the fake ops of DTensor's sharding
    propagation (the first call fills its caches; the second counts the
    same)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = lmesh(4, 1)
    with tmesh.device_mesh(mesh) as dm:
        a = DTensor.from_local(torch.empty(2, 5, device="meta"), dm,
                               [Shard(0), Replicate()], run_check=False,
                               shape=torch.Size((8, 5)), stride=(5, 1))
        b = DTensor.from_local(torch.empty(5, 3, device="meta"), dm,
                               [Replicate(), Replicate()], run_check=False,
                               shape=torch.Size((5, 3)), stride=(3, 1))
        for _ in range(2):
            st = op_stats.run_counted(torch.mm, (a, b), exclude=[a, b])
            assert st.flops == 2 * 2 * 5 * 3
            assert st.by_op == {"aten.mm": 2 * 2 * 5 * 3}
            assert st.unfused_bytes == 4 * (2 * 5 + 5 * 3 + 2 * 3)
            assert st.peak_bytes == 4 * 2 * 3
            assert st.collectives == []


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_local_flops_times_chips_equal_the_whole(kind):
    """Where every product splits evenly over the mesh (heads, FFN, batch
    and the vocabulary of 256), local FLOPs x chips equal the
    unpartitioned count (train on the meshes the other tests partition
    it on)."""
    total = whole(kind).flops
    meshes = ((2, 1), (1, 2), (2, 2)) if kind == "prefill" else \
        ((1, 2), (2, 2))
    for sizes in meshes:
        chips = lmesh(*sizes).size
        assert partitioned(kind, sizes).flops * chips == total, sizes


def test_local_temp_below_the_whole_on_a_model_split_mesh():
    """Where activations dominate the peak (prefill and train; a smoke
    decode's peak is its gathered weights and replicated masks)."""
    for kind in ("prefill", "train"):
        for sizes in ((1, 2), (2, 2)):
            assert partitioned(kind, sizes).peak_bytes < \
                whole(kind).peak_bytes, (kind, sizes)


def test_partition_rules_act_where_dtensor_cannot_place():
    """The decode cell writes the new column into a cache split over
    ``model`` on its sequence (``index_put_shards``); the train cell's
    vocabulary-parallel CE reduces its log-sum-exp and its gold logits
    across the vocabulary's shards, and its backward scatters into a
    vocabulary-split gradient; the SwiGLU's halves move by permutes both
    ways; every partitioned cell gathers FSDP-split weights; the
    unpartitioned step needs none."""
    dec = partitioned("decode", (1, 2)).rules
    assert dec["index_put_shards"] == 2 and dec["fsdp_gather"] > 0
    assert dec["head_vocab_split"] == 1
    train = partitioned("train", (1, 2)).rules
    for rule in ("logsumexp_split", "gather_partial", "scatter_add_shards",
                 "logits_grad_vocab_split", "index_put_partial"):
        assert train[rule] == 1, rule
    assert train["slice_permuted"] == 2        # the gate and the up
    assert train["slice_backward_permuted"] == 2
    assert whole("decode").rules == {}


def test_copy_into_partial_writes_each_block():
    """``copy_`` of a source split over ``model`` into a destination that
    holds a partial sum there (DTensor refuses it: no shard-to-partial
    redistribution): rank 0 zeroes its partial and writes its own block
    of the source (the first), so the shards' blocks sum to the source;
    no collective, no FLOP."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = lmesh(1, 2)
    with tmesh.device_mesh(mesh) as dm:
        dst = DTensor.from_local(torch.full((4, 6), 7.0), dm,
                                 [Shard(0), Partial()], run_check=False)
        src = DTensor.from_local(torch.arange(12.0).reshape(4, 3), dm,
                                 [Shard(0), Shard(1)], run_check=False,
                                 shape=torch.Size((4, 6)), stride=(6, 1))
        st = op_stats.run_counted(lambda d, s: d.copy_(s), (dst, src),
                                  exclude=[dst, src])
        local = dst.to_local()
        assert torch.equal(local[:, :3], torch.arange(12.0).reshape(4, 3))
        assert torch.equal(local[:, 3:], torch.zeros(4, 3))
        assert st.collectives == [] and st.flops == 0
        assert st.rules == {"copy_into_partial": 1}
    assert not dist.is_initialized()


def test_unplaceable_op_is_named():
    """An op no rule places and DTensor refuses raises ``PartitionError``
    naming it: the dry run records the cell as an error with the op."""
    from torch.distributed.tensor import DTensor, Shard, Replicate
    mesh = lmesh(1, 2)
    with tmesh.device_mesh(mesh) as dm:
        x = DTensor.from_local(torch.empty(4, 3, device="meta"), dm,
                               [Replicate(), Shard(0)], run_check=False,
                               shape=torch.Size((8, 3)), stride=(3, 1))

        def step(x):                # no strategy: its size is the data's
            return torch.nonzero(x)
        with pytest.raises(op_stats.PartitionError) as err:
            op_stats.run_counted(step, (x,), exclude=[x])
        assert err.value.op.startswith("aten.")
    assert not dist.is_initialized()


# --------------------------------------------------------------------- #
# records on every mesh
# --------------------------------------------------------------------- #
def assert_record(rec):
    m = rec["memory"]
    state = (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
             - m["alias_size_in_bytes"])
    assert rec["status"] == "ok"
    assert rec["per_device_bytes"] == state + m["temp_size_in_bytes"]
    assert isinstance(rec["fits_hbm"], bool)
    assert rec["fits_hbm"] == (rec["per_device_bytes"] <= dryrun.HBM_BYTES)
    r, c = rec["roofline"], rec["collectives"]
    assert set(c["count"]) == set(hlo_stats.COLLECTIVE_OPS)
    assert r["t_collective_s"] == pytest.approx(
        c["by_link"]["nvlink"] / dryrun.NVLINK_BW
        + c["by_link"]["network"] / dryrun.NETWORK_BW)
    assert sum(c["by_link"].values()) == pytest.approx(c["total_link_bytes"])
    assert r["bound_s"] == max(r["t_compute_s"], r["t_memory_s"],
                               r["t_collective_s"])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_production_records(shape):
    """Two production cells, qwen3-4b at one layer on 16x16: partitioned,
    with collectives over groups of 16 that span two nodes (network), a
    per-device total that fits, the torch release that placed it, and
    the local FLOPs at least a 256th of the whole.  Decode splits every
    product evenly; train computes the weight gradients of K and V whole
    on each ``model`` shard (8 KV heads, 16 shards: K and V are
    replicated), a few percent more than an even share."""
    rec = dryrun.run_cell("qwen3-4b", shape, num_periods=1)
    assert not dist.is_initialized()
    assert_record(rec)
    assert rec["torch_version"] == torch.__version__
    assert rec["partitioned"] and rec["fits_hbm"]
    c = rec["collectives"]
    assert sum(c["count"].values()) > 0
    assert c["by_link"]["network"] > 0 and c["by_link"]["nvlink"] == 0
    share = rec["cost"]["flops"] * 256 / rec["cost"]["flops_total"]
    if shape == "decode_32k":
        assert share == 1.0
    else:
        assert 1.0 < share < 1.1


def param_shard_bytes(cell):
    """One device's shards of the cell's weights, in bytes: what the
    gradients that merge across the pods hold."""
    return sum(op_stats._shard_bytes(t.shape, t.dtype, cell.arg_specs[p],
                                     cell.mesh)
               for p, t in cell.flat_args().items()
               if p.startswith("params."))


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_three_axis_production_records(shape):
    """qwen3-4b at one layer on 2x16x16 is partitioned as one pod's block
    and fits: its local FLOPs (by op) and temp equal, exactly, those of
    the 16x16 program at the pod's batch (half the global), and so do
    its collectives but the pod's.  Train merges each gradient shard and
    the two batch metrics across the pods (group (0, 256), two nodes
    apart: the network), one all-reduce each, the weights' shard bytes
    plus 8 on the link; decode splits its batch over ``pod`` and has no
    pod collective."""
    rec = dryrun.run_cell("qwen3-4b", shape, multi_pod=True, num_periods=1)
    assert not dist.is_initialized()
    assert_record(rec)
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
    assert rec["partitioned"] and rec["fits_hbm"]
    assert "unpartitioned_reason" not in rec
    full = tconfigs.SHAPES[shape]
    half = dataclasses.replace(full, global_batch=full.global_batch // 2)
    sub = dryrun.count_local("qwen3-4b", half, lmesh(16, 16),
                             dict(num_periods=1))
    assert not dist.is_initialized()
    assert rec["cost"]["flops"] == sub.flops
    assert rec["cost"]["flops_by_op"] == sub.by_op
    assert rec["memory"]["temp_size_in_bytes"] == sub.peak_bytes
    assert rec["partition_rules"] == sub.rules
    assert rec["local_batch"] == full.global_batch // 32
    c, pod = rec["collectives"], rec["collectives"]["pod"]
    mine = dryrun.collective_record(sub.collectives)
    assert pod["link"] == "network" == tmesh.group_link((0, 256))
    for kind in hlo_stats.COLLECTIVE_OPS:
        extra = pod["count"] if kind == "all-reduce" else 0
        assert c["count"][kind] == mine["count"][kind] + extra, kind
    assert c["by_link"]["network"] == pytest.approx(
        mine["by_link"]["network"] + pod["link_bytes"])
    if shape == "decode_32k":
        assert pod == {"count": 0, "link_bytes": 0.0, "link": "network"}
        return
    cell = tspecs.input_specs("qwen3-4b", shape, tmesh_of(True),
                              num_periods=1)
    n = sum(p.startswith("params.") for p in cell.arg_specs)
    assert pod["count"] == n + len(op_stats.BATCH_METRICS)
    # an all-reduce over 2 sends its bytes once: 2 (n-1)/n = 1
    assert pod["link_bytes"] == param_shard_bytes(cell) + 8


def tmesh_of(multi_pod):
    return tmesh.make_production_mesh(multi_pod=multi_pod)


POD3 = (2, 2, 2)
POD_GROUP = (0, 4)                  # rank 0's pod group on 2x2x2


def split_by_pod(colls):
    pod = [c for c in colls if c.ranks == POD_GROUP]
    return pod, [c for c in colls if c.ranks != POD_GROUP]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_pod_local_identity(kind):
    """The smoke cell at batch 8 on 2x2x2 against the same cell at batch
    4 on 2x2 (its pod's block): the same ops, FLOPs, op bytes, temp and
    rules, and the same collectives in the same order, plus the pod's.
    Train: each gradient, as its hook places it, and the loss and the CE
    are all-reduced over the pod group, whose link bytes are the
    weights' shard bytes plus 2 x 4 (by hand from the specs); every
    reduction over ``data`` that moves more than a scalar is a gradient's
    (a batch reduction), at once followed by its pod all-reduce.  The
    scalars over ``data`` that gain none are the metrics (merged after
    the step) and the clip's norm, a sum over the gradients' shards
    already merged.  Prefill and decode: FSDP's traffic over ``data`` is
    all-gathers only, and nothing crosses the pods."""
    three = partitioned(kind, POD3, batch=8)
    two = partitioned(kind, (2, 2))
    assert three.flops == two.flops and three.by_op == two.by_op
    assert three.unfused_bytes == two.unfused_bytes
    assert three.peak_bytes == two.peak_bytes
    assert three.rules == two.rules
    pod, rest = split_by_pod(three.collectives)
    assert rest == two.collectives
    data = (0, 2)
    if kind != "train":
        assert pod == []
        assert {c.kind for c in rest if c.ranks == data} <= {"all-gather"}
        return
    mesh = lmesh(*POD3)
    cell = tspecs.input_specs(DENSE1.name, dataclasses.replace(
        TRAIN, global_batch=8), mesh, cfg=DENSE1, remat=False)
    assert {c.kind for c in pod} == {"all-reduce"}
    assert len(pod) == sum(p.startswith("params.") for p in cell.arg_specs) \
        + len(op_stats.BATCH_METRICS)
    assert sum(c.link_bytes for c in pod) == param_shard_bytes(cell) + 8
    colls = three.collectives
    for i, c in enumerate(colls):
        if c.ranks == data and c.kind != "all-gather" and c.out_bytes > 4:
            assert colls[i + 1] == op_stats.Collective(
                "all-reduce", c.out_bytes, c.out_bytes, POD_GROUP), i


def test_pod_local_cell_keeps_each_devices_shards():
    """``specs.pod_local`` of a train cell on 2x2x2: the (data, model)
    block, specs without ``pod``, the tokens cut to one pod's batch, the
    weights and the optimizer state as they are, and every device's
    argument, output and alias bytes and its minimum traffic equal the
    three-axis cell's; a weight split over ``pod`` is refused, naming
    it."""
    mesh = lmesh(*POD3)
    cell = tspecs.input_specs(DENSE1.name, dataclasses.replace(
        TRAIN, global_batch=8), mesh, cfg=DENSE1)
    local = tspecs.pod_local(cell)
    assert local.mesh == lmesh(2, 2) == tmesh.pod_block(mesh)
    assert local.pod == tspecs.PodSplit(POD_GROUP, True, False)
    assert local.shape.global_batch == 4 and local.local_batch == 2
    assert cell.local_batch == 2
    flat, cut = cell.flat_args(), local.flat_args()
    assert tuple(cut["tokens"].shape) == (4, 32)
    for p, t in flat.items():
        assert "pod" not in str(local.arg_specs[p]), p
        if p not in ("tokens", "labels"):
            assert cut[p] is t, p
    assert op_stats.extract_memory(local, temp=0.0) == \
        op_stats.extract_memory(cell, temp=0.0)
    assert op_stats.min_bytes(local) == op_stats.min_bytes(cell)
    assert tspecs.pod_local(local) is local
    bad = dataclasses.replace(cell, arg_specs=dict(
        cell.arg_specs, **{"params.embed": ("pod", "model")}))
    with pytest.raises(op_stats.PartitionError) as err:
        tspecs.pod_local(bad)
    assert err.value.op == "params.embed"
    with tmesh.device_mesh(mesh) as dm:
        with pytest.raises(ValueError, match="DeviceMesh"):
            tspecs.partition(cell, dm)
    assert not dist.is_initialized()


def test_pod_split_mamba_state():
    """mamba2's smoke decode at batch 8 on 2x2x2: the tokens split over
    (pod, data), but ``cache_spec`` splits the SSM and conv states' batch
    over ``dp[0]``, which is ``pod`` on two pods: their local shards keep
    the pod's batch, 4 rows, replicated over ``data`` (specs recomputed
    on the (data, model) block would split them to 2).  The step
    partitions and no collective crosses the pods."""
    cfg = tspecs.reduced_config(smoke_config("mamba2-2.7b"), 1)
    mesh = lmesh(*POD3)
    shape = dataclasses.replace(DECODE, global_batch=8)
    with tmesh.device_mesh(tmesh.pod_block(mesh)) as dm:
        cell = tspecs.input_specs(cfg.name, shape, mesh, cfg=cfg,
                                  partitioned=True, device_mesh=dm)
        assert cell.pod == tspecs.PodSplit(POD_GROUP, True, False)
        flat = cell.flat_args()
        assert tuple(flat["tokens"].to_local().shape) == (2, 1)
        for key in ("conv", "ssm"):
            assert "data" not in str(cell.arg_specs[f"cache.0.{key}"])
            t = flat[f"cache.0.{key}"]
            assert t.shape[0] == 4 and t.to_local().shape[0] == 4, key
        count = op_stats.count_cell(cell)
    assert not dist.is_initialized()
    assert split_by_pod(count.collectives)[0] == []
    assert count.flops > 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "jamba-v0.1-52b"])
def test_pod_split_sequence_merge(arch):
    """A batch-1 decode (``long_500k``'s layout) at one period on 2x2x2:
    the cache's sequence splits over (pod, data, model), the batch over
    nothing.  The pod-local program is the 2x2 cell over the pod's half
    of the cache (the same ops, FLOPs and temp), and each split-K merge
    of attention (the softmax statistics, then the outputs, each
    all-reduced over ``model``) gains an all-reduce of the same bytes
    over the pod group; Mamba layers (jamba's seven of eight) keep their
    state whole on every device and gain nothing."""
    cfg = tspecs.reduced_config(smoke_config(arch), 1)
    runs = {}
    for sizes, seq in ((POD3, 64), ((2, 2), 32)):
        mesh = lmesh(*sizes)
        shape = InputShape("long_s", "decode", seq, 1)
        with tmesh.device_mesh(tmesh.pod_block(mesh)) as dm:
            cell = tspecs.input_specs(cfg.name, shape, mesh, cfg=cfg,
                                      partitioned=True, device_mesh=dm)
            runs[sizes] = (cell, op_stats.count_cell(cell))
    cell, three = runs[POD3]
    two = runs[(2, 2)][1]
    assert cell.pod == tspecs.PodSplit(POD_GROUP, False, True)
    assert three.flops == two.flops and three.by_op == two.by_op
    assert three.peak_bytes == two.peak_bytes
    pod, rest = split_by_pod(three.collectives)
    assert rest == two.collectives
    attn = sum(c.get("k") is not None for c in cell.args[2])
    assert attn == (cfg.num_layers if arch == "gemma3-1b" else 1)
    assert len(pod) == 2 * attn
    colls = three.collectives
    for i, c in enumerate(colls):
        if c.ranks == POD_GROUP:
            # the merge over model two places before (statistics, output)
            j = i - 2
            assert c.kind == colls[j].kind == "all-reduce"
            assert c.out_bytes == colls[j].out_bytes
            assert colls[j].ranks == (0, 1)


def test_small_mesh_records_price_nvlink():
    """A 2x2 mesh lies in one node: every byte on NVLink."""
    rec = dryrun.run_cell("mamba2-2.7b", "long_500k", mesh=lmesh(2, 2),
                          num_periods=1)
    assert_record(rec)
    c = rec["collectives"]
    assert c["by_link"]["network"] == 0 and c["by_link"]["nvlink"] > 0


# --------------------------------------------------------------------- #
# beside repro's 2x2 mini dry run (tests/test_launch.py)
# --------------------------------------------------------------------- #
MINI = """
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + sys.argv[1])
import ast
import jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.launch import hlo_stats, sharding as sh
from repro.training import trainer
from repro.training.optimizer import cosine_schedule, make_optimizer

cfg = smoke_config("qwen2.5-14b")
opt = make_optimizer("adamw", cosine_schedule(1e-3, 2, 10))
step = trainer.make_train_step(cfg, opt, remat=False)
state_sds = trainer.abstract_state(cfg, opt)
for sizes, batch in ast.literal_eval(sys.argv[2]):
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                       "model")
    kw = {}
    if hasattr(jax.sharding, "AxisType"):
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * len(sizes)
    n = 1
    for size in sizes:
        n *= size
    devs = jax.devices()[:n]
    mesh = jax.make_mesh(sizes, names, devices=devs, **kw)
    psh = sh.params_shardings(state_sds.params, mesh, cfg)
    state = trainer.TrainState(
        jax.ShapeDtypeStruct((), jnp.int32, sharding=sh.replicated(mesh)),
        sh.with_sharding(state_sds.params, psh),
        jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, s.dtype, sharding=sh.replicated(mesh)),
            state_sds.opt_state))
    tok = jax.ShapeDtypeStruct((batch, 16), jnp.int32,
                               sharding=sh.batch_sharding(mesh, 2, batch))
    with mesh:
        compiled = jax.jit(step).lower(state, (tok, tok)).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    st = hlo_stats.collect_collectives(compiled.as_text(), len(devs))
    print("MINI", sizes, repr(dict(
        temp=compiled.memory_analysis().temp_size_in_bytes,
        flops=ca["flops"], count=st.count, link=st.link_bytes)))
"""


def repro_mini(tmp_path, runs=(((2, 2), 4), ((1, 1), 4)), devices=4):
    """``repro``'s mini dry run (qwen2.5-14b smoke, train at ``batch`` x
    16, no remat; its optimizer state replicated) compiled by XLA for
    each ``(sizes, batch)`` of ``runs``, a mesh of ``(data, model)`` or
    ``(pod, data, model)`` forced host devices: temp bytes, FLOPs,
    collectives, one record a run in order."""
    import ast
    script = tmp_path / "mini.py"
    script.write_text(MINI)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    r = subprocess.run([sys.executable, str(script), str(devices),
                        repr(tuple(runs))], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=os.path.abspath(src),
                                JAX_PLATFORMS="cpu"))
    out = {}
    for line in r.stdout.splitlines():
        if line.startswith("MINI "):
            sizes, rec = line[5:].split(") ", 1)
            out[ast.literal_eval(sizes + ")")] = ast.literal_eval(rec)
    assert len(out) == len(runs), r.stderr[-2000:]
    return [out[sizes] for sizes, _ in runs]


def test_beside_repro_mini_dry_run(tmp_path):
    """``repro``'s 2x2 mini dry run against the port's partition of the
    same cell (its optimizer slots split as their parameters), each
    figure within a stated limit:

    * temp bytes within 25% of XLA's (the port's peak of live
      intermediates has no fusion and no buffer reuse beyond freeing);
    * the local share of the step's FLOPs at least an even share (1/4)
      and no more than XLA's (XLA's counts take in the elementwise ops,
      the port's the products, so shares are compared, not counts);
    * the link bytes of the all-reduces (the row-parallel products and
      the CE) and of the collective-permutes (the SwiGLU's halves) each
      within 25% of XLA's, and all link bytes within 1.5 times;
    * at least as many collectives as XLA's, which combines them.

    The kinds differ where the two move different tensors: at 64 tokens
    XLA moves activations (its all-to-alls) where the port gathers
    FSDP-split weights and reduce-scatters their gradients."""
    theirs, one = repro_mini(tmp_path)
    cfg = smoke_config("qwen2.5-14b")
    shape = InputShape("mini", "train", 16, 4)
    mesh = lmesh(2, 2)
    with tmesh.device_mesh(mesh) as dm:
        local = op_stats.count_cell(tspecs.input_specs(
            "qwen2.5-14b", shape, mesh, cfg=cfg, remat=False,
            partitioned=True, device_mesh=dm))
    total = op_stats.count_cell(tspecs.input_specs(
        "qwen2.5-14b", shape, lmesh(1, 1), cfg=cfg, remat=False)).flops
    port = op_stats.collect_collectives(local.collectives)
    assert set(local.rules) <= set(op_stats.RULES)
    assert local.peak_bytes == pytest.approx(theirs["temp"], rel=0.25)
    assert 0.25 <= local.flops / total <= theirs["flops"] / one["flops"]
    for op in ("all-reduce", "collective-permute"):
        assert port.link_bytes[op] == pytest.approx(theirs["link"][op],
                                                    rel=0.25), op
    repro_link = sum(theirs["link"].values())
    assert repro_link <= port.total_link_bytes <= 1.5 * repro_link
    assert sum(port.count.values()) >= sum(theirs["count"].values())


def test_beside_repro_three_axis_mini(tmp_path):
    """``repro``'s mini dry run on 2x2x2 forced host devices at batch 8
    (and on 2x2 at batch 4, one pod's block; 1x1 at batch 8 for the
    FLOPs share) against the port's pod-local partition of it, within
    stated limits:

    * the local share of the FLOPs at least an even share (1/8) and no
      more than XLA's;
    * the all-reduces' link bytes (the row-parallel products, the CE,
      and now the gradients merged across the pods) within 25% of
      XLA's, and all link bytes within 1.5 times either way;
    * temp bytes between 0.75 times XLA's 2x2 figure at batch 4 (the
      port's pod-local program is that cell) and XLA's 2x2x2 figure:
      XLA also gathers activations across the pods (the logits over
      ``{0,2,4,6}``, for one), which the specs do not ask for, and its
      temp grows over 2x2's at the same batch a pod."""
    theirs, block, one = repro_mini(
        tmp_path, runs=(((2, 2, 2), 8), ((2, 2), 4), ((1, 1), 8)),
        devices=8)
    cfg = smoke_config("qwen2.5-14b")
    shape = InputShape("mini", "train", 16, 8)
    mesh = lmesh(*POD3)
    with tmesh.device_mesh(tmesh.pod_block(mesh)) as dm:
        local = op_stats.count_cell(tspecs.input_specs(
            "qwen2.5-14b", shape, mesh, cfg=cfg, remat=False,
            partitioned=True, device_mesh=dm))
    total = op_stats.count_cell(tspecs.input_specs(
        "qwen2.5-14b", shape, lmesh(1, 1), cfg=cfg, remat=False)).flops
    port = op_stats.collect_collectives(local.collectives)
    assert split_by_pod(local.collectives)[0]
    assert 1 / 8 <= local.flops / total <= theirs["flops"] / one["flops"]
    assert port.link_bytes["all-reduce"] == pytest.approx(
        theirs["link"]["all-reduce"], rel=0.25)
    repro_link = sum(theirs["link"].values())
    assert repro_link / 1.5 <= port.total_link_bytes <= 1.5 * repro_link
    assert 0.75 * block["temp"] <= local.peak_bytes <= theirs["temp"]


def test_attention_on_local_blocks():
    """``op_stats.partitioned_mha`` runs attention on each shard's block:
    at 1x4 the smoke cell's 2 KV heads are fewer than the shards, so K
    and V are gathered over ``model`` and each shard keeps the KV head of
    its one query head; the attention products' FLOPs are a quarter of
    the whole (at 1x2 the heads split with no collective); decode splits
    the cache's sequence, and merges the partial outputs and their
    softmax statistics by all-reduces over ``model``."""
    whole_bmm = whole("prefill").by_op["aten.bmm"]
    for sizes in ((1, 2), (1, 4)):
        local = partitioned("prefill", sizes)
        assert local.by_op["aten.bmm"] * lmesh(*sizes).size == whole_bmm
    kinds = [(c.kind, c.out_bytes) for c in
             partitioned("prefill", (1, 4)).collectives]
    f32, tokens = 4, 4 * 64
    assert kinds.count(("all-gather", tokens * 32 * f32)) == 2   # K, V
    dec = partitioned("decode", (1, 2))
    assert dec.by_op["aten.bmm"] * 2 == whole("decode").by_op["aten.bmm"]
    merges = [c for c in dec.collectives if c.kind == "all-reduce"]
    # the outputs (4 x 1 x 4 heads x 16) and the statistics (4 x 1 x 4 x 2)
    assert [(c.out_bytes) for c in merges][:2] == [4 * 4 * 2 * f32,
                                                   4 * 4 * 16 * f32]


def test_moe_experts_sum_to_the_whole():
    """``apply_moe(experts=(lo, hi))`` computes one expert-parallel
    shard's part: the parts of the shards of ``model`` sum to the whole
    MoE (``op_stats.partitioned_moe`` all-reduces them), and each part
    computes only its experts' products."""
    import types
    cfg = tspecs.reduced_config(smoke_config("llama4-scout-17b-a16e"), 1)
    model = build_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    moe = next(l.ffn for l in model.layers if hasattr(l.ffn, "router"))
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    from repro_torch.models import layers as L
    whole_y, whole_aux = L.apply_moe(moe, cfg, x)
    E, n = cfg.num_experts, 2
    parts = []
    for j in range(n):
        lo, hi = j * E // n, (j + 1) * E // n
        part = types.SimpleNamespace(router=moe.router, wi=moe.wi[lo:hi],
                                     wo=moe.wo[lo:hi])
        y, aux = L.apply_moe(part, cfg, x, experts=(lo, hi))
        assert torch.equal(aux, whole_aux)
        parts.append(y)
    torch.testing.assert_close(parts[0] + parts[1], whole_y, rtol=1e-5,
                               atol=1e-6)
