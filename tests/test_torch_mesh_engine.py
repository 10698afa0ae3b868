"""Mesh serving: the port's mesh engine against ``repro``'s single-device
eager engine on the same weights.

``repro``'s ``SHARDED_PARITY`` workload (``tests/test_sharded.py``):
``qwen2.5-14b`` at smoke widths, a 48-token document (6 pages of 8)
shared by four requests, a late arrival after two steps, a node quota of
2 pages a data shard (so the document spans the data shards).  At 1x1,
2x1, 1x2 and 2x2, greedy and at temperature 0.7, the port's mesh engine
(``codec-cuda``, fused; its plain versions on the CPU) must give the
streams of ``repro``'s eager ``codec-xla`` engine, which runs once per
temperature (cached in the module).  The same with replication (under
the JAX package's TPU priors, one ``HardwareSpec`` on the port's cost
model, which make the hot document worth copying), and on the 2x2 mesh
under pressure (10 pages, 8-token prefill chunks: a preemption), and on
2x1 with replication under pressure.  Every run leaks no page on any
shard and captures no more step states than signatures.  The weights
come through ``weights.from_jax_params``, unchanged: the mesh shares the
model's weights and slices the head blocks at run time.

Then, port-only, after ``repro``'s ``ARCH_SWEEP``: ``gemma3-1b``
(sliding-window layers), ``jamba`` (hybrid attention and Mamba) and
``mamba2`` (attention-free) at smoke widths through a 2x1 mesh equal the
port's single-device fused engine (fused: the MoE capacity follows the
step's row bucket, as the ROADMAP's trap says).
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.configs import smoke_config
from repro_torch.core.cost_model import HardwareSpec
from repro_torch.distributed import decode_mesh
from repro_torch.models.transformer import Transformer, build_model
from repro_torch.serving.engine import DecodeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = smoke_config("qwen2.5-14b")
DOC = list(range(10, 58))                      # 6-page shared prefix
PROMPTS = [DOC + [100 + 3 * i + j for j in range(3)] for i in range(4)]
LATE = DOC + [250, 251]                        # arrives mid-decode
# the JAX package's TPU priors, as one explicit HardwareSpec
TPU_PRIORS = HardwareSpec(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
                          grid_step_overhead=1e-6, launch_overhead=5e-6)


def drive(eng):
    rids = [eng.add_request(p, max_new=6) for p in PROMPTS]
    eng.step()
    eng.step()
    rids.append(eng.add_request(LATE, max_new=4))
    eng.run(96)
    outs = {i: list(eng.requests[r].generated) for i, r in enumerate(rids)}
    assert all(len(outs[i]) == eng.requests[r].max_new
               for i, r in enumerate(rids)), "unfinished requests"
    return outs


@pytest.fixture(scope="module")
def shared():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        CFG, from_jax_params(CFG, jax.tree.map(np.asarray, params)))
    return params, model


@pytest.fixture(scope="module")
def repro_streams(shared):
    params, _ = shared
    out = {}
    for temperature in (0.0, 0.7):
        eng = JaxEngine(CFG, params, page_size=8, num_pages=256,
                        backend="codec-xla", max_q=8,
                        temperature=temperature)
        out[temperature] = drive(eng)
    return out


def run_mesh(model, d, m, temperature=0.0, num_pages=256,
             prefill_chunk=None, replicate=False):
    eng = DecodeEngine(CFG, model, page_size=8, num_pages=num_pages,
                       backend="codec-cuda", max_q=8,
                       temperature=temperature, fused=True,
                       mesh=decode_mesh(d, m, device="cpu"),
                       seq_split_pages=2, prefill_chunk=prefill_chunk,
                       replicate=replicate, device="cpu")
    if replicate:
        eng.cost_model.hw = TPU_PRIORS
    outs = drive(eng)
    stats = dict(eng.stats)
    stats["seq_splits"] = sum(sp.seq_splits
                              for sp in eng._sharded_plans.values())
    assert eng.fused_cache_size <= len(eng.bucket_signatures)
    assert eng.fused_step.replays == eng.stats["steps"]
    eng.check()
    for r in list(eng.requests):
        eng.release(r)
    for s in eng.pool.allocator.shards:
        assert s.num_free == s.num_pages, "leaked pages on a shard"
    eng.pool.allocator.check()
    assert set(eng.forest.nodes) == {0}, "leaked forest nodes"
    return outs, stats, eng


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "t0.7"])
@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_streams_equal_repro(shared, repro_streams, mesh, temperature):
    d, m = mesh
    got, st, eng = run_mesh(shared[1], d, m, temperature)
    assert got == repro_streams[temperature]
    if d > 1:
        assert st["seq_splits"] >= 1, "no sequence split"
        assert any(sig[-1] != ("merge", 0) for sig in eng.bucket_signatures)
    else:
        assert all(sig[-1] == ("merge", 0) for sig in eng.bucket_signatures)
    assert st["replica_promotions"] == 0


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "t0.7"])
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_replicated_mesh_streams_equal_repro(shared, repro_streams, mesh,
                                             temperature):
    got, st, _ = run_mesh(shared[1], *mesh, temperature, replicate=True)
    assert got == repro_streams[temperature]
    assert st["replica_promotions"] >= 1, st


def test_pressured_2x2_mesh_equals_repro(shared, repro_streams):
    got, st, _ = run_mesh(shared[1], 2, 2, num_pages=10, prefill_chunk=8)
    assert got == repro_streams[0.0]
    assert st["preempted"] >= 1 and st["prefill_chunks"] >= 1, st


def test_pressured_replicated_mesh_equals_repro(shared, repro_streams):
    got, _, _ = run_mesh(shared[1], 2, 1, num_pages=12, prefill_chunk=8,
                         replicate=True)
    assert got == repro_streams[0.0]


def test_calibrated_mesh_records_features(shared, repro_streams):
    """``calibrate=True``: every mesh step records its epoch's features,
    the fit runs at plan epochs and installs coefficients once it has
    enough steps, and the streams stay ``repro``'s."""
    eng = DecodeEngine(CFG, shared[1], page_size=8, num_pages=256,
                       backend="codec-cuda", max_q=8, fused=True,
                       mesh=decode_mesh(2, 2, device="cpu"),
                       seq_split_pages=2, calibrate=True, device="cpu")
    got = drive(eng)
    assert got == repro_streams[0.0]
    rows = [s for s in eng.step_stats if s.get("hbm_bytes")]
    assert rows and all(s["merge_rounds"] > 0 for s in rows
                        if s["merge_bytes"])
    assert eng.predicted_step_seconds() > 0
    for _ in range(12):          # enough measured steps for a fit
        eng.step_stats += rows
    assert eng.recalibrate()
    assert eng.stats["calibrations"] >= 1 and eng.cost_model.calibrated


@pytest.mark.parametrize("arch,page", [("gemma3-1b", 16),
                                       ("jamba-v0.1-52b", 8),
                                       ("mamba2-2.7b", 8)])
def test_arch_sweep_on_a_2x1_mesh(arch, page):
    cfg = smoke_config(arch)
    model = build_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    doc = list(range(10, 10 + 64))
    prompts = [doc + [100 + i, 101 + i] for i in range(2)]
    outs = {}
    for mesh in (None, decode_mesh(2, 1, device="cpu")):
        eng = DecodeEngine(cfg, model, page_size=page, num_pages=64,
                           backend="codec-cuda", max_q=8, fused=True,
                           mesh=mesh, seq_split_pages=2 if mesh else 0,
                           device="cpu")
        for p in prompts:
            eng.add_request(p, max_new=4)
        outs[mesh is None] = eng.run(12)
        eng.pool.allocator.check()
    assert outs[True] == outs[False], (arch, outs)


def test_weights_serve_the_mesh_unchanged(shared):
    """``weights.from_jax_params`` feeds the mesh as it feeds one shard:
    the engine keeps the model's own tensors (no per-shard copy) and
    slices each model shard's head block at run time."""
    model = shared[1]
    eng = DecodeEngine(CFG, model, page_size=8, num_pages=64, fused=True,
                       mesh=decode_mesh(1, 2, device="cpu"), device="cpu")
    assert eng.model is model
    got = dict(eng.model.named_parameters())
    for name, p in model.named_parameters():
        assert got[name].data_ptr() == p.data_ptr(), name
    assert eng.pool.k.shape[0] == 2 and eng.pool.kv_shape == (
        CFG.num_kv_heads, CFG.head_dim)


@pytest.mark.parametrize("replicate", [False, True],
                         ids=["split", "replicated"])
def test_mesh_telemetry_counts_merges_and_replicas(shared, repro_streams,
                                                   replicate):
    """With telemetry on, each decode step of a mesh adds its epoch's
    merge bytes and rounds to the registry (as ``repro``'s step hook
    does), and the replica counters follow the engine's stats: the split
    document merges every step; replicated under the TPU priors, every
    row's path is replicated and nothing crosses shards."""
    eng = DecodeEngine(CFG, shared[1], page_size=8, num_pages=256,
                       backend="codec-cuda", max_q=8, fused=True,
                       mesh=decode_mesh(2, 1, device="cpu"),
                       seq_split_pages=2, replicate=replicate,
                       telemetry=True, device="cpu")
    if replicate:
        eng.cost_model.hw = TPU_PRIORS
    assert drive(eng) == repro_streams[0.0]
    reg = eng.publish_metrics()
    decoded = [s for s in eng.step_stats if s["decoded"]]
    assert reg["merge_bytes"].value == sum(s["merge_bytes"]
                                           for s in decoded)
    assert reg["merge_rounds"].value == sum(s["merge_rounds"]
                                            for s in decoded)
    assert (reg["merge_bytes"].value > 0) != replicate
    assert reg["replica_promotions"].value \
        == eng.stats["replica_promotions"]
    assert (eng.stats["replica_promotions"] > 0) == replicate
    assert reg["calibrations"].value == 0
