"""The decode mesh over processes: one gloo rank a ``(data, model)``
shard, spawned by ``distributed.launch.spawn_ranks`` with a ``FileStore``
in ``tmp_path``, one torch thread a rank.

Each rank holds only its own slab of the KV pool and runs only its own
shard of the step; the cross-shard merge rows and the model sum travel
as slot gathers.  ``test_torch_mesh_engine.py``'s workload (``repro``'s
``SHARDED_PARITY``, copied into ``torch_process_mesh_cases`` for the
ranks, which never import ``jax``) runs on every rank of a 1x1, 2x1,
1x2 and 2x2 mesh, each mesh spawned once with all its cases: greedy and
at temperature 0.7 the streams of every rank must equal ``repro``'s
eager ``codec-xla`` streams (built here in the parent, as that file
builds them) and the port's single-controller mesh's, byte for byte;
the same with replication (under ``TPU_PRIORS``), under pressure and
replicated under pressure.  No rank leaks a page, and each rank's pool
holds ``1 / (D * M)`` of the single-controller pool's bytes.
``calibrate=True`` fits the same coefficients on every rank;
``repro``'s ``ARCH_SWEEP`` models match at 2x1; the prefix cache,
cascade prefill and telemetry match the single-controller mesh.  A rank
fed another request, or whose fault injector fires otherwise, makes
every rank raise ``MeshDivergenceError``; a world of the wrong size, an
uninitialized group, a mesh on another device and the refused options
raise.

Deadlines, queue timeouts and fault plans (ROADMAP C5, repaired): on
2x1 and 2x2 meshes each rank reads a fake clock of its own rate and
origin, and rank 0's reading, broadcast, decides; the deadline workload
and two fault plans (one spec of every kind, parsed, and a seeded
schedule) give every rank the streams, terminal states, counters, step
decisions and callbacks of the single-controller mesh fed rank 0's
clock.  At 2x1 the deadline workload and the parsed plan also run on
``repro``'s mesh engine (fused, ``codec-xla``, two forced host devices,
in a subprocess).
"""

import inspect
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.distributed as dist

import test_torch_mesh_engine as single
import torch_process_mesh_cases as cases
from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.distributed import decode_mesh
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.distributed.launch import spawn_ranks
from torch_threads import one_torch_thread  # noqa: F401

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
# the cases each mesh's spawn runs (test_torch_mesh_engine's, by mesh)
MESH_CASES = {
    (1, 1): ["greedy", "t0.7"],
    (2, 1): ["greedy", "t0.7", "rep-greedy", "rep-t0.7", "rep-pressured",
             "cache-cascade-telemetry"],
    (1, 2): ["greedy", "t0.7"],
    (2, 2): ["greedy", "t0.7", "rep-greedy", "rep-t0.7", "pressured",
             "calibrate"],
}
SPAWN_TIMEOUT = 240
mesh_ids = [f"{d}x{m}" for d, m in MESHES]
# the meshes whose spawn also runs the deadline and fault workloads
C5_MESHES = [(2, 1), (2, 2)]
C5_RUNS = ["deadlines"] + list(cases.FAULT_PLANS)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    return JT.init_params(cases.CFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def npz(params, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "qwen.npz"
    cases.save_params(path, jax.tree.map(np.asarray, params))
    return str(path)


@pytest.fixture(scope="module")
def repro_streams(params):
    out = {}
    for temperature in (0.0, 0.7):
        eng = JaxEngine(cases.CFG, params, page_size=8, num_pages=256,
                        backend="codec-xla", max_q=8,
                        temperature=temperature)
        out[temperature] = cases.drive(eng)
    return out


@pytest.fixture(scope="module")
def spawns(npz, tmp_path_factory):
    """Each mesh spawned once, every case of it inside the spawn."""
    tmp = tmp_path_factory.mktemp("stores")
    out = {}
    for d, m in MESHES:
        out[d, m] = spawn_ranks(
            cases.rank_main, d, m, "gloo", str(tmp / f"{d}x{m}"),
            device="cpu", args=(npz, MESH_CASES[d, m], (d, m) == (2, 1),
                                (d, m) in C5_MESHES),
            timeout=SPAWN_TIMEOUT)
    return out


@pytest.fixture(scope="module")
def controller(npz):
    """The single-controller mesh's run of every case, by mesh."""
    model = cases.load_model(npz)
    return {(d, m): {c: cases.run_case(model, decode_mesh(d, m, "cpu"), c)
                     for c in MESH_CASES[d, m]} for d, m in MESHES}


@pytest.fixture(scope="module")
def controller_c5(npz):
    """The single-controller mesh's deadline and fault runs, fed rank
    0's clock."""
    model = cases.load_model(npz)
    return {(d, m): cases.c5_runs(model, decode_mesh(d, m, "cpu"))
            for d, m in C5_MESHES}


# ``repro``'s mesh engine at 2x1 (fused, codec-xla) on the deadline
# workload and the parsed fault plan, on two forced host devices
REPRO_MESH = textwrap.dedent("""\
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    from repro.distributed import decode_mesh
    from repro.models import transformer as JT
    from repro.serving.engine import DecodeEngine
    from repro.serving.faults import FaultPlan
    import torch_process_mesh_cases as cases

    params = JT.init_params(cases.CFG, jax.random.PRNGKey(0))

    def make(**kw):
        return DecodeEngine(cases.CFG, params, page_size=8, num_pages=256,
                            backend="codec-xla", max_q=8, fused=True,
                            mesh=decode_mesh(2, 1), seq_split_pages=2, **kw)
    out = {"deadlines": cases.wl_deadlines(make, cases.rank_clock(0)),
           "parsed": cases.wl_faults(
               make, FaultPlan.parse(cases.FAULT_PLANS["parsed"]))}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def repro_mesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("repro_mesh")
    script, result = tmp / "repro_mesh.py", tmp / "out.pkl"
    script.write_text(REPRO_MESH)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, str(script), str(result)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(result, "rb") as f:
        return pickle.load(f)


def rank_case(spawns, mesh, case):
    return [r["cases"][case] for r in spawns[mesh]]


def test_rank_is_jax_row_major_device_order():
    for D, M in MESHES + [(4, 2), (2, 4), (16, 1)]:
        grid = np.arange(D * M).reshape(D, M)
        by_m, by_d = mesh_mod.group_ranks(D, M)
        for r in range(D * M):
            d, m = mesh_mod.rank_coords(r, M)
            assert grid[d, m] == r
        assert by_m == [list(grid[:, m]) for m in range(M)]
        assert by_d == [list(grid[d]) for d in range(D)]


def test_uninitialized_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized"):
        mesh_mod.process_mesh(1, 1, device="cpu")


def test_ranks_run_the_mesh_engine_workload():
    """The ranks' copy of the workload is ``test_torch_mesh_engine``'s."""
    assert (cases.CFG, cases.PROMPTS, cases.LATE, cases.TPU_PRIORS) == (
        single.CFG, single.PROMPTS, single.LATE, single.TPU_PRIORS)
    body = inspect.getsource(cases.drive)
    assert body == inspect.getsource(single.drive)


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "t0.7"])
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_ids)
def test_process_mesh_streams_equal_repro(spawns, controller, repro_streams,
                                          mesh, temperature):
    case = "greedy" if temperature == 0.0 else "t0.7"
    want = repro_streams[temperature]
    assert controller[mesh][case]["streams"] == want
    for rank, got in enumerate(rank_case(spawns, mesh, case)):
        assert got["streams"] == want, (mesh, rank)
        assert got["stats"]["replica_promotions"] == 0


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "t0.7"])
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_replicated_process_mesh_streams_equal_repro(
        spawns, controller, repro_streams, mesh, temperature):
    case = "rep-greedy" if temperature == 0.0 else "rep-t0.7"
    for got in rank_case(spawns, mesh, case):
        assert got["streams"] == repro_streams[temperature]
        assert got["streams"] == controller[mesh][case]["streams"]
        assert got["stats"]["replica_promotions"] >= 1, got["stats"]


@pytest.mark.parametrize("mesh,case", [((2, 2), "pressured"),
                                       ((2, 1), "rep-pressured")],
                         ids=["2x2", "2x1-replicated"])
def test_pressured_process_mesh_equals_repro(spawns, controller,
                                             repro_streams, mesh, case):
    for got in rank_case(spawns, mesh, case):
        st = got["stats"]
        assert got["streams"] == repro_streams[0.0]
        assert got["streams"] == controller[mesh][case]["streams"]
        assert st["prefill_chunks"] >= 1, st
        assert st == controller[mesh][case]["stats"] | {
            k: st[k] for k in st if k.endswith("_time")}
    if case == "pressured":
        assert st["preempted"] >= 1, st


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_ids)
def test_rank_pool_holds_its_share_and_leaks_nothing(spawns, controller,
                                                     mesh):
    d, m = mesh
    for rank, r in enumerate(spawns[mesh]):
        assert r["coords"] == mesh_mod.rank_coords(rank, m)
        for case, got in r["cases"].items():
            want = controller[mesh][case]["pool_bytes"]
            assert got["pool_bytes"] * d * m == want, (case, rank)
            assert all(got["free"]), (case, rank, "leaked pages")
            assert got["forest"] == [0], (case, rank, "leaked nodes")
            # gloo: every step ran uncaptured, and said so
            assert got["graph"] and not any(got["graph"]), case
            assert got["collectives"] > 0


def test_calibrated_process_mesh_fits_alike(spawns, controller,
                                            repro_streams):
    runs = rank_case(spawns, (2, 2), "calibrate")
    for got in runs:
        assert got["streams"] == repro_streams[0.0]
        assert got["fitted"] and got["calibrations"] >= 1
        assert got["hw"] == runs[0]["hw"]
    assert controller[2, 2]["calibrate"]["fitted"]


@pytest.mark.parametrize("arch,page", cases.ARCHS,
                         ids=[a for a, _ in cases.ARCHS])
def test_arch_sweep_on_a_2x1_process_mesh(spawns, arch, page):
    want = cases.arch_streams(arch, page, decode_mesh(2, 1, "cpu"))
    assert want == cases.arch_streams(arch, page, None)
    for r in spawns[2, 1]:
        assert r["archs"][arch] == want, arch


def test_cache_cascade_telemetry_on_a_process_mesh(spawns, controller):
    """The prefix cache, cascade prefill and telemetry move KV only
    through the pool's methods: a rank's run is the single controller's,
    streams and counters."""
    case = "cache-cascade-telemetry"
    want = controller[2, 1][case]
    st = want["stats"]
    assert st["prefill_chunks"] >= 1 and st["cascade_batches"] >= 1, st
    assert want["cache_hits"] >= 1 and len(want["streams"]["again"]) == 3
    for got in rank_case(spawns, (2, 1), case):
        assert got["streams"] == want["streams"]
        assert got["cache_hits"] == want["cache_hits"]
        for k, v in want["stats"].items():
            if not k.endswith("_time"):
                assert got["stats"][k] == v, k


@pytest.mark.parametrize("mesh", MESHES, ids=mesh_ids)
def test_slot_gather_is_exact(spawns, mesh):
    """NaN, -1e30, -0.0, inf and seeded values in f32 and bf16 come back
    bit for bit over every axis."""
    assert all(r["slot_gather_exact"] for r in spawns[mesh])


def _diverge(npz, tmp_path, what):
    got = spawn_ranks(cases.rank_diverge, 2, 1, "gloo",
                      str(tmp_path / "store"), device="cpu",
                      args=(npz, what), timeout=SPAWN_TIMEOUT)
    for name, msg in got:
        assert name == "MeshDivergenceError", msg
        assert "plan epoch" in msg
    return got


def test_divergent_rank_raises_on_every_rank(npz, tmp_path):
    _diverge(npz, tmp_path, "request")


def test_divergent_fault_plan_raises_on_every_rank(npz, tmp_path):
    """Rank 1's plan holds a stall that rank 0's lacks: only the faults
    fired differ, and the plan epoch's digest holds them."""
    _diverge(npz, tmp_path, "faults")


def test_lone_context_gather_raises_on_every_rank(npz, tmp_path):
    """C6: rank 1 alone gathers a prefill's context (its late request
    reuses the document, rank 0's shares nothing).  The gather's guard
    meets rank 0's plan-epoch agree: both ranks raise, naming the two
    collectives, in seconds rather than at the group's timeout."""
    t0 = time.perf_counter()
    got = _diverge(npz, tmp_path, "gather")
    assert time.perf_counter() - t0 < SPAWN_TIMEOUT / 4
    for _, msg in got:
        assert "two collectives, the plan epoch and gather_context" in msg


@pytest.fixture(scope="module")
def refusals(npz, tmp_path_factory):
    store = tmp_path_factory.mktemp("refusals") / "store"
    return spawn_ranks(cases.rank_refusals, 1, 1, "gloo", str(store),
                       device="cpu", args=(npz,),
                       timeout=SPAWN_TIMEOUT)[0]


@pytest.mark.parametrize("what,error", [
    ("wrong_world", "ValueError"), ("device_mismatch", "ValueError"),
    ("speculative", "ValueError"), ("nan_guard", "ValueError"),
    ("eager", "ValueError")])
def test_process_mesh_refuses(refusals, what, error):
    assert refusals[what] == error


@pytest.mark.parametrize("what", ["deadline", "max_queue", "faults"])
def test_process_mesh_takes_deadlines_and_faults(refusals, what):
    assert refusals[what] is None


def _assert_c5_equal(got, want, tag):
    for key in ("streams", "states", "stats", "trace", "on_token",
                "on_done", "free"):
        assert got[key] == want[key], (tag, key)
    assert all(got["free"]), (tag, "leaked pages")


@pytest.mark.parametrize("mesh", C5_MESHES, ids=["2x1", "2x2"])
def test_deadlines_on_rank_skewed_clocks(spawns, controller_c5, mesh):
    """Each rank's clock runs at its own rate from its own origin; rank
    0's reading decides, so every rank times out, queues out and admits
    as the single controller fed rank 0's clock does."""
    want = controller_c5[mesh]["deadlines"]
    why = {w for _, w in want["states"].values()}
    assert {"deadline", "queue_timeout", "done"} <= why, want["states"]
    assert want["stats"]["timed_out"] == 2, want["stats"]
    for rank, r in enumerate(spawns[mesh]):
        got = r["c5"]["deadlines"]
        _assert_c5_equal(got, want, (mesh, rank))
        assert got["queue"] == want["queue"]


@pytest.mark.parametrize("plan", list(cases.FAULT_PLANS))
@pytest.mark.parametrize("mesh", C5_MESHES, ids=["2x1", "2x2"])
def test_fault_plans_on_a_process_mesh(spawns, controller_c5, mesh, plan):
    """Every rank builds the same injector from the plan: each fault
    fires at the same seam on every rank, and the outcome is the single
    controller's."""
    want = controller_c5[mesh][plan]
    st = want["stats"]
    assert st["faults_injected"] >= 1, st
    if plan == "parsed":
        assert {k for k, n in want["fired"].items() if n} == {
            "alloc", "dispatch", "stall", "callback", "nan_logits"}, \
            want["fired"]
        assert st["dispatch_failures"] == 2 and st["callback_errors"] == 1
    for rank, r in enumerate(spawns[mesh]):
        got = r["c5"][plan]
        _assert_c5_equal(got, want, (mesh, plan, rank))
        assert got["fired"] == want["fired"]


@pytest.mark.parametrize("run", ["deadlines", "parsed"])
def test_c5_runs_equal_repro_mesh(spawns, controller_c5, repro_mesh, run):
    """At 2x1 the single controller and every rank equal ``repro``'s
    mesh engine on the deadline workload and the parsed fault plan."""
    want = repro_mesh[run]
    for got in [controller_c5[2, 1][run]] + [
            r["c5"][run] for r in spawns[2, 1]]:
        _assert_c5_equal(got, want, run)


def test_process_mesh_device_defaults_to_the_local_card(refusals):
    assert refusals["default_device"] == "cuda:0"
