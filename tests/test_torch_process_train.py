"""Training over processes: one gloo rank a ``(data, model)`` shard,
spawned by ``distributed.launch.spawn_ranks`` with a ``FileStore`` in
``tmp_path``, one torch thread a rank, at ``smoke_config`` widths.

Rank ``(d, m)`` draws data shard ``d``'s rows, gathers each microbatch's
gradient over its data group and sums the contributions in shard order
(``distributed.train_step.make_rank_train_step``).  At 2x1, 1x2 and 2x2,
for ``qwen3-4b`` and ``llama4-scout`` (so that ``moe_aux`` travels), at
one and at two microbatches a rank, every rank's losses, gradient norms,
``ce``, ``moe_aux``, final weights and optimizer state equal the single
controller's (``launch/train.py --data D``: the shards in turn as
``D x microbatches`` microbatches of the global batch) bit for bit; at
2x1 the metrics are within 1e-5 of ``repro``'s step at ``microbatches =
2`` on the same global batch, and the weights within its state bound.
A checkpoint saved over the mesh is the one-process save's, array by
array; the launcher over processes resumes, stops every rank on one
rank's SIGTERM and restarts elastically (rank 1 leaving) with the single
controller's history; a rank fed another batch makes every rank raise
``MeshDivergenceError``; a mesh of the wrong size raises; the CLI runs
under ``torch.distributed.run`` with two gloo ranks.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_process_mesh_cases as mesh_cases
import torch_process_train_cases as cases
from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro.training import trainer as JTr
from repro_torch.configs import smoke_config
from repro_torch.distributed.launch import spawn_ranks
from repro_torch.distributed.train_step import buckets
from repro_torch.training import checkpoint as ckpt
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(2, 1), (1, 2), (2, 2)]
mesh_ids = [f"{d}x{m}" for d, m in MESHES]
# (arch, microbatches a rank, gather buffer bytes: None for the default,
# which holds a smoke model's gradient in one bucket a dtype; 6000 B
# cuts it into many and leaves across them)
RUNS = [(arch, mb, None) for arch in cases.ARCHS for mb in (1, 2)] + [
    ("qwen3-4b", 2, 6000)]
SPAWN_TIMEOUT = 240


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def npzs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("weights")
    out = {}
    for arch, name in cases.ARCHS.items():
        params = JT.init_params(jax_smoke_config(name),
                                jax.random.PRNGKey(0))
        out[arch] = str(tmp / f"{arch}.npz")
        mesh_cases.save_params(out[arch], jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return tmp_path_factory.mktemp("stores")


@pytest.fixture(scope="module")
def spawns(npzs, stores):
    return {(d, m): spawn_ranks(cases.rank_steps, d, m, "gloo",
                                str(stores / f"steps{d}x{m}"), device="cpu",
                                args=(npzs, RUNS), timeout=SPAWN_TIMEOUT)
            for d, m in MESHES}


@pytest.fixture(scope="module")
def controller(npzs):
    return {(d, arch, mb): cases.controller_steps(npzs[arch], arch, d, mb)
            for d in (1, 2) for arch, mb in {(a, m) for a, m, _ in RUNS}}


@pytest.mark.parametrize("arch,mb,bucket", RUNS, ids=[
    f"{a}-mb{mb}" + (f"-{b}B" if b else "") for a, mb, b in RUNS])
@pytest.mark.parametrize("mesh", MESHES, ids=mesh_ids)
def test_rank_steps_equal_the_single_controller(spawns, controller, mesh,
                                                arch, mb, bucket):
    hist, tree = controller[mesh[0], arch, mb]
    assert all(np.isfinite(h["loss"]) for h in hist)
    if arch == "llama4-scout":
        assert all(h["moe_aux"] > 0 for h in hist), hist
    for rank, r in enumerate(spawns[mesh]):
        got_hist, got_tree = r[arch, mb, bucket]
        assert got_hist == hist, (mesh, rank)
        assert got_tree.keys() == tree.keys()
        for k, v in tree.items():
            assert _equal(got_tree[k], v), (mesh, rank, k)


def test_rank_steps_within_repro(spawns, npzs):
    """2x1, one microbatch a rank: ``repro``'s step at ``microbatches =
    2`` on the global batch, three steps: the metrics within 1e-5, the
    weights as ``test_torch_train_step`` holds a state after N steps."""
    name = cases.ARCHS["qwen3-4b"]
    jcfg, cfg = jax_smoke_config(name), smoke_config(name)
    jopt = JO.adamw(JO.cosine_schedule(cases.LR, cases.WARMUP, cases.TOTAL))
    with np.load(npzs["qwen3-4b"]) as z:
        flat = {k: z[k] for k in z.files}
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat["/".join(str(k.key) for k in p)]),
        jparams)
    state = JTr.TrainState(jnp.zeros((), jnp.int32), jparams,
                           jopt.init(jparams))
    jstep = jax.jit(JTr.make_train_step(jcfg, jopt, microbatches=2,
                                        remat=False))
    want = []
    for tokens, labels in cases.batches(cfg):
        state, met = jstep(state, (jnp.asarray(tokens.numpy()),
                                   jnp.asarray(labels.numpy())))
        want.append({k: float(v) for k, v in met.items()})
    jw = from_jax_params(cfg, jax.tree.map(np.asarray, state.params))
    for got_hist, got_tree in (r["qwen3-4b", 1, None]
                               for r in spawns[2, 1]):
        for g, w in zip(got_hist, want):
            for k in ("loss", "grad_norm", "ce", "moe_aux"):
                assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, g, w)
        n = off = 0
        for k, v in jw.items():
            d = np.abs(got_tree[f"params/{k}"] - v.numpy())
            assert d.max() <= 2 * cases.LR * cases.STEPS, (k, d.max())
            off += int(np.sum(d > 1e-5 * np.abs(v.numpy())
                              + 1e-6 * cases.LR * cases.STEPS))
            n += d.size
        assert off <= 1e-3 * n, (off, n)


@pytest.mark.parametrize("arch", list(cases.ARCHS))
def test_buckets_cover_every_gradient_element_once(npzs, arch):
    """``train_step.buckets``: every element of every leaf in exactly one
    segment, one dtype a bucket, each slot a whole number of words and
    within the byte budget (a leaf larger than a bucket cut across
    several)."""
    cfg = smoke_config(cases.ARCHS[arch])
    f32 = cases.load_params(npzs[arch], cfg)
    # bf16 weights with the router kept float32, as init_params gives
    bf16 = {k: v if "router" in k else v.bfloat16() for k, v in f32.items()}
    for params, slots, budget in ((f32, 1, 6000), (f32, 4, 6000),
                                  (bf16, 3, 6002), (f32, 2, 1 << 28)):
        seen = {k: np.zeros(p.numel(), int) for k, p in params.items()}
        plan = buckets(params, slots, budget)
        for dtype, size, segs in plan:
            item = params[segs[0][0]].element_size()
            assert size * item % 4 == 0
            assert slots * size * item <= max(budget, slots * 4)
            fill = 0
            for k, lo, hi, off in segs:
                assert params[k].dtype == dtype and off == fill
                seen[k][lo:hi] += 1
                fill += hi - lo
            assert fill <= size
        assert all((v == 1).all() for v in seen.values())
        if budget < 1 << 20:
            assert len(plan) > len({d for d, _, _ in plan})


def test_checkpoint_over_the_mesh_is_the_one_process_save(npzs, stores,
                                                          tmp_path):
    got = spawn_ranks(cases.rank_save, 2, 1, "gloo", str(stores / "save"),
                      device="cpu", args=(npzs["qwen3-4b"],
                                          str(tmp_path / "mesh")),
                      timeout=SPAWN_TIMEOUT)
    assert got == [2, 2]
    cases.controller_save(npzs["qwen3-4b"], 2, str(tmp_path / "one"))
    dirs = [tmp_path / name / "step_000002" for name in ("mesh", "one")]
    man = [json.loads((d / "MANIFEST.json").read_text()) for d in dirs]
    for m in man:
        m.pop("time")
    assert man[0] == man[1] and man[0]["num_shards"] == 2
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    for s in range(2):
        with np.load(dirs[0] / f"shard_{s:05d}.npz") as a, \
                np.load(dirs[1] / f"shard_{s:05d}.npz") as b:
            assert sorted(a.files) == sorted(b.files) and a.files
            for k in a.files:
                assert _equal(a[k], b[k]), (s, k)
    assert not [n for n in os.listdir(tmp_path / "mesh")
                if n.startswith(".tmp")]


def test_resume_over_processes_is_the_straight_run(stores, tmp_path):
    d = str(tmp_path / "ckpt")
    runs = [["--data", "2", "--steps", "3", "--ckpt-dir", d],
            ["--data", "2", "--steps", "6", "--ckpt-dir", d]]
    got = spawn_ranks(cases.rank_cli, 2, 1, "gloo", str(stores / "resume"),
                      device="cpu", args=(runs,), timeout=SPAWN_TIMEOUT)
    rc, straight, _ = cases.cli(["--data", "2", "--steps", "6"])
    assert rc == 0 and len(straight) == 6
    for rank, (first, second) in enumerate(got):
        assert first[0] == 0 and second[0] == 0
        assert first[1] + second[1] == straight, rank
        assert ("[resume] step 3" in second[2]) == (rank == 0)
        assert ("done: 3 steps" in second[2]) == (rank == 0)


def test_elastic_restart_over_processes(stores, tmp_path):
    argv = ["--data", "2", "--steps", "6", "--fail-at-step", "3"]
    got = spawn_ranks(cases.rank_cli, 2, 1, "gloo", str(stores / "elastic"),
                      device="cpu",
                      args=([argv + ["--ckpt-dir", str(tmp_path / "m")]],),
                      timeout=SPAWN_TIMEOUT)
    rc, want, out = cases.cli(argv + ["--ckpt-dir", str(tmp_path / "s")])
    assert rc == 0 and "[elastic] step 3" in out
    (rc0, hist0, out0), = got[0]
    (rc1, hist1, _), = got[1]
    assert rc0 == rc1 == 0
    assert hist0 == want and len(want) == 6
    assert hist1 == want[:3]            # rank 1 left after the save
    assert "[ckpt] saved step 3 pre-failure" in out0
    assert "done: 6 steps" in out0
    assert ckpt.latest_step(str(tmp_path / "m")) == 6


def test_sigterm_on_one_rank_stops_every_rank(stores, tmp_path):
    d = str(tmp_path / "ckpt")
    got = spawn_ranks(cases.rank_sigterm, 2, 1, "gloo",
                      str(stores / "sigterm"), device="cpu",
                      args=(["--data", "2", "--steps", "6", "--ckpt-dir", d],
                            2), timeout=SPAWN_TIMEOUT)
    for rank, (rc, hist, out) in enumerate(got):
        assert rc == 0 and [s for s, _, _ in hist] == [0, 1, 2], rank
        assert ("[preempt] SIGTERM" in out) == (rank == 0)
    assert ckpt.latest_step(d) == 3
    man = json.loads((Path(d) / "step_000003" / "MANIFEST.json").read_text())
    assert man["extra"]["tag"] == "sigterm"


def test_divergent_rank_raises_on_every_rank(npzs, stores):
    got = spawn_ranks(cases.rank_diverge, 1, 2, "gloo",
                      str(stores / "diverge"), device="cpu",
                      args=(npzs["qwen3-4b"],), timeout=SPAWN_TIMEOUT)
    for name, msg in got:
        assert name == "MeshDivergenceError", msg
        assert "metrics" in msg


def test_a_mesh_of_the_wrong_size_raises(stores):
    got = spawn_ranks(cases.rank_wrong_size, 2, 1, "gloo",
                      str(stores / "wrong"), device="cpu",
                      timeout=SPAWN_TIMEOUT)
    for shape, world in got:
        assert "a 2x1 mesh for --data 1 --model 1" in shape
        assert "needs 4 ranks, the world has 2" in world


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_under_torch_distributed_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(_free_port()), "-m", "repro_torch.launch.train", "--data", "2",
         "--dist-backend", "gloo", "--steps", "2", "--ckpt-dir",
         str(tmp_path), *cases.CLI],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("done: 2 steps") == 1, res.stdout
    assert ckpt.latest_step(str(tmp_path)) == 2
