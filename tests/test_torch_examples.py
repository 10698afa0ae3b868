"""The port's serving examples (``examples/torch_port/``) run on the CPU
and print their OK lines, held against ``repro`` on the same inputs:
quickstart's forest, plan and IO lines equal what ``repro``'s ``tree``,
``plan`` and forest IO functions give at the same sizes; serve_docqa's
streams and tree_speculation's greedy stream, served from ``repro``'s
seed-0 weights, are ``repro``'s greedy continuations of the same prompts
(its model, run once over each prompt and stream, puts its largest logit
on every generated token), and tree_speculation's branch heads equal
``repro``'s oracle (``repro``'s own examples are not run here)."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import cost_model as jcm
from repro.core import plan as jplan
from repro.core import tree as jtree
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro_torch.core import cost_model as tcm
from repro_torch.models.transformer import Transformer
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch_port"
LAUNCHES = re.compile(r"codec-cuda launches: pac=(\d+) epilogue=(\d+)")


def run_example(name: str, timeout: int = 300) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / name), "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
        env=env)
    assert proc.returncode == 0, (
        f"{name} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    # the CPU runs the kernels' plain versions: no launch is counted
    counts = LAUNCHES.findall(proc.stdout)
    assert counts and all(c == ("0", "0") for c in counts), proc.stdout
    return proc.stdout


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_port_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, model):
    """``mod.main`` on the CPU serving ``model``: its result and stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = mod.main(["--device", "cpu"], model=model)
    out = buf.getvalue()
    counts = LAUNCHES.findall(out)
    assert counts and all(c == ("0", "0") for c in counts), out
    return result, out


@pytest.fixture(scope="module")
def weights():
    """``repro``'s seed-0 weights for the examples' config, and the port
    model made from them."""
    cfg = load_example("serve_docqa").config()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
    return cfg, params, model


def assert_repro_greedy(cfg, params, prompts, streams):
    """Each of ``streams`` is ``repro``'s greedy continuation of its
    prompt: one ``repro`` forward over every prompt and its stream (right
    padded into one batch; the mask is causal) takes its argmax at each
    position that produced a token."""
    seqs = [list(p) + list(s[:-1]) for p, s in zip(prompts, streams)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, seq in enumerate(seqs):
        toks[i, :len(seq)] = seq
    logits = np.asarray(jax.jit(
        lambda p, t: JT.forward(p, cfg, t)[0])(params, toks))
    for i, (p, s) in enumerate(zip(prompts, streams)):
        got = logits[i, len(p) - 1:len(p) - 1 + len(s)].argmax(-1)
        assert got.tolist() == [int(t) for t in s], i


def test_quickstart_matches_repro():
    out = run_example("quickstart.py")
    lines = out.splitlines()
    PAGE, N_REQ, DOC_LEN, Q_LEN = 64, 4, 1024, 96
    H_Q, H_KV, D = 8, 2, 64
    forest = jtree.two_level(N_REQ, DOC_LEN, Q_LEN, block_size=PAGE)
    jplan.assign_dense_pages(forest)
    assert (f"forest: {len(forest.real_nodes())} nodes, "
            f"{forest.total_tokens()} stored tokens for "
            f"{forest.total_context()} context tokens (mean sharing degree "
            f"{forest.mean_sharing_degree():.2f})") in lines
    # repro's planner priced with the port's (H100) priors
    hw = jcm.HardwareSpec(**dataclasses.asdict(tcm.HardwareSpec()))
    cm = jcm.CostModel(H_Q, H_KV, D, page_size=PAGE, hw=hw)
    plan = jplan.build_plan(forest, cm, num_lanes=2, max_q=8)
    got = next(l for l in lines if l.startswith("plan: "))
    assert ast.literal_eval(got[len("plan: "):]) == plan.stats()
    io_c = forest.codec_io_bytes(H_KV, D)
    io_f = forest.flash_io_bytes(H_KV, D)
    assert (f"KV bytes/step: codec {io_c / 1e6:.2f} MB, flash-decoding "
            f"{io_f / 1e6:.2f} MB -> {io_f / io_c:.2f}x reduction") in lines
    for name in ("codec-cuda", "codec-torch", "flash", "hydragen"):
        assert any(l.startswith(f"{name:13s} vs ref max |err|")
                   for l in lines), name


def test_serve_docqa_runs(weights):
    cfg, params, model = weights
    docqa = load_example("serve_docqa")
    streams, out = run_main(docqa, model)
    assert "codec == hydragen == flash outputs: OK" in out
    assert "preemption + chunked prefill) outputs: OK" in out
    assert "SPMD mesh engine outputs: OK" in out
    assert len(LAUNCHES.findall(out)) == 3      # every codec-cuda run
    # requests are numbered in the order the waves add them
    prompts = [p for wave in docqa.waves(cfg) for p in wave]
    assert sorted(streams) == list(range(len(prompts)))
    assert all(len(t) == docqa.MAX_NEW for t in streams.values())
    assert_repro_greedy(cfg, params, prompts,
                        [streams[r] for r in range(len(prompts))])


def test_tree_speculation_runs(weights):
    cfg, params, model = weights
    spec = load_example("tree_speculation")
    result, out = run_main(spec, model)
    assert "all 8 branch heads match the dense oracle" in out
    assert "streams identical" in out
    assert len(LAUNCHES.findall(out)) == 3
    # part 1: every branch head against repro's oracle on the same inputs
    forest, q, k_pool, v_pool, heads = result["heads"]
    for rid in range(q.shape[0]):
        kd, vd = spec.branch_kv(forest, rid, k_pool, v_pool)
        o_ref, _, _ = jref.pac_ref(q[rid][None].numpy(), kd.numpy(),
                                   vd.numpy())
        np.testing.assert_allclose(heads[rid].numpy(), np.asarray(o_ref)[0],
                                   atol=1e-5, rtol=0)
    # part 2: the greedy stream against repro's model on the same prompt
    assert len(result["greedy"]) == spec.MAX_NEW
    assert_repro_greedy(cfg, params, [spec.prompt(cfg)], [result["greedy"]])
