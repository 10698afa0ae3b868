"""Sliding-window pruning of a plan keeps every page that some query of
the task still sees.

``build_plan`` drops a windowed subtask's pages that lie wholly out of
every query's window.  A KV position ``p`` is visible to a query at
position ``q`` iff ``p > q - window``, so a page is invisible to all of a
task's queries only below the *smallest* query's window.  ``repro``
prunes against the largest query position, which drops KV that a
shorter request of the same task still reads; the port prunes against
the smallest.

The recipe: ``smoke_config("gemma3-1b")`` (window 32, five local layers
to one global), ``repro``'s weights from ``PRNGKey(0)``, page 8, two
requests over one 40-token document at different positions (a 1-token
and a 21-token tail), 8 greedy tokens each.  The port's engine, for every
plan backend, eager and fused, whole-prompt and in 8-token chunks, must
give the port's dense ``prefill`` + ``decode_step`` streams (held to
``repro``'s dense decode in ``test_torch_families.py``); ``repro``'s own
``codec-xla`` engine still parts from them on request 0 (the fault stays
on the reference side).
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.configs import smoke_config
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.cost_model import CostModel
from repro_torch.models.transformer import Transformer, decode_step, prefill
from repro_torch.serving.engine import DecodeEngine
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

CFG = smoke_config("gemma3-1b")
DOC = list(range(10, 50))
PROMPTS = [DOC + [100], DOC + list(range(150, 171))]
NEW = 8
KW = dict(page_size=8, num_pages=512, max_q=8, num_lanes=4,
          temperature=0.0)


@pytest.fixture(scope="module")
def shared():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        CFG, from_jax_params(CFG, jax.tree.map(np.asarray, params)))
    dense = []
    for p in PROMPTS:
        logits, cache, clen = prefill(model, torch.tensor([p]),
                                      len(p) + NEW)
        out = []
        for _ in range(NEW):
            nxt = int(torch.argmax(logits[0]))
            out.append(nxt)
            logits, cache = decode_step(model, torch.tensor([[nxt]]), cache,
                                        clen)
            clen = clen + 1
        dense.append(out)
    eng = JaxEngine(CFG, params, backend="codec-xla", **KW)
    for p in PROMPTS:
        eng.add_request(p, max_new=NEW)
    got = eng.run(NEW + 2)
    return model, dense, [got[0], got[1]]


def test_repro_engine_still_parts_from_dense_decode(shared):
    _, dense, jax_streams = shared
    assert dense[0] == [100] * NEW
    assert jax_streams[0] != dense[0]
    assert jax_streams[1] == dense[1]


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", ["codec-cuda", "codec-torch",
                                     "hydragen", "flash", "ref"])
def test_engine_matches_dense_decode(shared, backend, fused, chunk):
    """(``ref`` is not jit-safe: with ``fused=True`` it decodes eagerly.)"""
    model, dense, _ = shared
    eng = DecodeEngine(CFG, model, backend=backend, device="cpu",
                       fused=fused, prefill_chunk=chunk, **KW)
    for p in PROMPTS:
        eng.add_request(p, max_new=NEW)
    got = eng.run(NEW + 8)
    assert [got[0], got[1]] == dense


def test_pruning_keeps_the_smallest_querys_window():
    """One task holds both requests' queries over the shared document:
    its kept pages start at the smaller query's window."""
    forest = tree_mod.PrefixForest(8)
    for rid, p in enumerate(PROMPTS):
        forest.insert_tokens(rid, np.asarray(p, np.int32))
    pid = 0
    for node in forest.real_nodes():
        k = -(-node.length // 8)
        node.page_ids = list(range(pid, pid + k))
        pid += k
    cm = CostModel(CFG.num_heads, CFG.num_kv_heads, CFG.head_dim,
                   page_size=8)
    win = CFG.sliding_window
    plan = plan_mod.build_plan(forest, cm, 4, 8, 2048, window=win)
    q_min = min(forest.context_len(r) - 1 for r in (0, 1))
    both = plan.task_qnum[:plan.num_tasks] == 2
    assert both.any()
    assert int(plan.task_pos[:plan.num_tasks][both].min()) == \
        ((q_min - win + 1) // 8) * 8
