"""Workloads and the run helper shared by ``test_torch_hybrid.py`` (jamba) and
``test_torch_mamba2_engine.py`` (mamba2): the port's engine on a Mamba
config against ``repro``'s ``codec-xla`` engine on shared weights.

Every workload prefills in 4-token chunks (boundaries off the pages), so
``repro``'s runs of one arch share their compiled shapes:

* ``serve``: three requests over a shared document, finishing apart so
  the fused step crosses buckets 4 -> 2 -> 1 (``test_engine.py:79``,
  ``test_fused_step.py:126``), then a second wave over the same document
  with the prefix cache on, whose cached node's SSM state spares its
  prefill;
* ``cascade``: ``test_cascade.py:178-199``'s schedule with cascade on:
  siblings resume from the cascaded state (the lead's mid-node carry
  included);
* ``pressure``: four requests over a 32-token document on a 6-page pool:
  preemption, then recompute from the deepest node-aligned
  ``meta["ssm"]``.

``drive`` returns a run's streams, its engine stats and the most shared
forest nodes carrying ``meta["ssm"]`` at once, after ``check()``, and
leaves no page, forest node or SSM state after every request is
released.
"""

import jax
import numpy as np

from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.configs import smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import DecodeEngine
from repro_torch.weights import from_jax_params

BACKENDS = ["codec-cuda", "codec-torch", "flash", "hydragen"]
PAGE = 8
STAT_KEYS = ("steps", "admitted", "preempted", "prefill_tokens",
             "recompute_tokens", "prefill_chunks", "cascade_groups",
             "cascade_shared_tokens")

DOC = list(range(10, 42))
_CASCADE_DOC = [10 + i for i in range(24)]
# (prompt, max_new, arrival step), engine options
WORKLOADS = {
    "serve": ([(DOC + [100 + i, 101 + i], n, 0)
               for i, n in enumerate((6, 4, 2))]
              + [(DOC + [120 + i, 121 + i], 3, 14) for i in range(2)],
              dict(num_pages=256, cache=True)),
    "cascade": ([(list(range(150, 166)) + [7, 8], 3, 0)]
                + [(_CASCADE_DOC + [100 + 3 * i + j for j in range(2)], 4, 0)
                   for i in range(3)],
                dict(num_pages=256, cascade=True)),
    "pressure": ([(DOC + [100 + 3 * i + j for j in range(3)], 6, 0)
                  for i in range(4)],
                 dict(num_pages=6)),
}


def drive(eng, workload, max_steps=96):
    """Run ``(prompt, max_new, arrival_step)`` to the end; returns the
    streams, stats and the shared nodes carrying SSM state, then releases
    every request and checks that no page or forest node is left."""
    arrivals = {}
    for i, (_, _, arr) in enumerate(workload):
        arrivals.setdefault(arr, []).append(i)
    rid_of = {}
    ssm_nodes = 0
    for s in range(max_steps):
        for i in arrivals.pop(s, []):
            prompt, max_new, _ = workload[i]
            rid_of[i] = eng.add_request(prompt, max_new=max_new)
        if not arrivals and not eng.has_work():
            break
        eng.step()
        ssm_nodes = max(ssm_nodes, sum(
            1 for n in eng.forest.real_nodes()
            if len(n.requests) > 1 and "ssm" in n.meta))
    assert not arrivals and not eng.has_work(), "workload did not finish"
    eng.check()
    rec = {"streams": {i: [int(t) for t in eng.requests[r].generated]
                       for i, r in rid_of.items()},
           "stats": {k: eng.stats[k] for k in STAT_KEYS},
           "ssm_nodes": ssm_nodes,
           "cache_hits": eng.cache.stats["hits"] if eng.cache else None}
    for i, (_, max_new, _) in enumerate(workload):
        assert len(rec["streams"][i]) == max_new, (i, rec["streams"][i])
    for r in list(eng.requests):
        eng.release(r)
    if eng.cache is not None:
        eng._evict_cached(eng.pool.num_pages)
    assert eng.pool.num_free == eng.pool.num_pages, "leaked pages"
    eng.pool.allocator.check()
    assert set(eng.forest.nodes) == {0}, "leaked forest nodes"
    assert not any(eng.mamba_state.values()) and not eng._mamba_pos
    return rec


def _kw(**kw):
    return dict(dict(page_size=PAGE, max_q=8, temperature=0.0,
                     prefill_chunk=4), **kw)


class Shared:
    """One arch's weights, port model and ``repro`` records, each
    ``repro`` run made once (``shared(name) -> (cfg, model, record)``)."""

    def __init__(self, arch):
        self.cfg = smoke_config(arch)
        self.params = JT.init_params(self.cfg, jax.random.PRNGKey(0))
        self.model = Transformer.from_state_dict(
            self.cfg, from_jax_params(self.cfg, jax.tree.map(np.asarray,
                                                             self.params)))
        self.recs = {}

    def __call__(self, name=None):
        if name is not None and name not in self.recs:
            work, kw = WORKLOADS[name]
            self.recs[name] = drive(JaxEngine(
                self.cfg, self.params, backend="codec-xla", **_kw(**kw)),
                work)
        return self.cfg, self.model, self.recs.get(name)


def port_run(cfg, model, name, **kw):
    work, base = WORKLOADS[name]
    eng = DecodeEngine(cfg, model, device="cpu",
                       **_kw(**dict(base, **kw)))
    return eng, drive(eng, work)


