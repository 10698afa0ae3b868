"""The port's engine serving Mamba-2 (``mamba2-2.7b``, attention-free) against ``repro``'s
``codec-xla`` engine on shared weights (workloads and the ``drive`` helper in
``torch_hybrid_cases.py``).

One ``repro`` run per workload (module fixture), held to the port's runs,
eager and fused: streams, engine stats, the shared nodes carrying
``meta["ssm"]``, cache hits, ``check()`` and nothing left after release.
``serve`` runs every backend and crosses fused buckets 4 -> 2 -> 1, then
hits the prefix cache; ``cascade`` resumes siblings from the cascaded
SSM state (and equals the port's sequential prefill); ``pressure``
preempts and recomputes from ``meta["ssm"]``.  Speculation refuses the
config with ``repro``'s message.
With no attention layer the pool keeps ``repro``'s one placeholder
layer, no plan is built and the fused signature is the bucket alone.
"""

import pytest

from torch_hybrid_cases import BACKENDS, Shared, port_run
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module")
def shared():
    return Shared(ARCH)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_and_cache_match_repro(shared, backend, fused):
    cfg, model, want = shared("serve")
    assert want["ssm_nodes"] > 0 and want["cache_hits"] >= 1
    eng, got = port_run(cfg, model, "serve", backend=backend, fused=fused)
    assert got == want
    if fused:
        assert eng.fused_step.replays == eng.stats["fused_calls"] > 0
        assert sorted({sig[0] for sig in eng.bucket_signatures}) \
            == [1, 2, 4]
    assert eng._windows() == [] and eng.pool.k.shape[0] == 1
    assert not eng.attn_layer_idx
    if fused:
        assert all(len(sig) == 1 for sig in eng.bucket_signatures)


@pytest.mark.parametrize("fused", [False, True])
def test_cascade_resume_matches_repro(shared, fused):
    cfg, model, want = shared("cascade")
    _, got = port_run(cfg, model, "cascade", fused=fused)
    assert got == want
    assert got["stats"]["cascade_groups"] >= 1
    assert got["stats"]["cascade_shared_tokens"] > 0
    _, seq = port_run(cfg, model, "cascade", fused=fused, cascade=False)
    assert seq["streams"] == got["streams"]


@pytest.mark.parametrize("fused", [False, True])
def test_preemption_recompute_matches_repro(shared, fused):
    cfg, model, want = shared("pressure")
    assert want["stats"]["preempted"] >= 1
    _, got = port_run(cfg, model, "pressure", fused=fused)
    assert got == want


def test_speculation_refuses_mamba(shared):
    from repro_torch.serving.engine import DecodeEngine
    cfg, model, _ = shared()
    with pytest.raises(ValueError, match="Mamba"):
        DecodeEngine(cfg, model, device="cpu", speculative=True)
