"""The port's DecodeEngine against ``repro``'s on the same weights: greedy
token streams must be byte-identical, through every port backend (the
``flash`` and ``hydragen`` baselines against ``repro``'s as well)."""

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serving.engine import DecodeEngine as JaxEngine
from repro_torch.configs import PAPER_ARCH, smoke_config
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.weights import from_jax_params

KW = dict(page_size=16, num_pages=512, max_q=8, temperature=0.0)


@pytest.fixture(scope="module")
def shared():
    cfg = smoke_config(PAPER_ARCH)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    model = Transformer.from_state_dict(
        cfg, from_jax_params(cfg, jax.tree.map(np.asarray, params)))
    return cfg, params, model


def _doc_qa_prompts(n=3, doc_len=48, q_len=3):
    doc = list(range(10, 10 + doc_len))
    return [doc + [100 + 3 * i + j for j in range(q_len)] for i in range(n)]


# shared-document prompts, one fully shared prompt (an exact copy of
# another), and one request added mid-run that matches only part of a
# cached node — a radix split and a plan rebuild
PROMPTS = _doc_qa_prompts() + [_doc_qa_prompts()[0]]
LATE = [list(range(10, 10 + 40)) + [7, 8, 9, 11, 12]]


@pytest.fixture(scope="module")
def jax_streams(shared):
    cfg, params, _ = shared
    return _drive(JaxEngine(cfg, params, backend="codec-xla", **KW),
                  PROMPTS, LATE)


@pytest.fixture(scope="module")
def repro_streams(shared):
    """``repro``'s streams by backend, each JAX engine run at most once."""
    cfg, params, _ = shared
    runs = {}

    def get(backend):
        if backend not in runs:
            runs[backend] = _drive(JaxEngine(cfg, params, backend=backend,
                                             **KW), PROMPTS, LATE)
        return runs[backend]
    return get


def _drive(engine, prompts, late=(), max_new=6, steps=12):
    """Add ``prompts``, step twice, add ``late`` mid-run, run out."""
    for p in prompts:
        engine.add_request(p, max_new=max_new)
    for _ in range(2):
        engine.step()
    for p in late:
        engine.add_request(p, max_new=max_new)
    return engine.run(steps)


@pytest.mark.parametrize("backend", ["codec-cuda", "codec-torch", "ref",
                                     "flash", "hydragen"])
def test_streams_match_repro(shared, jax_streams, backend):
    cfg, _, model = shared
    eng = DecodeEngine(cfg, model, backend=backend, device="cpu", **KW)
    got = _drive(eng, PROMPTS, LATE)
    assert got == jax_streams
    assert all(len(t) == 6 for t in got.values())
    assert eng.plan_rebuilds >= 2
    eng.forest.validate()
    for rid in list(eng.requests):
        eng.release(rid)
    eng.pool.allocator.check()
    assert eng.pool.num_free == eng.pool.num_pages


@pytest.mark.parametrize("backend", ["flash", "hydragen"])
def test_baseline_streams_match_repro_baseline(shared, jax_streams,
                                               repro_streams, backend):
    """The port's baseline engine against ``repro``'s same baseline (and
    both against ``repro``'s codec-xla); ``flash`` runs on per-request
    plans."""
    cfg, _, model = shared
    eng = DecodeEngine(cfg, model, backend=backend, device="cpu", **KW)
    got = _drive(eng, PROMPTS, LATE)
    assert got == repro_streams(backend) == jax_streams
    plan, _ = eng._plans[0]
    if backend == "flash":
        assert int(plan.task_qnum.max()) == 1


def test_engine_validation(shared):
    cfg, _, model = shared
    with pytest.raises(NotImplementedError):
        DecodeEngine(cfg, model, device="cpu", **{**KW, "temperature": 0.7})
    with pytest.raises(ValueError):
        DecodeEngine(cfg, model, device="cpu", **{**KW, "temperature": -1.0})
    eng = DecodeEngine(cfg, model, device="cpu", **{**KW, "num_pages": 4})
    with pytest.raises(ValueError):
        eng.add_request([])
    with pytest.raises(ValueError):
        eng.add_request([cfg.vocab_size])
    with pytest.raises(ValueError):
        eng.add_request([1, 2], max_new=0)
    with pytest.raises(MemoryError):
        eng.add_request(list(range(5 * 16)))
    # two pages of prompt, then the tail outgrows a dry pool
    eng.add_request(list(range(1, 31)), max_new=40)
    eng.add_request(list(range(40, 70)), max_new=40)
    with pytest.raises(MemoryError):
        eng.run(40)


def test_pool_page_bytes_use_torch_element_size():
    for dt, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        pool = PagedKVPool(3, 10, 16, 2, 8, dtype=dt, device="cpu")
        per_page = 2 * 3 * 16 * 2 * 8
        assert pool.page_bytes == per_page * size
        assert pool.bytes_used() == per_page * (10 + 1) * size
        assert pool.trash_page == 10
