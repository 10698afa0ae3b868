"""End-to-end driver with the PyTorch port: serve a small model with
batched shared-prefix requests through the CoDec decode engine (the
counterpart of ``examples/serve_docqa.py``).

Three question waves arrive against two shared documents (continuous
batching); CoDec combines the shared KV reads and reuses the plan across
steps, and the same run through Hydragen and the FlashDecoding backend
gives the same tokens.  A run on a deliberately undersized pool with
chunked prefill preempts and recomputes instead of failing, with the same
tokens; a run on a ``1x1`` mesh (``distributed.decode_mesh``: the sharded
pool, per-shard plans and the sharded fused step on one shard) gives them
again.

The model is ``qwen2.5-14b``'s smoke config (a reduced GQA model, random
weights from seed 0) with ``head_dim=64`` in place of 16, on every
device: the CUDA epilogue takes head dims of 64, 128 and 256.  Every
``codec-cuda`` run prints its PAC and epilogue launch counts (0 on the
CPU, where the kernels' plain versions run).  Runs on the card unless
``--device cpu``:

    PYTHONPATH=src python examples/torch_port/serve_docqa.py

``main(argv, model=)`` serves a given model in place of the seeded one
and returns the streams; ``waves`` and ``drive`` take any engine with
``add_request``/``step``/``run``, ``repro``'s included.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.distributed import decode_mesh
from repro_torch.kernels import pac as pac_mod, por as por_mod
from repro_torch.models import transformer as T
from repro_torch.serving.engine import DecodeEngine

ARCH = "qwen2.5-14b"          # GQA family (reduced smoke config)
MAX_NEW = 12


def config():
    return dataclasses.replace(smoke_config(ARCH), head_dim=64)


def waves(cfg):
    """The fixed workload, shared by every run: three questions on doc A,
    then two on doc B and two more on doc A (from seed 0)."""
    rng = np.random.default_rng(0)
    doc_a = rng.integers(0, cfg.vocab_size, 128).tolist()
    doc_b = rng.integers(0, cfg.vocab_size, 96).tolist()

    def questions(doc, n):
        return [doc + rng.integers(0, cfg.vocab_size, 6).tolist()
                for _ in range(n)]
    return questions(doc_a, 3), questions(doc_b, 2), questions(doc_a, 2)


def drive(eng, workload):
    """Serve ``workload`` on ``eng``; the streams by request id."""
    wave1, wave2, wave3 = workload
    # wave 1: three questions on doc A
    for p in wave1:
        eng.add_request(p, max_new=MAX_NEW)
    for _ in range(3):
        eng.step()
    # wave 2 arrives mid-decode (continuous batching): doc B
    for p in wave2:
        eng.add_request(p, max_new=MAX_NEW)
    # wave 3: more questions on doc A, whose KV is already cached
    for p in wave3:
        eng.add_request(p, max_new=MAX_NEW)
    eng.run(48)
    return {r: req.generated for r, req in eng.requests.items()}


def run(cfg, model, dev, workload, backend: str, num_pages: int = 2048,
        mesh=None, **policy):
    eng = DecodeEngine(cfg, model, page_size=16, num_pages=num_pages,
                       backend=backend, max_q=16, temperature=0.0,
                       mesh=mesh, device=dev, **policy)
    pac0, epi0 = pac_mod.launches, por_mod.epilogue_launches
    t0 = time.time()
    out = drive(eng, workload)
    dt = time.time() - t0
    st = eng.stats
    prompts = sum(len(p) for wave in workload for p in wave)
    print(f"[{backend}@{num_pages}p] {len(eng.requests)} requests, "
          f"{st['steps']} decode steps in {dt:.1f}s; "
          f"prefill computed {st['prefill_tokens']} tokens "
          f"(prompts total {prompts}); "
          f"{st['replans']} replans, plan time {st['plan_time']:.3f}s")
    io_c = eng.forest.codec_io_bytes(cfg.num_kv_heads, cfg.head_dim)
    io_f = eng.forest.flash_io_bytes(cfg.num_kv_heads, cfg.head_dim)
    print(f"    decode KV IO: {io_c / 1e3:.1f} KB/step vs "
          f"{io_f / 1e3:.1f} KB/step per-request "
          f"({io_f / io_c:.2f}x saved)")
    if st["preempted"] or st["reclaimed"] or st["prefill_chunks"]:
        print(f"    pressure: peak {eng.pool.allocator.peak_used}/"
              f"{eng.pool.num_pages} pages, {st['preempted']} preemptions, "
              f"{st['reclaimed']} reclaims, {st['recompute_tokens']} "
              f"recomputed tokens, {st['prefill_chunks']} prefill chunks")
    if mesh is not None:
        occ = "/".join(f"{o:.0%}" for o in eng.pool.shard_occupancy())
        print(f"    mesh {mesh.shape['data']}x{mesh.shape['model']}: "
              f"per-shard pool occupancy {occ}")
    if backend == "codec-cuda":
        print(f"    codec-cuda launches: pac={pac_mod.launches - pac0} "
              f"epilogue={por_mod.epilogue_launches - epi0}")
    return out


def main(argv=None, model=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = config()
    if model is None:
        model = T.build_model(cfg, seed=0, device=dev)
    workload = waves(cfg)

    out_codec = run(cfg, model, dev, workload, "codec-cuda")
    out_hydra = run(cfg, model, dev, workload, "hydragen")
    out_flash = run(cfg, model, dev, workload, "flash")
    assert out_codec == out_flash == out_hydra, \
        "backends must produce identical tokens"
    print("codec == hydragen == flash outputs: OK")

    # memory pressure: a pool too small to hold all waves at once, plus
    # chunked prefill: same tokens, via preemption + recompute
    out_tight = run(cfg, model, dev, workload, "codec-cuda", num_pages=13,
                    prefill_chunk=32, reserve_pages=0)
    assert out_tight == out_codec, \
        "preempt-and-recompute must not change the tokens"
    print("undersized pool (preemption + chunked prefill) outputs: OK")

    # sharded serving (distributed/): a (data, model) mesh whose shards all
    # live on this device; 1x1 runs the whole sharded path on one shard
    # (launch/serve.py --mesh DxM serves wider meshes)
    mesh = decode_mesh(1, 1, device=dev)
    out_mesh = run(cfg, model, dev, workload, "codec-cuda", mesh=mesh,
                   fused=True)
    assert out_mesh == out_codec, \
        "sharded engine must reproduce the single-device tokens"
    print("SPMD mesh engine outputs: OK")
    return out_codec


if __name__ == "__main__":
    main()
