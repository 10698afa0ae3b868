"""Tree-structured speculative verification on the CoDec forest, with the
PyTorch port (the counterpart of ``examples/tree_speculation.py``).

In speculative decoding the verifier scores a *tree* of draft
continuations whose sibling branches share all ancestor KV: a CoDec
forest.  Part 1 builds the forest (trunk -> binary draft tree), compiles
one verify plan and runs one attention for every branch head, checked
against a dense oracle over each branch's materialised path.  Part 2
runs ``DecodeEngine(speculative=True)``: the draft-propose /
tree-verify / accept-rollback serving loop, committing several tokens a
dispatch with a token stream identical to plain greedy decode.

``repro``'s example uses pages of 32 (part 1) and 8 (part 2) and a head
dim of 16 (part 2); the CUDA epilogue takes pages of 16 and 64 and head
dims of 64, 128 and 256, so both parts here use pages of 16 and head dim
64 (part 2: ``qwen2.5-14b``'s smoke config with ``head_dim=64``).  Each
``codec-cuda`` run prints its PAC and epilogue launch counts (0 on the
CPU).  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python examples/torch_port/tree_speculation.py

``main(argv, model=)`` serves a given model in place of the seeded one
and returns part 1's inputs and branch heads and part 2's greedy stream.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import plan as plan_mod, tree as tree_mod
from repro_torch.core.cost_model import CostModel
from repro_torch.kernels import pac as pac_mod, por as por_mod, ref, registry
from repro_torch.models import transformer as T
from repro_torch.serving.engine import DecodeEngine

PAGE = 16
TRUNK = 8 * PAGE          # the accepted context so far
DRAFT_DEPTH, ARITY = 3, 2  # a binary draft tree, 8 branch heads
DRAFT_CHUNK = PAGE         # tokens per draft node (chunked drafts)
H_Q, H_KV, D = 8, 2, 64
MAX_NEW = 16


def draft_forest():
    """Trunk -> draft tree; one "query" per branch head."""
    forest = tree_mod.PrefixForest(PAGE)
    trunk = forest.add_node(tree_mod.ROOT_ID, TRUNK)
    frontier = [trunk]
    for _ in range(DRAFT_DEPTH):
        frontier = [forest.add_node(n.id, DRAFT_CHUNK)
                    for n in frontier for _ in range(ARITY)]
    for rid, leaf in enumerate(frontier):
        forest.attach_request(rid, leaf.id)
    forest.validate()
    return forest


def verify_heads(dev):
    """Part 1: one verify plan, one attention for every branch head,
    checked against a dense oracle.  Returns the forest, ``q``, the pools
    and the heads' outputs."""
    # 1. forest: trunk -> draft tree
    forest = draft_forest()
    B = len(forest.leaf_of)
    print(f"draft tree: {len(forest.real_nodes())} nodes, {B} branch "
          f"heads, {forest.total_tokens()} stored vs "
          f"{forest.total_context()} context tokens (sharing degree "
          f"{forest.mean_sharing_degree():.2f})")

    # 2. one plan for the whole verification step
    pool_pages = plan_mod.assign_dense_pages(forest)
    cm = CostModel(H_Q, H_KV, D, page_size=PAGE)
    plan = plan_mod.build_verify_plan(forest, cm,
                                      {r: r for r in range(B)},
                                      num_lanes=2, max_q=B)
    print("plan:", plan.stats())

    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H_Q, D), generator=gen, device=dev)  # one a branch
    k_pool = torch.randn((pool_pages, PAGE, H_KV, D), generator=gen,
                         device=dev)
    v_pool = torch.randn((pool_pages, PAGE, H_KV, D), generator=gen,
                         device=dev)

    # PAC over the verify plan, then the epilogue with no tail page (the
    # plan covers every page), as the engine's verify step runs them
    pac0, epi0 = pac_mod.launches, por_mod.epilogue_launches
    parts = registry.get("codec-cuda").parts(q, k_pool, v_pool, plan)
    out = por_mod.por_epilogue(q, *parts, k_pool, v_pool, None, None, None,
                               tail=False)
    print(f"codec-cuda launches: pac={pac_mod.launches - pac0} "
          f"epilogue={por_mod.epilogue_launches - epi0}")

    # 3. oracle check: per-branch dense attention over its materialised path
    for rid in range(B):
        kd, vd = branch_kv(forest, rid, k_pool, v_pool)
        o_ref, _, _ = ref.pac_ref(q[rid][None], kd, vd)
        err = float((out[rid] - o_ref[0]).abs().max())
        assert err < 1e-5, (rid, err)
    print(f"all {B} branch heads match the dense oracle")

    # 4. what did the tree buy? (per verification step)
    io_codec = forest.codec_io_bytes(H_KV, D)
    io_flash = forest.flash_io_bytes(H_KV, D)
    print(f"KV bytes/verify-step: tree-shared {io_codec / 1e6:.2f} MB vs "
          f"per-branch {io_flash / 1e6:.2f} MB "
          f"({io_flash / io_codec:.2f}x saved; grows with trunk length)")
    return forest, q, k_pool, v_pool, out


def branch_kv(forest, rid, k_pool, v_pool):
    """Branch ``rid``'s path, materialised: its keys and values in order."""
    ks, vs = [], []
    for node in forest.path(rid):
        for j, pg in enumerate(node.page_ids):
            take = min(PAGE, node.length - j * PAGE)
            ks.append(k_pool[pg][:take])
            vs.append(v_pool[pg][:take])
    return torch.cat(ks, 0), torch.cat(vs, 0)


# ---------------------------------------------------------------------- #
# 5. the serving loop: speculative mode end to end.  A repetitive prompt
#    gives the self-drafting n-gram proposer something to match; the
#    engine then commits >1 token a dispatch while producing exactly the
#    non-speculative greedy stream.
# ---------------------------------------------------------------------- #
def config():
    return dataclasses.replace(smoke_config("qwen2.5-14b"), head_dim=64)


def prompt(cfg):
    rng = np.random.default_rng(0)
    return [int(t) for t in
            (list(rng.integers(0, cfg.vocab_size, 8)) * 4)[:32]]


def serve(cfg, model, dev, speculative):
    eng = DecodeEngine(cfg, model, page_size=PAGE, num_pages=256,
                       backend="codec-cuda", max_q=8, temperature=0.0,
                       speculative=speculative, device=dev)
    pac0, epi0 = pac_mod.launches, por_mod.epilogue_launches
    r = eng.add_request(prompt(cfg), max_new=MAX_NEW)
    eng.run(64)
    print(f"codec-cuda launches: pac={pac_mod.launches - pac0} "
          f"epilogue={por_mod.epilogue_launches - epi0} "
          f"(speculative={speculative})")
    return list(eng.requests[r].generated), dict(eng.stats)


def main(argv=None, model=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    heads = verify_heads(dev)

    cfg = config()
    if model is None:
        model = T.build_model(cfg, seed=0, device=dev)
    base, st0 = serve(cfg, model, dev, False)
    spec, st1 = serve(cfg, model, dev, True)
    assert spec == base, "speculative stream must equal greedy decode"
    acc = st1["spec_accepted"] / max(st1["spec_steps"], 1)
    print(f"engine: {len(spec)} tokens in {st1['spec_steps']} dispatches "
          f"(vs {st0['steps']} non-speculative; {st1['spec_accepted']} "
          f"draft tokens accepted, {acc:.2f}/step); streams identical")
    return {"heads": heads, "greedy": base}


if __name__ == "__main__":
    main()
