"""Quickstart with the PyTorch port: the CoDec shared-prefix attention op
(the counterpart of ``examples/quickstart.py``).

Builds a document-QA prefix forest (one shared document, four
questions), compiles a decode plan, runs one decode attention through
every backend of the port's registry (the CUDA PAC kernel over the CoDec
plan, the same plan as torch ops, FlashDecoding's per-request plan on
the same kernel, the Hydragen decomposition) against the python oracle,
and shows the KV bytes the plan saves against FlashDecoding.

Each backend's partials go through one ``por.por_epilogue`` launch, as
the serving engine combines them (the plan covers every page, so the
epilogue reduces the segments and casts: no tail page).  The sizes (head
dim 64, pages of 64) are ones the CUDA epilogue takes.  Runs on the card
unless ``--device cpu`` (the kernels' plain versions):

    PYTHONPATH=src python examples/torch_port/quickstart.py
"""

import argparse

import torch

from repro_torch.core import plan as plan_mod, tree as tree_mod
from repro_torch.core.cost_model import CostModel
from repro_torch.kernels import pac as pac_mod, por as por_mod, registry

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)

PAGE = 64
N_REQ, DOC_LEN, Q_LEN = 4, 1024, 96
H_Q, H_KV, D = 8, 2, 64          # GQA: 4 query heads per KV head

# 1. the KV-cache forest: a shared doc node + one private tail per request
forest = tree_mod.two_level(N_REQ, DOC_LEN, Q_LEN, block_size=PAGE)
pool_pages = plan_mod.assign_dense_pages(forest)
print(f"forest: {len(forest.real_nodes())} nodes, "
      f"{forest.total_tokens()} stored tokens for "
      f"{forest.total_context()} context tokens "
      f"(mean sharing degree {forest.mean_sharing_degree():.2f})")

# 2. compile the decode plan: cost estimation -> division -> LPT lanes
cm = CostModel(H_Q, H_KV, D, page_size=PAGE)
plan = plan_mod.build_plan(forest, cm, num_lanes=2, max_q=8)
print(f"plan: {plan.stats()}")

# 3. one query a request over a paged KV pool (PagedAttention's layout),
#    through every registered backend: switching is just a string
gen = torch.Generator(device=dev).manual_seed(0)
q = torch.randn((N_REQ, H_Q, D), generator=gen, device=dev)
k_pool = torch.randn((pool_pages, PAGE, H_KV, D), generator=gen, device=dev)
v_pool = torch.randn((pool_pages, PAGE, H_KV, D), generator=gen, device=dev)

flash_plan = plan_mod.flash_plan(forest, cm, num_lanes=2, max_q=8)
out_ref = registry.get("ref")(q, k_pool, v_pool, plan)
for name in registry.names():
    if name == "ref":
        continue
    backend = registry.get(name)
    # a backend declares which planner it wants (flash = per-request)
    p = flash_plan if backend.plan_kind == "flash" else plan
    pac0, epi0 = pac_mod.launches, por_mod.epilogue_launches
    parts = backend.parts(q, k_pool, v_pool, p)
    out = por_mod.por_epilogue(q, *parts, k_pool, v_pool, None, None, None,
                               tail=False)
    err = float((out - out_ref).abs().max())
    assert err < 1e-4, (name, err)
    print(f"{name:13s} vs ref max |err|: {err:.2e}   "
          f"(plan_kind={backend.plan_kind}, tasks={p.num_tasks}, "
          f"window={backend.supports_window}, gqa={backend.supports_gqa})")
    if name == "codec-cuda":
        print(f"codec-cuda launches: pac={pac_mod.launches - pac0} "
              f"epilogue={por_mod.epilogue_launches - epi0}")

# 4. what did prefix sharing buy? (paper Fig. 6 metric)
io_codec = forest.codec_io_bytes(H_KV, D)
io_flash = forest.flash_io_bytes(H_KV, D)
print(f"KV bytes/step: codec {io_codec / 1e6:.2f} MB, "
      f"flash-decoding {io_flash / 1e6:.2f} MB "
      f"-> {io_flash / io_codec:.2f}x reduction")
