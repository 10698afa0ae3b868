#!/usr/bin/env python3
"""``chip_smoke.py`` phase 14 (the mesh) alone, on the card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/chip_phase14.py        # 14a-e
    python3 tools/chip_phase14.py a      # 14a and 14c only
    python3 tools/chip_phase14.py c5     # 14e (iv) only

Builds the kernels, serves phase 3's workload through the single-device
fused step (phase 7's numbers, which 14a prints beside each mesh), then
runs ``chip_smoke.phase_mesh`` (14a, 14c), ``phase_mesh_f32`` (14b),
``phase_calibrate`` (14d), ``phase_process_mesh`` (14e i-iii) and
``phase_process_mesh_c5`` (14e iv), and prints the seconds each took and
14c's ``kernels`` entries as JSON.  A quicker loop than the whole script when
only the mesh changed.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phase14: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import PAPER_ARCH, get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import doc_prompts, serve
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(cs.nvidia_smi(), flush=True)
    build.load()
    if sys.argv[1:] == ["c5"]:
        t0 = time.perf_counter()
        cs.phase_process_mesh_c5()
        print(f"14e (iv): {time.perf_counter() - t0:.1f} s")
        return 0
    timer = cs.Timer()
    cfg = get_config(PAPER_ARCH)
    model = build_model(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    engine = DecodeEngine(cfg, model, page_size=cs.PAGE, num_pages=1024,
                          num_lanes=cs.LANES, max_q=cs.MAX_Q, fused=True,
                          device="cuda")
    r = serve(engine, doc_prompts(8, cs.P14_DOC, cs.P14_Q, cfg.vocab_size,
                                  seed=0), 32,
              profile_steps=cs.PROFILE_STEPS)
    cs.log_serve("codec-cuda", True, r)
    del engine, model
    torch.cuda.empty_cache()
    t = [time.perf_counter()]
    kernels, runs14 = cs.phase_mesh(timer, {"codec-cuda": r})
    t.append(time.perf_counter())
    if "a" not in sys.argv[1:]:
        f32_14 = cs.phase_mesh_f32()
        t.append(time.perf_counter())
        cs.phase_calibrate()
        t.append(time.perf_counter())
        cs.phase_process_mesh(runs14, f32_14)
        t.append(time.perf_counter())
        cs.phase_process_mesh_c5()
        t.append(time.perf_counter())
    print("phase 14 parts, s:", [round(b - a, 1) for a, b in zip(t, t[1:])])
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
