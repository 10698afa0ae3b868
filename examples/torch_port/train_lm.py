"""Train a gemma3-backbone LM (6 layers, 16k vocab) for a few hundred
steps with the PyTorch port (the counterpart of ``examples/train_lm.py``).

Exercises the port's training substrate end to end: the train step
(autograd through the port's model, grad clip, AdamW with the cosine
schedule), the deterministic data pipeline and checkpoint/resume.  Runs
on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_port/train_lm.py --steps 300
"""

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import trainer
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import cosine_schedule, make_optimizer

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                   "codec_train_lm_torch"))
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = torch.device(args.device)

# gemma3-1b backbone, 6 layers, 16k vocab
cfg = dataclasses.replace(
    get_config("gemma3-1b"), name="gemma3-100m",
    num_layers=6, vocab_size=16384, dtype="float32",
    sliding_window=64)
n_params = cfg.param_count()
print(f"model: {cfg.name}, ~{n_params / 1e6:.0f}M params")

opt = make_optimizer("adamw", cosine_schedule(3e-4, 20, args.steps))
step_fn = trainer.make_train_step(cfg, opt, remat=False)
state = trainer.init_state(cfg, opt,
                           torch.Generator(device=dev).manual_seed(0),
                           device=dev)

start = 0
restored = ckpt.load_latest(args.ckpt_dir, state)
if restored:
    start, state, _ = restored
    print(f"resumed from step {start}")

data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch),
                   start_step=start)
t0 = time.time()
for step in range(start, args.steps):
    toks, labels = (torch.from_numpy(a).to(dev) for a in data.batch(step))
    state, m = step_fn(state, (toks, labels))
    if step % 25 == 0 or step == args.steps - 1:
        print(f"step {step:4d}  loss {float(m['loss']):.4f}  "
              f"gnorm {float(m['grad_norm']):.3f}  "
              f"{(time.time() - t0) / max(step - start + 1, 1):.2f}s/step")
    if step and step % 100 == 0:
        ckpt.save_checkpoint(args.ckpt_dir, step, state)
ckpt.save_checkpoint(args.ckpt_dir, args.steps, state)
print(f"done in {time.time() - t0:.0f}s; final loss "
      f"{float(m['loss']):.4f}")
