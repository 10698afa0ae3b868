"""The train step on the card against the same port code on the CPU.

Needs an NVIDIA GPU; skips elsewhere.  Run on the card with
``python -m pytest --noconftest -q -m cuda tests/test_torch_training_cuda.py``.
Imports only torch and the port, so it runs where ``jax`` is not
installed.
"""

import pytest
import torch


def _need_card():
    """Skip without a card; else the port's training modules (imported
    here, not at collection, so that a session of several card files
    loads nothing of this one before its own tests run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer, trainer
    from repro_torch.training.data import DataConfig, SyntheticLM
    return (smoke_config, init_params, optimizer, trainer, DataConfig,
            SyntheticLM)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,microbatches", [
    ("qwen3-4b", 1), ("qwen3-4b", 2), ("llama4-scout-17b-a16e", 1),
    ("mamba2-2.7b", 1)])
def test_train_step_on_card_equals_cpu(arch, microbatches):
    """One f32 train step of a smoke model (remat on) from the same
    weights on the card and on the CPU: loss and grad norm within 1e-5
    relative, and every weight after the step within 2 lr of the CPU's
    (Adam's first step moves a weight by ~lr sign(g): where a gradient is
    within float32 noise of zero its sign is noise), all but a 1e-3 share
    within float32 rounding."""
    smoke_config, init_params, O, trainer, DataConfig, SyntheticLM = \
        _need_card()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = smoke_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
        sched = O.cosine_schedule(1e-3, 2, 10)
        batch = [torch.from_numpy(a) for a in SyntheticLM(
            DataConfig(cfg.vocab_size, 32, 4)).batch(0)]
        out = {}
        for dev in ("cpu", "cuda"):
            opt = O.adamw(sched)
            moved = {k: v.to(dev, copy=True) for k, v in params.items()}
            st = trainer.make_state(cfg, moved, opt.init(moved))
            st, met = trainer.make_train_step(
                cfg, opt, microbatches=microbatches, remat=True)(
                st, tuple(x.to(dev) for x in batch))
            out[dev] = st, {k: float(v) for k, v in met.items()}
        (s_c, m_c), (s_g, m_g) = out["cpu"], out["cuda"]
        for k in ("loss", "grad_norm", "ce"):
            assert abs(m_g[k] - m_c[k]) <= 1e-5 * abs(m_c[k]), (k, m_g, m_c)
        lr = float(sched(1))
        off = n = 0
        for k, w in s_c.params.items():
            d = (s_g.params[k].detach().cpu() - w.detach()).abs()
            assert float(d.max()) <= 2 * lr * (1 + 1e-5), k
            off += int((d > 1e-5 * w.detach().abs() + 1e-6 * lr).sum())
            n += d.numel()
        assert off <= 1e-3 * n, (off, n)
        assert int(s_g.step) == 1 and s_g.step.is_cuda
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_bf16_moe_train_step_on_card():
    """A bf16 MoE step records its expert products in float32 (``bmm``'s
    ``out_dtype`` form has no derivative): it runs on the card, its
    gradients reach every expert weight, and its loss is the CPU's within
    bf16 rounding."""
    smoke_config, init_params, _, trainer, DataConfig, SyntheticLM = \
        _need_card()
    cfg = smoke_config("llama4-scout-17b-a16e")
    params = init_params(cfg, torch.Generator().manual_seed(4),
                         device="cpu", dtype=torch.bfloat16)
    batch = [torch.from_numpy(a) for a in SyntheticLM(
        DataConfig(cfg.vocab_size, 32, 4)).batch(0)]
    losses = {}
    for dev in ("cpu", "cuda"):
        moved = {k: v.to(dev, copy=True) for k, v in params.items()}
        st = trainer.make_state(cfg, moved, {})
        loss, _ = trainer.make_loss_fn(cfg)(
            st.model, *(x.to(dev) for x in batch))
        grads = torch.autograd.grad(loss, list(st.params.values()))
        for k, g in zip(st.params, grads):
            assert torch.isfinite(g).all(), k
            if k.endswith(("ffn.wi", "ffn.wo")):
                assert g.dtype == torch.bfloat16 and g.abs().max() > 0, k
        losses[dev] = float(loss.detach())
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2 * losses["cpu"]
