"""Faults of the timed path, each one that a served one-chip cell can have:
planted under whole runs, each has to turn ``correct`` false.  The CPU
test plants them at smoke widths; ``control.py --faults`` at a cell's own
size on the card.  (The exchange between chips is no fault of a one-chip
cell.)"""

from __future__ import annotations

import contextlib

import torch


def altered_token():
    """A token altered where it is produced: the sampler's pick + 1."""
    from repro_torch.serving import sampler

    def sample(logits, *a, **k):
        return ((logits.argmax(-1) + 1) % logits.shape[-1]).to(torch.int32)
    return sampler, "sample", sample


def state_unchanged():
    """The decode step returns its state unchanged: its new K and V are
    never written to the pool."""
    from repro_torch.serving import step_fn
    orig = step_fn.decode_stack

    def stack(model, pool, *a, **k):
        k["write"] = lambda la, kn, vn: pool.layer_pools(la)
        return orig(model, pool, *a, **k)
    return step_fn, "decode_stack", stack


def half_batch():
    """Half of the batch left out: the second half of the rows' attention
    outputs dropped."""
    from repro_torch.kernels import por
    orig = por.por_epilogue

    def epilogue(qb, *a, **k):
        o = orig(qb, *a, **k).clone()
        o[o.shape[0] // 2:] = 0
        return o
    return por, "por_epilogue", epilogue


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged,
                                  half_batch)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place for the body of the ``with``."""
    module, attr, fault = FAULTS[name]()
    orig = getattr(module, attr)
    setattr(module, attr, fault)
    try:
        yield
    finally:
        setattr(module, attr, orig)
