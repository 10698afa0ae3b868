"""Training (port of ``repro.training``): the synthetic data stream, the
optimizers, checkpoints and the train step over the port's model."""

from . import checkpoint, data, optimizer, trainer  # noqa: F401
