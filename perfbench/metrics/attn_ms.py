"""Device ms of the attention-class kernels (``kernel_classes/attention``)
a traced decode step."""

from perfbench import spec


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    s = run.trace.seconds_of(spec.kernel_class("attention"))
    return 1e3 * s / len(run.traced_steps) if s > 0 else None
