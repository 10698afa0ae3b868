"""The traced decode steps' attention work at the chip's peaks
(``work.attention``: each KV position read once), over the device time of
the attention-class kernels, in %."""

from perfbench import spec, work


def read(run):
    if run.trace is None or run.peaks is None or not run.traced_steps:
        return None
    t = run.trace.seconds_of(spec.kernel_class("attention"))
    if t <= 0:
        return None
    cfg, docs = run.cell.config, run.traffic.doc_lengths
    bound = sum(work.attention(cfg, docs, s.docs, s.ctx).seconds(run.peaks)
                for s in run.traced_steps)
    return 100.0 * bound / t
