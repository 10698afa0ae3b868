"""The whole decode step's share of the chip's roofline peak: the traced
steps' work (``work.step``) at the peaks, over the host-clock time of
those ``engine.step()`` calls, in %."""

from perfbench import work


def read(run):
    if run.peaks is None or not run.traced_steps:
        return None
    cfg, docs = run.cell.config, run.traffic.doc_lengths
    bound = sum(work.step(cfg, docs, s.docs, s.ctx).seconds(run.peaks)
                for s in run.traced_steps)
    wall = sum(s.t1 - s.t0 for s in run.traced_steps)
    return 100.0 * bound / wall if wall > 0 else None
