"""90th percentile, over the requests that completed in the window, of
(last token's time - first token's time) / (tokens - 1)."""

from perfbench.record import percentile


def read(run):
    v = [(r.t_last - r.t_first) / (len(r.tokens) - 1)
         for r in run.completed() if len(r.tokens) >= 2]
    return 1e3 * percentile(v, 90) if v else None
