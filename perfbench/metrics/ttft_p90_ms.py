"""90th percentile, over the requests whose first token landed in the
window (the traced sub-window left out), of the time from ``add_request``
to that token: prefill, and the wait behind other clients' prefills."""

from perfbench.record import percentile


def read(run):
    tr = run.trace
    v = [r.t_first - r.t_submit for r in run.reqs.values()
         if run.in_window(r.t_first)
         and (tr is None or not tr.start <= r.t_first < tr.end)]
    return 1e3 * percentile(v, 90) if v else None
