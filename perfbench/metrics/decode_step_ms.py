"""The engine's decode phase (``stats["decode_time"]``: the fused step's
host side, flushes included), host ms a decode step, over the window less
the traced sub-window."""


def read(run):
    d = run.stats_delta
    if d["steps"] <= 0:
        return None
    return 1e3 * d["decode_time"] / d["steps"]
