"""The engine's plan builds and per-step plan advances
(``stats["plan_time"] + stats["advance_time"]``), host ms a decode step,
over the window less the traced sub-window."""


def read(run):
    d = run.stats_delta
    if d["steps"] <= 0:
        return None
    return 1e3 * (d["plan_time"] + d["advance_time"]) / d["steps"]
