"""Mean of the engine's ``step_stats["running"]`` over the window's decode
steps (the traced sub-window left out)."""


def read(run):
    v = [s["running"] for s in run.steps if s["decoded"]]
    return sum(v) / len(v) if v else None
