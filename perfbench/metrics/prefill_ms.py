"""Host time of the engine telemetry's ``prefill_chunk`` spans, summed per
request, mean over the requests prefilled in the window (spans that touch
the traced sub-window left out)."""


def read(run):
    tr = run.trace
    per = {}
    for e in run.telemetry_events:
        if e["name"] != "prefill_chunk" or not run.in_window(e["t"]):
            continue
        if tr is not None and e["t_end"] > tr.start and e["t"] < tr.end:
            continue
        per[e["tid"]] = per.get(e["tid"], 0.0) + (e["t_end"] - e["t"])
    return 1e3 * sum(per.values()) / len(per) if per else None
