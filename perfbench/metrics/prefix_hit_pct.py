"""Prompt tokens the prefix cache served, as a share of the prompt tokens
admitted in the window (``cache.stats`` deltas, the traced sub-window left
out)."""


def read(run):
    d = run.stats_delta
    if d.get("cache_lookup_tokens", 0) <= 0:
        return None
    return 100.0 * d["cache_hit_tokens"] / d["cache_lookup_tokens"]
