"""A cell cut to a size the CPU runs in seconds: the smoke widths of the
port's ``smoke_config`` and a few clients, for the tests only."""

import time

from perfbench import harness, spec

SMOKE = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=96,
             vocab_size=257)


def cell(name: str, dtype: str = "bfloat16", **traffic):
    c = spec.load_cell(name)
    c.config.update(SMOKE, torch_dtype=dtype)
    c.traffic.update(clients=4, private_tokens=[4, 8], output_tokens=[6, 12])
    if c.traffic.get("documents"):
        c.traffic["documents"] = dict(c.traffic["documents"],
                                      lengths=[64, 32])
    c.traffic.update(traffic)
    return c


def run(c, seed=12345, seconds=1.5, trace=False):
    """One CPU run of ``c``; returns the result line's object with
    ``correct`` set as ``run.py`` sets it."""
    res = harness.run_cell(c, seed, seconds, trace, "cpu",
                           time.perf_counter())
    res["correct"] = harness.is_correct(res["checks"])
    return res
