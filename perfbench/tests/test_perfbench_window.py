"""The window's arithmetic: exact percentiles, and the end-to-end readers
over synthetic records."""

import numpy as np
import pytest

from perfbench import spec
from perfbench.record import ReqRecord, RunRecord, percentile


@pytest.mark.parametrize("n", [1, 2, 7, 100, 101])
@pytest.mark.parametrize("q", [0, 50, 90, 95, 100])
def test_percentile_is_numpys_linear(n, q):
    v = np.random.default_rng(n).exponential(size=n)
    assert percentile(list(v), q) == pytest.approx(np.percentile(v, q),
                                                   rel=1e-12)


def rec(rid, submit, first, n, gap, reason="done"):
    r = ReqRecord(rid, None, np.zeros(3, np.int64), 3, n, submit)
    r.tokens = list(range(n))
    r.t_first = first
    r.t_last = first + gap * (n - 1)
    r.t_done = r.t_last if reason else None
    r.reason = reason
    return r


def run_of(recs, tokens, t_open=10.0, seconds=5.0):
    cell = spec.load_cell("qwen3-4b.chat")
    return RunRecord(cell=cell, seed=0, seconds=seconds, setup_s=t_open,
                     t_open=t_open, t_close=t_open + seconds,
                     reqs={r.rid: r for r in recs}, window_tokens=tokens,
                     stats_delta={}, steps=[])


def test_tokens_per_s_is_the_whole_window():
    assert spec.reader("tokens_per_s")(run_of([], 1234)) == 1234 / 5.0


def test_tpot_p90_over_requests_completed_in_the_window():
    recs = [rec(i, 9.0, 10.5, 11, 0.01 * (i + 1)) for i in range(10)]
    recs.append(rec(99, 1.0, 2.0, 11, 5.0))          # ends after the close
    recs.append(rec(98, 1.0, 2.0, 11, 0.1))          # ends before the open
    recs.append(rec(97, 9.0, 9.5, 11, 0.05, reason=None))   # in flight
    got = spec.reader("tpot_p90_ms")(run_of(recs, 0))
    want = 1e3 * np.percentile([0.01 * (i + 1) for i in range(10)], 90)
    assert got == pytest.approx(want)


def test_ttft_p90_over_first_tokens_in_the_window():
    recs = [rec(i, 10.0 + 0.1 * i, 10.2 + 0.11 * i, 2, 0.01)
            for i in range(20)]
    recs.append(rec(50, 1.0, 9.9, 2, 0.01))          # first token before
    got = spec.reader("ttft_p90_ms")(run_of(recs, 0))
    want = 1e3 * np.percentile([0.2 + 0.01 * i for i in range(20)], 90)
    assert got == pytest.approx(want)


def test_readers_find_nothing_and_say_so():
    r = run_of([], 0)
    assert spec.reader("tpot_p90_ms")(r) is None
    assert spec.reader("ttft_p90_ms")(r) is None
    for name in ("attn_ms", "attn_roofline", "step_mfu_pct",
                 "device_idle_pct", "prefill_ms"):
        assert spec.reader(name)(r) is None
