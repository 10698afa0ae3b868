"""The traffic generator: deterministic from the seed, and each block of
requests follows the mix's stated distributions."""

import collections

import numpy as np
import pytest

from perfbench import spec, traffic as T

MIXES = ["docqa", "chat"]


def mix(name):
    return spec._json(spec.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_stream(name):
    a = T.Traffic(mix(name), 2**31 + 5, 151936)
    b = T.Traffic(mix(name), 2**31 + 5, 151936)
    for i in (0, 1, 63, 64, 200):
        ra, rb = a.request(i), b.request(i)
        assert (ra.doc, ra.max_new) == (rb.doc, rb.max_new)
        assert np.array_equal(a.prompt(ra), b.prompt(rb))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_work_in_another_order(name):
    m = mix(name)
    k = m["clients"]
    a, b = T.Traffic(m, 1, 1000), T.Traffic(m, 2, 1000)
    for blk in (1, 2):
        ra = [a.request(blk * k + j) for j in range(k)]
        rb = [b.request(blk * k + j) for j in range(k)]


        assert sorted(r.max_new for r in ra) == sorted(r.max_new for r in rb)
        assert sorted(len(r.private) for r in ra) == \
            sorted(len(r.private) for r in rb)
        assert [r.max_new for r in ra] != [r.max_new for r in rb]



@pytest.mark.parametrize("name", MIXES)
def test_block_is_uniform_over_the_stated_range(name):
    m = mix(name)
    k = m["clients"]
    t = T.Traffic(m, 7, 1000)
    rs = [t.request(k + j) for j in range(k)]
    for vals, (lo, hi) in (([r.max_new for r in rs], m["output_tokens"]),
                           ([len(r.private) for r in rs],
                            m["private_tokens"])):
        v = np.sort(vals)
        assert v[0] >= lo and v[-1] <= hi
        assert list(v) == list(T.stratified(lo, hi, k))
        # one value in each of k equal strata of [lo, hi + 1)
        span = hi - lo + 1
        j = np.arange(k)
        assert np.all(v - lo >= np.floor(j * span / k))
        assert np.all(v - lo < (j + 1) * span / k)
        assert abs(v.mean() - (lo + hi) / 2) <= 1


def test_docqa_documents_follow_zipf():
    m = mix("docqa")
    t = T.Traffic(m, 3, 1000)
    k = m["clients"]
    counts = collections.Counter(t.request(k + j).doc for j in range(k))
    shares = T.popularity(m["documents"])
    assert np.allclose(shares, [0.48, 0.24, 0.16, 0.12])
    for d, s in enumerate(shares):
        assert abs(counts[d] - s * k) < 1
    lengths = m["documents"]["lengths"]
    for d, n in enumerate(lengths):
        assert len(t.document(d)) == n
    r = t.request(k)
    assert np.array_equal(t.prompt(r)[:lengths[r.doc]], t.document(r.doc))


def test_chat_prompts_are_private():
    t = T.Traffic(mix("chat"), 3, 151936)
    firsts = {tuple(t.prompt(t.request(i))[:8]) for i in range(128)}
    assert len(firsts) == 128
    assert all(t.request(i).doc is None for i in range(128))


def test_first_block_is_staggered():
    m = mix("docqa")
    k = m["clients"]
    t = T.Traffic(m, 11, 1000)
    first = [t.request(j).max_new for j in range(k)]
    later = [t.request(k + j).max_new for j in range(k)]
    assert min(first) >= 1 and max(first) <= m["output_tokens"][1]
    assert np.mean(first) < 0.6 * np.mean(later)
    # taken up part-way: the generated share joins the prompt, and the
    # whole stays within the longest request of the mix
    whole = [len(t.request(j).private) + t.request(j).max_new
             for j in range(k)]
    assert max(whole) <= m["private_tokens"][1] + m["output_tokens"][1]
    assert sorted(whole) != sorted(len(t.request(k + j).private)
                                   for j in range(k))


def test_stratified_and_apportion():
    assert list(T.stratified(0, 9, 10)) == list(range(10))
    v = T.stratified(256, 768, 64)
    assert v[0] >= 256 and v[-1] <= 768 and len(set(v)) == 64
    assert list(T.apportion(np.array([0.48, 0.24, 0.16, 0.12]), 64)) == \
        [31, 15, 10, 8]


def test_peak_pages():
    t = T.Traffic(mix("docqa"), 0, 1000)
    # 4096..16384 over pages of 16 = 2560; 64 clients x (272 / 16 + 1)
    assert t.peak_pages(16) == 2560 + 64 * 18


def test_negative_seed_refused():
    with pytest.raises(ValueError):
        T.Traffic(mix("chat"), -1, 1000)
