"""The roofline's work against hand counts at the smoke widths."""

import pytest

from perfbench import devtrace, work

CFG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=16, intermediate_size=96,
           vocab_size=257, attention_bias=False, tie_word_embeddings=True,
           torch_dtype="bfloat16", serving={"kv_dtype": "float32"})
PEAK = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_attention_counts_a_shared_document_once():
    # two rows on document 0 (64 tokens) at contexts 70 and 66, one on no
    # document at context 9
    w = work.attention(CFG, [64, 32], [0, 0, None], [70, 66, 9])
    positions = 64 + (70 - 64) + (66 - 64) + 9       # 81 unique
    per_pos = 2 * 2 * 16 * 4                         # K + V, f32
    by_layer = positions * per_pos + 3 * per_pos + 2 * 3 * 4 * 16 * 2
    assert w.bytes == 2 * by_layer
    assert w.flops == 2 * 4 * 4 * 16 * (70 + 66 + 9)


def test_step_adds_the_weights_once():
    d, ff, V, L = 64, 96, 257, 2
    mats = L * (d * 16 * (4 + 4) + 4 * 16 * d + 3 * d * ff) + d * V
    vecs = L * 2 * d + d
    w = work.step(CFG, [64], [0], [70])
    a = work.attention(CFG, [64], [0], [70])
    assert w.flops - a.flops == 2 * mats
    assert w.bytes - a.bytes == 2 * (mats + vecs)
    untied = dict(CFG, tie_word_embeddings=False, attention_bias=True)
    w2 = work.step(untied, [64], [0], [70])
    a2 = work.attention(untied, [64], [0], [70])
    vecs2 = vecs + L * 16 * 8
    assert w2.bytes - a2.bytes == 2 * (mats + vecs2) + 2 * d


def test_bound_takes_the_binding_peak():
    w = work.Work(flops=989e12, bytes=1.0)
    assert w.seconds(PEAK) == pytest.approx(1.0)
    assert w.bound_by(PEAK) == "compute"
    assert work.Work(1.0, 3.35e12).bound_by(PEAK) == "bandwidth"


def test_the_published_sizes():
    import json
    from perfbench import spec
    q3 = json.load(open(spec.HERE / "configs" / "qwen3-4b.json"))
    q25 = json.load(open(spec.HERE / "configs" / "qwen2.5-14b.json"))
    w3, w25 = work.weights(q3), work.weights(q25)
    assert 4.02e9 < w3["matrices"] + w3["vectors"] < 4.03e9
    # untied: the embedding and the head
    assert 14.76e9 < w25["matrices"] + w25["vectors"] + w25["embed"] \
        < 14.78e9
    # KV bytes a token over every layer, f32
    assert work.attention(q3, [1], [0], [1]).bytes > 294912


def test_trace_union_and_gaps():
    tr = devtrace.Trace(0.0, 10.0, [("a", 1.0, 3.0), ("b", 2.0, 4.0),
                                    ("a", 6.0, 7.0), ("c", 9.5, 11.0)])
    assert tr.busy_s() == pytest.approx(3.0 + 1.0 + 0.5)
    assert tr.gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]
    assert tr.seconds_of(["a"]) == pytest.approx(3.0)
    assert tr.top_ops(2)[0] == ["a", 3.0]
    spans = [("step", 3.5, 8.0), ("flush", 6.5, 7.5)]
    assert devtrace.idle_gaps(tr, spans, 2) == [["flush", 2.5], ["step",
                                                                2.0]]
    assert devtrace.name_gap(0.5, spans) == "host"
