"""The port's sampler (``repro_torch.serving.sampler``) against
``jax.random`` and ``repro.serving.sampler`` on the CPU.

The threefry2x32 hash, ``PRNGKey``, ``split``, ``fold_in``, 32-bit
``bits`` and ``uniform`` must equal JAX's bit for bit (in the
``jax_threefry_partitionable`` mode JAX runs in here, which the tests
assert), over seeded keys and shapes.  ``gumbel`` takes ``-log(-log(u))``
with torch's ``log``, which may differ from XLA's in the last bit, so it
is held to one ulp of its value or two float32 ulps of 1.0, the larger.  ``categorical`` and
``sample`` must draw the same tokens as ``repro``'s, through its eager
calls (exact division by the temperature) and its jitted ones (XLA turns
the division into a product with the float32 reciprocal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as jsampler
from repro_torch.serving import sampler
from torch_threads import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 42, 2**31 - 1, -1, 2**32 + 5]


def _np(key):
    return np.asarray(key).astype(np.int64)


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


def test_threefry_hash_matches_jax():
    from jax._src import prng
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 37), dtype=np.uint64).astype(np.uint32)
    want = prng.threefry2x32_p.bind(*map(jnp.asarray, (k[0], k[1], x[0],
                                                       x[1])))
    got = sampler.threefry2x32(*(torch.as_tensor(a.astype(np.int64))
                                 for a in (k[0], k[1], x[0], x[1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits_uniform_match_jax(seed):
    key, jkey = sampler.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _np(jkey))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(sampler.split(key, num).numpy(),
                                      _np(jax.random.split(jkey, num)))
    for data in (0, 7, 2**31 + 3):
        np.testing.assert_array_equal(
            sampler.fold_in(key, data).numpy(),
            _np(jax.random.fold_in(jkey, data)))
    rows = torch.arange(5)
    np.testing.assert_array_equal(
        sampler.fold_in(key, rows).numpy(),
        _np(jax.vmap(lambda i: jax.random.fold_in(jkey, i))(jnp.arange(5))))
    for shape in ((1,), (17,), (3, 5), (2, 3, 4)):
        np.testing.assert_array_equal(
            sampler.random_bits(key, shape).numpy(),
            _np(jax.random.bits(jkey, shape)))
    np.testing.assert_array_equal(sampler.uniform(key, (999,)).numpy(),
                                  np.asarray(jax.random.uniform(jkey,
                                                                (999,))))
    np.testing.assert_array_equal(
        sampler.uniform(key, (64,), 0.25, 3.0).numpy(),
        np.asarray(jax.random.uniform(jkey, (64,), minval=0.25,
                                      maxval=3.0)))
    # the noise: torch's log against XLA's, each last-bit apart; the outer
    # log turns the inner one's last bit into an absolute error of up to
    # two float32 ulps of 1.0
    g = sampler.gumbel(key, (4000,)).numpy()
    jg = np.asarray(jax.random.gumbel(jkey, (4000,)))
    assert (np.abs(g - jg)
            <= np.maximum(np.spacing(np.abs(jg)), 2 * 2.0**-23)).all()


def test_batched_keys_hash_per_row():
    """Per-row keys (the sampler's ``fold_in(key, row)``) hash in one
    pass, each row as JAX's ``vmap`` does."""
    keys = sampler.split(sampler.prng_key(9), 4)
    jkeys = jax.random.split(jax.random.PRNGKey(9), 4)
    np.testing.assert_array_equal(
        sampler.random_bits(keys, (6,)).numpy(),
        _np(jax.vmap(lambda k: jax.random.bits(k, (6,)))(jkeys)))


@pytest.mark.parametrize("vocab", [257, 5000])
@pytest.mark.parametrize("temperature", [0.0, 0.3, 0.8, 1.0, 1.7])
def test_sample_matches_repro(vocab, temperature):
    logits = (np.random.default_rng(vocab).standard_normal((8, vocab))
              * 3).astype(np.float32)
    for seed in (0, 5):
        key, jkey = sampler.prng_key(seed), jax.random.PRNGKey(seed)
        t = torch.from_numpy(logits)
        want = np.asarray(jsampler.sample(jnp.asarray(logits), jkey,
                                          temperature))
        np.testing.assert_array_equal(
            sampler.sample(t, key, temperature).numpy(), want)
        jit = jax.jit(lambda l, k: jsampler.sample(l, k, temperature))
        np.testing.assert_array_equal(
            sampler.sample(t, key, temperature, compiled=True).numpy(),
            np.asarray(jit(jnp.asarray(logits), jkey)))
        # a row's draw does not depend on the batch's row count
        np.testing.assert_array_equal(
            sampler.sample(t[:3], key, temperature).numpy(), want[:3])


def test_categorical_and_top_k_match_repro():
    logits = np.random.default_rng(1).standard_normal((6, 300)).astype(
        np.float32)
    key, jkey = sampler.prng_key(3), jax.random.PRNGKey(3)
    keys = sampler.fold_in(key, torch.arange(6))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jkey, i))(jnp.arange(6))
    np.testing.assert_array_equal(
        sampler.categorical(keys, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.vmap(jax.random.categorical)(jkeys,
                                                    jnp.asarray(logits))))
    for k in (1, 5, 40):
        np.testing.assert_array_equal(
            sampler.sample(torch.from_numpy(logits), key, 0.9,
                           top_k=k).numpy(),
            np.asarray(jsampler.sample(jnp.asarray(logits), jkey, 0.9,
                                       top_k=k)))
    # top-1 is greedy
    np.testing.assert_array_equal(
        sampler.sample(torch.from_numpy(logits), key, 0.9, top_k=1).numpy(),
        logits.argmax(-1))


def test_bad_temperature_rejected():
    logits = torch.zeros(1, 8)
    for bad in (-0.5, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            sampler.sample(logits, sampler.prng_key(0), bad)
