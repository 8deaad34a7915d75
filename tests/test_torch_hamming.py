"""The port's packed-bit Hamming ops against the JAX package's.

Packed words are written to disk (BQ and RaBitQ codes), so the port's numpy
and torch packers must give the JAX package's bytes: bit j of word w is
dimension 32*w + j. The scores are sums of exact small integers, so both
scoring paths must equal the JAX results exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vecgo_tpu.ops import hamming as JH
from vecgo_tpu_torch.ops import hamming as H

torch.set_num_threads(1)


def _bits(n, d, seed=5):
    return np.random.default_rng(seed).random((n, d)) < 0.5


@pytest.mark.parametrize("d", [1, 31, 32, 33, 64, 100, 128])
def test_pack_bits_bytes_equal_jax(d):
    bits = _bits(37, d)
    want = np.asarray(JH.pack_bits(jnp.asarray(bits)))
    got_np = H.pack_bits_np(bits)
    assert got_np.dtype == np.uint32 and got_np.shape == (37, H.packed_words(d))
    assert got_np.tobytes() == want.tobytes()
    got_t = H.pack_bits(torch.from_numpy(bits))
    assert got_t.dtype == torch.int32
    assert got_t.numpy().tobytes() == want.tobytes()
    # the documented bit order, checked directly
    w, j = (d - 1) // 32, (d - 1) % 32
    assert ((got_np[:, w] >> np.uint32(j)) & 1).astype(bool).tolist() == bits[:, d - 1].tolist()


@pytest.mark.parametrize("d", [1, 33, 64, 100])
def test_unpack_bits_round_trip_and_equal_jax(d):
    bits = _bits(20, d, seed=6)
    packed = H.pack_bits_np(bits)
    want = np.asarray(JH.unpack_bits(jnp.asarray(packed), d))
    np.testing.assert_array_equal(H.unpack_bits_np(packed, d), want)
    np.testing.assert_array_equal(H.unpack_bits(packed, d).numpy(), want)
    np.testing.assert_array_equal(want.astype(bool), bits)
    pm = H.unpack_to_pm1(packed, d)
    assert pm.dtype == torch.bfloat16
    np.testing.assert_array_equal(pm.float().numpy(), 2.0 * bits - 1.0)
    np.testing.assert_array_equal(
        pm.float().numpy(), np.asarray(JH.unpack_to_pm1(jnp.asarray(packed), d), np.float32))


def test_popcount_equals_jax_on_every_bit_pattern_class():
    v = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA, 0x55555555,
                  0x0F0F0F0F, 0xDEADBEEF], np.uint32)
    v = np.concatenate([v, np.random.default_rng(7).integers(0, 2**32, 500, dtype=np.uint32)])
    want = np.asarray(JH.popcount_u32(jnp.asarray(v)))
    np.testing.assert_array_equal(H.popcount_u32(H.as_words(v)).numpy(), want)
    np.testing.assert_array_equal(want, [bin(int(x)).count("1") for x in v])


@pytest.mark.parametrize("d", [32, 100, 128])
def test_hamming_scores_equal_popcount_and_jax(d):
    q = H.pack_bits_np(_bits(9, d, seed=8))
    x = H.pack_bits_np(_bits(300, d, seed=9))
    pop = H.hamming_scores_popcount(q, x).numpy()
    mm = H.hamming_scores(q, x, d).numpy()
    np.testing.assert_array_equal(pop, mm)  # exact: sums of +-1 products
    np.testing.assert_array_equal(pop, np.asarray(JH.hamming_scores_popcount(
        jnp.asarray(q), jnp.asarray(x))))
    np.testing.assert_array_equal(mm, np.asarray(JH.hamming_scores(
        jnp.asarray(q), jnp.asarray(x), d)))
    assert pop.min() >= 0 and pop.max() <= d
