"""The port's bit-packing ops and packed channel against the JAX package.

Inputs are made with numpy from a seed and handed to both packages on the
CPU (JAX uint32 planes cross over as ``.view(np.int32)``).  Bitwise paths
must agree exactly; the channels draw from different generators (Philox in
the port, threefry in JAX) and must agree in distribution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.ops import bitops as jbitops
from iib_project_ldpc_codes_tpu.ops.channels import bec_packed_channel as \
    jax_bec_packed_channel
from iib_project_ldpc_codes_tpu.utils.stats import wilson
from iib_project_ldpc_codes_tpu_torch.ops import bitops
from iib_project_ldpc_codes_tpu_torch.ops.channels import bec_packed_channel


def _to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


def _random_words(rng, shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("shape", [(1, 32), (7, 96), (3, 5, 64)])
def test_pack_bits_matches_jax(shape):
    bits = np.random.default_rng(0).random(shape) < 0.5
    want = _to_torch(jbitops.pack_bits(jnp.asarray(bits)))
    got = bitops.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, 1), (9, 4), (2, 3, 5)])
def test_unpack_bits_matches_jax(shape):
    words = _random_words(np.random.default_rng(1), shape)
    want = np.asarray(jbitops.unpack_bits(jnp.asarray(words)))
    got = bitops.unpack_bits(torch.from_numpy(words.view(np.int32)))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(bitops.pack_bits(got),
                       torch.from_numpy(words.view(np.int32)))


def test_pack_bits_rejects_ragged():
    with pytest.raises(ValueError, match="multiple of 32"):
        bitops.pack_bits(torch.zeros(33, dtype=torch.bool))


@pytest.mark.parametrize("special", [0, 1, 0xFFFFFFFF, 0x80000000,
                                     0x7FFFFFFF, 0xAAAAAAAA, 0x80000001])
def test_popcount_matches_jax_on_special_words(special):
    words = np.array([special, special ^ 0xFFFFFFFF], np.uint32)
    want = np.asarray(jbitops.popcount(jnp.asarray(words)))
    got = bitops.popcount(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_popcount_and_total_match_jax_on_random_words():
    words = _random_words(np.random.default_rng(2), (64, 33))
    t = torch.from_numpy(words.view(np.int32))
    assert np.array_equal(bitops.popcount(t).numpy(),
                          np.asarray(jbitops.popcount(jnp.asarray(words))))
    assert int(bitops.total_popcount(t)) == int(
        jbitops.total_popcount(jnp.asarray(words)))


@pytest.mark.parametrize("shape", [(1, 1), (37, 5), (300, 1024)])
def test_per_trial_counts_matches_jax(shape):
    # (300, 1024) walks the rows in three slices in the plain version
    words = _random_words(np.random.default_rng(3), shape)
    want = np.asarray(jbitops.per_trial_counts(jnp.asarray(words)))
    got = bitops.per_trial_counts(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (shape[1] * 32,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad, exc", [
    (torch.zeros((4, 2), dtype=torch.int64), TypeError),
    (torch.zeros(8, dtype=torch.int32), ValueError),
    (torch.zeros((2, 4), dtype=torch.int32).t(), ValueError),
    (np.zeros((2, 2), np.int32), TypeError),
])
def test_per_trial_counts_rejects_bad_input(bad, exc):
    with pytest.raises(exc):
        bitops.per_trial_counts(bad)


# ---------------------------------------------------------------------------
# Philox
# ---------------------------------------------------------------------------

# Random123 known-answer vectors for philox4x32-10 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("ctr, key, want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = tuple(int(x) for x in bitops.philox4x32_10(ctr, key))
    assert got == want


def _philox_numpy(ctr, key):
    """Independent Philox4x32-10 in numpy uint64 (products < 2^64)."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    mask = np.uint64(0xFFFFFFFF)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & mask,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & mask]
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return c


def test_philox_matches_numpy():
    rng = np.random.default_rng(4)
    ctr = [rng.integers(0, 2**32, 1000, dtype=np.uint64) for _ in range(4)]
    key = tuple(int(x) for x in rng.integers(0, 2**32, 2, dtype=np.uint64))
    want = _philox_numpy(ctr, key)
    got = bitops.philox4x32_10([torch.from_numpy(c.astype(np.int64))
                                for c in ctr], key)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.astype(np.int64))
    for ctr_kat, key_kat, want_kat in KAT:
        got_kat = [int(x[()]) for x in _philox_numpy(ctr_kat, key_kat)]
        assert tuple(got_kat) == want_kat


@pytest.mark.parametrize("prob, nibble", [
    (0.5, 0b0001), (0.7, 0b1001), (0.8, 0b1101), (0.9, 0b1111)])
def test_bernoulli_packed_known_answer(prob, nibble):
    # bits 0-3 of word 0 at seed 0, offset 0 are the four lanes of Philox
    # at counter 0, key 0 (6627e8d5 e169c58d bc57ac4c 9b00dbd8), each set
    # iff below floor(p * 2^32)
    word = bitops.bernoulli_packed(prob, (1, 1), seed=0)
    assert int(word[0, 0]) & 0xF == nibble


def _bernoulli_numpy(prob, shape, seed, offset):
    """The documented packing scheme, independently in numpy."""
    thr = bitops.bernoulli_threshold(prob)
    key = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
    total = int(np.prod(shape))
    words = np.zeros(total, np.uint64)
    idx = np.arange(total, dtype=np.uint64)
    for j in range(8):
        g = idx * np.uint64(8) + np.uint64(j)
        lanes = _philox_numpy(
            [g & np.uint64(0xFFFFFFFF), g >> np.uint64(32),
             np.full(total, offset & 0xFFFFFFFF, np.uint64),
             np.full(total, offset >> 32, np.uint64)], key)
        for lane, draw in enumerate(lanes):
            words |= (draw < np.uint64(min(thr, 2**64 - 1))).astype(
                np.uint64) << np.uint64(4 * j + lane)
    return words.astype(np.uint32).view(np.int32).reshape(shape)


@pytest.mark.parametrize("prob, seed, offset", [
    (0.42, 7, 3), (0.05, 2**40 + 5, 2**33 + 1), (0.999, 0, 0)])
def test_bernoulli_packed_matches_numpy_scheme(prob, seed, offset):
    got = bitops.bernoulli_packed(prob, (13, 6), seed=seed, offset=offset)
    want = _bernoulli_numpy(prob, (13, 6), seed, offset)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("prob, fill", [(0.0, 0), (-0.5, 0), (1.0, -1),
                                        (1.5, -1)])
def test_bernoulli_packed_edges(prob, fill):
    got = bitops.bernoulli_packed(prob, (5, 3), seed=1)
    assert torch.equal(got, torch.full((5, 3), fill, dtype=torch.int32))


def test_bernoulli_threshold():
    assert bitops.bernoulli_threshold(0.5) == 2**31
    assert bitops.bernoulli_threshold(1 - 2**-40) == 2**32 - 1
    assert bitops.bernoulli_threshold(2.0) == 2**32
    with pytest.raises(ValueError):
        bitops.bernoulli_threshold(float("nan"))


def test_bernoulli_packed_reproducible_by_seed_and_offset():
    a = bitops.bernoulli_packed(0.3, (50, 4), seed=9, offset=2)
    assert torch.equal(a, bitops.bernoulli_packed(0.3, (50, 4), seed=9,
                                                  offset=2))
    assert not torch.equal(a, bitops.bernoulli_packed(0.3, (50, 4), seed=9,
                                                      offset=3))
    assert not torch.equal(a, bitops.bernoulli_packed(0.3, (50, 4), seed=10,
                                                      offset=2))


@pytest.mark.parametrize("eps", [0.1, 0.42])
def test_channel_rate_agrees_with_jax(eps):
    shape = (256, 64)
    total = shape[0] * shape[1] * 32
    ours = int(bitops.total_popcount(
        bec_packed_channel(eps, shape, seed=5)))
    theirs = int(jbitops.total_popcount(
        jax_bec_packed_channel(jax.random.key(5), eps, shape)))
    sigma = math.sqrt(eps * (1 - eps) / total)
    assert abs(ours / total - eps) < 5 * sigma
    assert abs(theirs / total - eps) < 5 * sigma
    lo_a, hi_a = wilson(ours, total, alpha=0.01)
    lo_b, hi_b = wilson(theirs, total, alpha=0.01)
    assert lo_a <= hi_b and lo_b <= hi_a


def test_channel_bits_independent_across_positions():
    # each of the 32 bit positions and each row sees the same rate
    planes = bec_packed_channel(0.3, (2000, 8), seed=6)
    per_trial = bitops.per_trial_counts(planes).double() / 2000
    sigma = math.sqrt(0.3 * 0.7 / 2000)
    assert float((per_trial - 0.3).abs().max()) < 5 * sigma
