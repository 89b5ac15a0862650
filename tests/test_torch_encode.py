"""The port's systematic encoder (``models/encode.py``) against the JAX
package's on the CPU.

Codes are sampled by JAX and carried over as numpy tables, dense H are
drawn with numpy, and information planes are drawn with numpy and handed
to both packages.  Every comparison is exact: the elimination, the
encoder's fields and the encoded planes are integer functions of the same
input, so they must be equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu.models import encode as jenc
from iib_project_ldpc_codes_tpu.models import irregular as jir
from iib_project_ldpc_codes_tpu.models.code import dense_parity_check as \
    jax_dense
from iib_project_ldpc_codes_tpu.models.ensemble import (
    sample_code as jax_sample_code, sample_codes as jax_sample_codes)
from iib_project_ldpc_codes_tpu.ops.ml import _pack_rows as jax_pack_rows, \
    gf2_row_reduce as jax_gf2_row_reduce
from iib_project_ldpc_codes_tpu_torch.models import encode
from iib_project_ldpc_codes_tpu_torch.models.code import (
    code_from_numpy, codes_from_numpy, dense_parity_check)
from iib_project_ldpc_codes_tpu_torch.models.irregular import (
    irregular_code_from_numpy, irregular_codes_from_numpy)
from iib_project_ldpc_codes_tpu_torch.ops import bitops
from iib_project_ldpc_codes_tpu_torch.ops.bitops import unpack_bits

LAM, RHO = [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0]


def _carry_irregular(jcode):
    tables = [np.asarray(getattr(jcode, f))
              for f in ("chk_to_var", "var_to_chk", "var_to_sock")]
    make = irregular_codes_from_numpy if tables[0].ndim == 3 else \
        irregular_code_from_numpy
    return make(*tables, jcode.n, jcode.m)


def _rank_deficient_h(seed, m=60, n=150):
    """A random sparse H whose last rows are XORs of earlier ones."""
    rng = np.random.default_rng(seed)
    h = rng.random((m, n)) < 0.06
    h[-1] = h[0] ^ h[1]
    h[-2] = h[2] ^ h[3] ^ h[4]
    h[-3] = h[5]
    return h


def _case(kind, seed):
    """(port code or None, dense H) of one test case."""
    if kind == "regular":
        jcode = jax_sample_code(jax.random.key(seed), 240, 3, 6)
        code = code_from_numpy(np.asarray(jcode.chk_to_var), 240, 3, 6)
        return code, jax_dense(jcode)
    if kind == "irregular":
        jcode = jir.IrregularEnsembleSpec.from_lam_rho(
            252, LAM, RHO).sample(jax.random.key(seed))
        return _carry_irregular(jcode), jir.dense_parity_check_irregular(jcode)
    return None, _rank_deficient_h(seed)


def _info(k, words, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, (k, words), dtype=np.uint32)


def _syndrome(h: np.ndarray, planes: torch.Tensor) -> np.ndarray:
    bits = unpack_bits(planes).numpy().astype(np.int64)
    return (h.astype(np.int64) @ bits) % 2


@pytest.mark.parametrize("kind", ["regular", "irregular", "rank_deficient"])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_encoder_matches_jax(kind, seed):
    code, h = _case(kind, seed)
    want = jenc.make_encoder(h=h)
    got = encode.make_encoder(code) if code is not None else \
        encode.make_encoder(h=h)
    assert np.array_equal(got.pivot_cols, np.asarray(want.pivot_cols))
    assert np.array_equal(got.free_cols, np.asarray(want.free_cols))
    assert got.parity_map.dtype == np.uint64
    assert np.array_equal(got.parity_map, want.parity_map)
    assert (got.rank, got.k_eff) == (want.rank, want.k_eff)
    if kind == "rank_deficient":
        assert got.rank == h.shape[0] - 3
    bits = np.random.default_rng(seed).integers(0, 2, (5, got.k_eff))
    assert np.array_equal(got.encode(bits), want.encode(bits))
    assert not ((got.encode(bits).astype(np.int64) @ h.T) % 2).any()


@pytest.mark.parametrize("seed", [0, 3])
def test_gf2_row_reduce_matches_jax(seed):
    h = _rank_deficient_h(seed, m=70, n=130)
    want, want_piv = jax_gf2_row_reduce(jax_pack_rows(h), h.shape[1])
    got, piv, rank = encode.gf2_row_reduce(encode._pack_rows(
        torch.from_numpy(h)), h.shape[1])
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert int(rank) == len(want_piv)
    assert piv[:int(rank)].tolist() == list(want_piv)
    assert (piv[int(rank):] == -1).all()


@pytest.mark.parametrize("kind", ["regular", "irregular", "rank_deficient"])
def test_encode_packed_matches_jax_one_code(kind):
    code, h = _case(kind, 5)
    jax_encoder = jenc.make_encoder(h=h)
    info = _info(jax_encoder.k_eff, 4, 7)
    want = jenc.encode_packed(jenc.encoder_planes(jax_encoder),
                              jnp.asarray(info))
    planes = encode.code_encoder_planes(code) if code is not None else \
        encode.encoder_planes(encode.make_encoder(h=h))
    got = encode.encode_packed(planes, torch.from_numpy(info.view(np.int32)))
    assert np.array_equal(got.numpy(), np.asarray(want).view(np.int32))
    assert not _syndrome(h, got).any()


@pytest.mark.parametrize("irregular", [False, True])
def test_encode_packed_padded_batch_matches_jax(irregular):
    num, words = 4, 8
    if irregular:
        spec = jir.IrregularEnsembleSpec.from_lam_rho(126, LAM, RHO)
        jcodes = [spec.sample(k) for k in jax.random.split(
            jax.random.key(9), num)]
        hs = [jir.dense_parity_check_irregular(c) for c in jcodes]
        batch = _carry_irregular(jax.tree.map(lambda *x: jnp.stack(x),
                                              *jcodes))
    else:
        jcodes = jax_sample_codes(jax.random.key(9), num, 120, 3, 6)
        chk = np.asarray(jcodes.chk_to_var)
        batch = codes_from_numpy(chk, 120, 3, 6)
        hs = [dense_parity_check(batch.select(i)) for i in range(num)]
    n = hs[0].shape[1]
    jax_encoders = [jenc.make_encoder(h=h) for h in hs]
    jplanes = jenc.encoder_planes_padded(jax_encoders, n)
    planes = encode.code_encoder_planes(batch)
    # the padded planes: the same sentinels, the same (unpacked) maps
    assert np.array_equal(planes.free.numpy(), np.asarray(jplanes[1]))
    assert np.array_equal(planes.pivots.numpy(), np.asarray(jplanes[2]))
    k_max = planes.k
    assert np.array_equal(unpack_bits(planes.mask)[..., :k_max].numpy(),
                          np.asarray(jplanes[0]))
    from_encoders = encode.encoder_planes_padded(
        [encode.make_encoder(h=h) for h in hs], n)
    for field in ("mask", "free", "pivots"):
        assert torch.equal(getattr(from_encoders, field),
                           getattr(planes, field))
    # JAX encodes code i on its own words; the port the whole batch at once
    info = _info(k_max, words, 11)
    wpc = words // num
    want = np.concatenate([
        np.asarray(jenc.encode_packed(
            tuple(p[i] for p in jplanes),
            jnp.asarray(info[:, i * wpc:(i + 1) * wpc]), n=n))
        for i in range(num)], axis=1)
    got = encode.encode_packed(planes, torch.from_numpy(info.view(np.int32)))
    assert np.array_equal(got.numpy(), want.view(np.int32))
    for i, h in enumerate(hs):
        assert not _syndrome(h, got[:, i * wpc:(i + 1) * wpc]
                             .contiguous()).any()


def test_encoder_planes_padded_mixed_ranks_matches_jax():
    """Encoders of different rank pad to rank_max / k_max with JAX's
    sentinel and zero map bits."""
    hs = [_rank_deficient_h(0), _rank_deficient_h(1)]
    hs[1][-4] = hs[1][6] ^ hs[1][7]
    n = hs[0].shape[1]
    encoders = [encode.make_encoder(h=h) for h in hs]
    assert encoders[0].rank != encoders[1].rank
    jplanes = jenc.encoder_planes_padded([jenc.make_encoder(h=h) for h in hs],
                                         n)
    planes = encode.encoder_planes_padded(encoders, n)
    assert np.array_equal(planes.free.numpy(), np.asarray(jplanes[1]))
    assert np.array_equal(planes.pivots.numpy(), np.asarray(jplanes[2]))
    assert np.array_equal(unpack_bits(planes.mask)[..., :planes.k].numpy(),
                          np.asarray(jplanes[0]))
    assert not unpack_bits(planes.mask)[..., planes.k:].any()


def test_encoder_size_guard_keeps_jax_message():
    with pytest.raises(ValueError, match="validation-scale"):
        encode._check_map_size(2 ** 14 + 1, 2 ** 14)
    encode._check_map_size(2 ** 14, 2 ** 14)


def test_encode_packed_contract():
    code, h = _case("regular", 2)
    planes = encode.code_encoder_planes(code)
    with pytest.raises(ValueError, match="rows"):
        encode.encode_packed(planes, torch.zeros((planes.k + 1, 2),
                                                 dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        encode.encode_packed(planes, torch.zeros((planes.k, 2)))
    batch = encode.encoder_planes_padded([encode.make_encoder(h=h)] * 2,
                                         h.shape[1])
    with pytest.raises(ValueError, match="split"):
        encode.encode_packed(batch, torch.zeros((batch.k, 3),
                                                dtype=torch.int32))
    with pytest.raises(ValueError, match="code or a dense H"):
        encode.make_encoder()


def test_info_planes_stream():
    """Fair bits on a key of their own: K1 at p = 0.5 with INFO_KEY_TAG in
    key word 0, apart from the untagged noise planes of the same offset."""
    info = bitops.info_planes(64, 32, seed=5, offset=3)
    assert torch.equal(info, bitops.bernoulli_packed(
        0.5, (64, 32), seed=5, offset=3, key_tag=bitops.INFO_KEY_TAG))
    assert not torch.equal(info, bitops.bernoulli_packed(
        0.5, (64, 32), seed=5, offset=3))
    assert bitops.INFO_KEY_TAG not in (0, 0xB7E15162)
    frac = float(bitops.total_popcount(info)) / info.numel() / 32
    assert abs(frac - 0.5) < 5 * (0.25 / info.numel() / 32) ** 0.5
