"""The samplers' parallel shuffle and two-row repair, modelled on the CPU.

``models/ensemble.py::shuffle_rounds`` runs the Fisher-Yates shuffle as the
kernels do (``csrc/sampler.cuh``): rounds of deterministic reservations.
Here it is held to the plain sequential shuffle ``_shuffle_plain`` and to
this file's own step-by-step shuffle on Python integers, and its rounds to a
direct count of the steps' dependence depth.  ``repair_two_rows`` (the
kernels' repair loop: rows flagged once, two rows rescanned a pass) is held
to a full rescan at every pass.  No GPU is needed.
"""

import numpy as np
import pytest
import torch

from iib_project_ldpc_codes_tpu_torch.models import ensemble, irregular

_M32 = 0xFFFFFFFF


def _philox(ctr, key):
    """Philox4x32-10 on numpy uint64 lanes (independent of the port's
    code): counters (c0, c1, c2, c3) broadcast, key (k0, k1)."""
    c = [np.asarray(x, dtype=np.uint64) for x in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m32, s32 = np.uint64(_M32), np.uint64(32)
    for _ in range(10):
        p0, p1 = np.uint64(0xD2511F53) * c[0], np.uint64(0xCD9E8D57) * c[2]
        c = [((p1 >> s32) ^ c[1] ^ k0) & m32, p1 & m32,
             ((p0 >> s32) ^ c[3] ^ k1) & m32, p0 & m32]
        k0 = (k0 + np.uint64(0x9E3779B9)) & m32
        k1 = (k1 + np.uint64(0xBB67AE85)) & m32
    return c


def _partners(seed, chunk, code, attempt, num_sockets):
    """H[i] = uniform(draw i of stream ``attempt``, i + 1), H[0] = 0, as the
    port's models/ensemble.py docstring documents the draws."""
    key = ((seed & _M32), (seed >> 32) ^ 0x243F6A88)
    i = np.arange(num_sockets, dtype=np.uint64)
    x, y, z, w = _philox((i >> np.uint64(1), code, chunk, attempt), key)
    odd = (i & np.uint64(1)) == 1
    hi, lo = np.where(odd, w, y), np.where(odd, z, x)
    bound = i + np.uint64(1)            # below 2^31: no product overflows
    s32 = np.uint64(32)
    out = (hi * bound + ((lo * bound) >> s32)) >> s32
    out[0] = 0
    return out.astype(np.int64).tolist()


def _sequential_shuffle(partner):
    perm = list(range(len(partner)))
    for i in range(len(partner) - 1, 0, -1):
        j = partner[i]
        perm[i], perm[j] = perm[j], perm[i]
    return perm


def _dependence_depth(partner):
    """Rounds the reservations need: step i goes one round after the last
    of the earlier (higher) steps that share a position with it."""
    last = [0] * len(partner)   # latest round of a step at each position
    depth = 0
    for i in range(len(partner) - 1, 0, -1):
        h = partner[i]
        r = 1 + max(last[i], last[h])
        last[i] = last[h] = r
        depth = max(depth, r)
    return depth


def _rounds_model(seed, chunk, codes, attempts, num_sockets):
    codes = torch.as_tensor(codes, dtype=torch.int64)
    return ensemble.shuffle_rounds(ensemble.sampler_key(seed), codes, chunk,
                                   torch.as_tensor(attempts,
                                                   dtype=torch.int64),
                                   num_sockets)


@pytest.mark.parametrize("num_sockets", [1, 2, 3, 6, 60, 6144, 30_000])
@pytest.mark.parametrize("seed, chunk", [(0, 0), (2**40 + 9, 7),
                                          (123, 2**32 - 1)])
def test_rounds_equal_sequential_shuffle(seed, chunk, num_sockets):
    codes = [0, 1, 2**32 - 1] if num_sockets <= 6144 else [5]
    perm, rounds = _rounds_model(seed, chunk, codes, [0] * len(codes),
                                 num_sockets)
    plain = ensemble._shuffle_plain(ensemble.sampler_key(seed),
                                    torch.tensor(codes), chunk,
                                    torch.zeros(len(codes),
                                                dtype=torch.int64),
                                    num_sockets)
    assert torch.equal(perm, plain)
    for row, code in enumerate(codes):
        partner = _partners(seed, chunk, code, 0, num_sockets)
        assert perm[row].tolist() == _sequential_shuffle(partner)
        assert int(rounds[row]) == _dependence_depth(partner)


@pytest.mark.parametrize("attempt", [1, 2, 2**31 - 1])
def test_rounds_equal_sequential_shuffle_on_reject_streams(attempt):
    # reject reshuffles on stream pass + 1 with the same function
    perm, rounds = _rounds_model(4, 3, [0, 9], [attempt, attempt], 600)
    for row, code in enumerate((0, 9)):
        partner = _partners(4, 3, code, attempt, 600)
        assert perm[row].tolist() == _sequential_shuffle(partner)
        assert int(rounds[row]) == _dependence_depth(partner)


@pytest.mark.parametrize("num_sockets, low, high", [
    (3000, 15, 40), (30_000, 25, 50)])
def test_rounds_grow_like_log_of_the_sockets(num_sockets, low, high):
    # tens of rounds at E = 30,000, not E: no serial chain is left
    _, rounds = _rounds_model(1, 0, range(8), [0] * 8, num_sockets)
    assert low <= int(rounds.min()) and int(rounds.max()) <= high


def test_rounds_of_every_code_count_separately():
    # codes that finish early stop counting while the others go on
    _, together = _rounds_model(8, 1, range(6), [0] * 6, 300)
    for code in range(6):
        _, alone = _rounds_model(8, 1, [code], [0], 300)
        assert int(alone[0]) == int(together[code])


@pytest.mark.parametrize("sampler", ["regular", "irregular"])
def test_wrapper_fills_rounds_on_the_cpu(sampler):
    rounds = torch.full((5,), -1, dtype=torch.int32)
    if sampler == "regular":
        ensemble.sample_codes(3, 2, 5, 200, 3, 6, "raw", rounds=rounds)
        num_sockets = 600
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(
            200, [0, 0, 0.5, 0.5], [0, 0, 0, 0, 0.5, 0.5])
        irregular.sample_irregular_codes(3, 2, 5, spec, "raw", rounds=rounds)
        num_sockets = spec.E
    for code in range(5):
        partner = _partners(3, 2, code, 0, num_sockets)
        assert int(rounds[code]) == _dependence_depth(partner)
    with pytest.raises(ValueError, match="rounds"):
        ensemble.sample_codes(3, 2, 5, 200, 3, 6, "raw",
                              rounds=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="rounds"):
        ensemble.sample_codes(3, 2, 5, 200, 3, 6, "raw",
                              rounds=torch.zeros(5, dtype=torch.int64))


@pytest.mark.parametrize("num_sockets, layout", [
    (6144, ensemble.LAYOUT_ALL_SHARED),       # random ensemble, n = 2048
    (24_576, ensemble.LAYOUT_ALL_SHARED),     # soft chunks, n = 8192
    (30_000, ensemble.LAYOUT_ALL_SHARED),     # main ensemble path, n = 1e4
    (49_152, ensemble.LAYOUT_WORDS_SHARED),   # the experiment, n = 16,384
    (56_004, ensemble.LAYOUT_GLOBAL)])
def test_layouts_keep_the_sizes_the_port_samples_in_shared_memory(
        num_sockets, layout):
    assert ensemble.sampler_layout(num_sockets)[0] == layout


def test_layouts_fit_a_block():
    # csrc/sampler.cuh shared_bytes: 8 KB of masks, a 4-byte word a socket,
    # 2-byte partners in the all-shared layout; 227 KB a block on the H100
    masks, most = 8 * ensemble.SAMPLER_THREADS, 232_448
    assert masks + 4 * ensemble.SHARED_PERM_MAX_SOCKETS <= most
    assert masks + 4 * ensemble.SHARED_PARTNERS_MAX_SOCKETS \
        + 2 * ensemble.SHARED_PARTNERS_MAX_SOCKETS <= most
    # 16-bit halves hold every value and priority below 2^16
    assert ensemble.SHARED_PERM_MAX_SOCKETS <= 1 << 16
    # the masks' 64 bits a thread hold one row flag per check (m <= E)
    assert 64 * ensemble.SAMPLER_THREADS >= ensemble.SHARED_PERM_MAX_SOCKETS


def _full_rescan_offenders(perm, key, code, chunk, first_duplicates,
                           passes):
    """The plain repair one pass at a time, every row rescanned: the
    offender of every pass and the final permutation."""
    perm = perm.clone()
    codes = torch.tensor([code])
    out = []
    for p in range(passes):
        dup, first = first_duplicates(perm[None])
        if not bool(dup[0]):
            break
        s = int(first[0])
        out.append(s)
        hi, lo = ensemble._draws(key, torch.tensor(p), codes, chunk,
                                 ensemble.REPAIR_STREAM)
        j = int(ensemble._mulhi64(hi, lo, perm.shape[0])[0])
        perm[s], perm[j] = perm[j].clone(), perm[s].clone()
    return out, perm


_REGULAR = (150, 3, 6)
_IRREGULAR = (150, [0, 0, 0.5, 0.5], [0, 0, 0, 0, 0.5, 0.5])


def _case(family):
    if family == "regular":
        n, dv, dc = _REGULAR
        num_sockets = n * dv
        offs = torch.arange(0, num_sockets + 1, dc)
        var_of = torch.arange(num_sockets) // dv

        def dups(p):
            return ensemble._first_duplicates(p, dv, dc)
    else:
        spec = irregular.IrregularEnsembleSpec.from_lam_rho(*_IRREGULAR)
        num_sockets = spec.E
        offs = spec.chk_offs.long()
        var_of = spec.socket_var.long()

        def dups(p):
            return irregular._first_duplicates(p, spec)
    return num_sockets, offs, var_of, dups


@pytest.mark.parametrize("family", ["regular", "irregular"])
@pytest.mark.parametrize("start", ["shuffle 0", "shuffle 1", "shuffle 2",
                                   "identity"])
def test_two_row_rescan_finds_the_full_rescans_offender(family, start):
    # "identity" puts each variable's sockets side by side: almost every
    # row holds a duplicate, so the repair runs hundreds of passes
    key, chunk = ensemble.sampler_key(12), 3
    num_sockets, offs, var_of, dups = _case(family)
    code = 0 if start == "identity" else int(start[-1])
    if start == "identity":
        perm = torch.arange(num_sockets)
    else:
        perm = ensemble._shuffle_plain(key, torch.tensor([code]), chunk,
                                       torch.zeros(1, dtype=torch.int64),
                                       num_sockets)[0]
    got, offenders = ensemble.repair_two_rows(perm, key, code, chunk, offs,
                                              var_of)
    want, final = _full_rescan_offenders(perm, key, code, chunk, dups,
                                         ensemble.MAX_REPAIR_PASSES)
    assert offenders == want
    assert torch.equal(got, final)
    plain = ensemble._repair_with(perm.clone()[None], key,
                                  torch.tensor([code]), chunk, dups)[0]
    assert torch.equal(got, plain)
    if start == "identity":
        assert len(offenders) > 50
    assert not bool(dups(got[None])[0][0])


def test_two_row_rescan_stops_at_the_pass_cap():
    key, chunk = ensemble.sampler_key(12), 3
    num_sockets, offs, var_of, dups = _case("regular")
    perm = torch.arange(num_sockets)
    got, offenders = ensemble.repair_two_rows(perm, key, 0, chunk, offs,
                                              var_of, max_passes=7)
    assert len(offenders) == 7
    plain = ensemble._repair_with(perm.clone()[None], key,
                                  torch.tensor([0]), chunk, dups,
                                  max_passes=7)[0]
    assert torch.equal(got, plain)


def test_sampled_tables_follow_from_the_rounds_permutation():
    # the raw sampler's check table is the rounds permutation // dv
    n, dv, dc, num = 120, 3, 6, 4
    perm, _ = _rounds_model(7, 1, range(num), [0] * num, n * dv)
    codes = ensemble.sample_codes(7, 1, num, n, dv, dc, "raw")
    assert np.array_equal(codes.chk_to_var.numpy(),
                          (perm // dv).reshape(num, -1, dc).numpy())
