"""The chip script's bound helpers on the CPU.

``chip_smoke.vertical_count_ops`` is the operation count that K4's bound
(``csrc/per_trial_counts.cu``) takes as what the per-trial counts need: a
numpy model of a bit-sliced carry-save counter computes the counts of
JAX's ``per_trial_counts`` within that many operations.
``chip_smoke.sass_loop_counts`` reads one trip of a kernel's largest loop
out of its SASS; here it reads hand-written listings.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from iib_project_ldpc_codes_tpu.ops import bitops as jbitops

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def carry_save_counts(words: np.ndarray):
    """Per-trial counts of uint32[rows, W] by a bit-sliced counter: words
    of one weight are compressed three to two by full adders (5 logic
    operations on a word), the last two of a weight by a half adder (2),
    and the 32 counts of a column read out of one word a weight at 3
    operations a bit.  Returns (int64[32 W] counts, operations)."""
    rows, width = words.shape
    ops = 0
    levels = [list(words)]
    k = 0
    while k < len(levels):
        pend = levels[k]
        carries = []
        while len(pend) >= 3:
            a, b, c = pend.pop(), pend.pop(), pend.pop()
            u = a ^ b
            pend.insert(0, u ^ c)
            carries.append((a & b) | (u & c))
            ops += 5 * width
        if len(pend) == 2:
            a, b = pend
            pend[:] = [a ^ b]
            carries.append(a & b)
            ops += 2 * width
        if carries:
            if k + 1 == len(levels):
                levels.append([])
            levels[k + 1].extend(carries)
        k += 1
    counts = np.zeros(32 * width, dtype=np.int64)
    bits = np.arange(32, dtype=np.uint32)
    for k, level in enumerate(levels):
        for x in level:
            counts += (((x[:, None] >> bits) & 1).astype(np.int64)
                       << k).reshape(-1)
            ops += 3 * 32 * width
    return counts, ops


@pytest.mark.parametrize("rows, width, p", [
    (1, 1, 0.5), (2, 3, 0.5), (97, 3, 0.42), (512, 2, 0.9), (1000, 4, 0.03),
])
def test_vertical_count_ops_hold_a_carry_save_counter(rows, width, p):
    rng = np.random.default_rng(rows * 31 + width)
    bits = rng.random((rows, 32 * width)) < p
    words = (bits.reshape(rows, width, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    counts, ops = carry_save_counts(words)
    assert np.array_equal(counts, bits.sum(axis=0))
    want = np.asarray(jbitops.per_trial_counts(jnp.asarray(words)))
    assert np.array_equal(counts, want)
    assert ops <= chip_smoke.vertical_count_ops(rows, width)


def _listing(lines) -> str:
    return "\n".join(f"        /*{a:04x}*/  {text} ;" for a, text in lines)


def test_sass_loop_counts_reads_one_trip(monkeypatch):
    lines = [(0x00, "MOV R1, c[0x0][0x28]"),
             (0x10, "LDG.E R2, [R4.64]"),
             (0x20, "DADD R6, R2, R2"),
             (0x30, "@P0 BRA 0x60"),
             (0x40, "@!P0 DMUL R6, R6, 2"),
             (0x50, "CALL.REL.NOINC 0x200"),
             (0x60, "IADD3 R4, R4, 0x4, RZ"),
             (0x70, "@P1 BRA 0x300"),
             (0x80, "LOP3.LUT R8, R6, R2, RZ, 0x96, !PT"),
             (0x90, "@P2 BRA 0x10"),
             (0xa0, "EXIT"),
             (0x200, "DFMA R6, R6, R6, R6"),
             (0x210, "RET.REL.NODEC R10 0x0")]
    monkeypatch.setattr(chip_smoke, "_res_usage",
                        lambda: {"_Z6kernelv": "REG:8"})
    monkeypatch.setattr(chip_smoke, "_cuobjdump",
                        lambda *flags: _listing(lines))
    got = chip_smoke.sass_loop_counts("kernel")
    assert got["function"] == "_Z6kernelv"
    assert got["span"][0].startswith("0010") and got["span"][-1] == \
        "0090 @P2 BRA 0x10"
    assert {k: got[k] for k in ("total", "fp64", "fp64_guarded", "int_alu",
                                "loads", "skipped", "exits", "calls")} == \
        {"total": 9, "fp64": 2, "fp64_guarded": 1, "int_alu": 2, "loads": 1,
         "skipped": 2, "exits": 1, "calls": 1}


def test_sass_loop_counts_needs_a_loop(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_res_usage",
                        lambda: {"_Z6kernelv": "REG:8"})
    monkeypatch.setattr(chip_smoke, "_cuobjdump", lambda *flags: _listing(
        [(0x00, "IADD3 R1, R1, 0x1, RZ"), (0x10, "EXIT")]))
    with pytest.raises(Exception, match="no loop"):
        chip_smoke.sass_loop_counts("kernel")
