"""Time the QC Gallager round kernels on the card as the decode launches
them: Q3 ``qc_gallager_check`` (``csrc/qc_gallager_check.cu``) and Q4
``qc_gallager_variable`` (``csrc/qc_gallager_variable.cu``: the variable
pass with and without a codeword plane, and the first messages), and the
whole QC Gallager-A decode at n = 1,000,008.

    python examples/time_qc_gallager.py [--root DIR] [--reps 10]
        [--out chiprun_out/time_qc_gallager.json]

``--root DIR`` imports the package from DIR, an unpacked checkout of
another commit, instead of this tree (the timing helpers stay this tree's
``chip_smoke.py``'s): the passes' public calls are the same there.  To
compare two trees, run the script once per tree in one chip call, in turns
(other, this, this, other), and compare the JSON files; each holds a digest
of every pass's outputs, so equal digests show that both trees computed the
same thing.

Shapes (``chip_smoke.py``'s phase 28): the nb = 12 (3,6) base at n =
10,008 (Z = 834, W = 768) and n = 1,000,008 (Z = 83,334, W = 48), and the
irregular Gallager base (nb = 24, Z = 417, W = 768, lambda = x^2/2 +
x^3/2, rho = x^5: blocks of degree 3 and 4).  Both passes run on the
second round's messages (the first round's are the channel words; the
second moves), Q4 at Gallager-B's t = 1, its messages, decision and counts
reset outside the timing.  Timed after a warm-up, mean of ``reps``, by CUDA
events around single launches (``ms``: what a caller waits, the wrapper's
host work included) and by torch.profiler (``device_ms``: the kernel
alone).  The decode: 50 rounds at p = 0.03, CUDA events around whole
decodes (host loop included), and the device time by kernel of one decode.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/time_qc_gallager.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # this tree's helpers (timing, profiling, the card's line, the shapes),
    # then the package of the tree under test
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    from iib_project_ldpc_codes_tpu_torch.kernels import build as kbuild
    from iib_project_ldpc_codes_tpu_torch.models import qc
    from iib_project_ldpc_codes_tpu_torch.ops import bitops, qc_bp, \
        qc_gallager

    dev = torch.device("cuda")
    kbuild.build()
    out = {"root": str(root), "card": cs.smi_line(), "ms": {},
           "device_ms": {}, "digest": {}, "paths": {}}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    shapes = {
        "n1e4": (qc.sample_qc_code(gen(1), cs.QC_NB, cs.DV, cs.DC, cs.QC_Z,
                                   device=dev), cs.WORDS_FULL, cs.P_GAL),
        "n1e6": (qc.sample_qc_code(gen(3), cs.QC_NB, cs.DV, cs.DC,
                                   cs.QC_Z6, device=dev), cs.QC_W6,
                 cs.P_GAL),
        "irregular": (qc.sample_qc_code_irregular(
            gen(5), cs.QC_NB_IRR, cs.LAM_GAL, cs.RHO6, cs.QC_Z_IRR,
            device=dev), cs.WORDS_FULL, cs.P_GAL_IRR)}

    def measure(key, run, kernel, prepare=None):
        out["ms"][key] = cs.time_ms(run, prepare, reps=args.reps)
        out["device_ms"][key] = cs.device_ms(run, kernel, prepare,
                                             reps=args.reps)
        print(f"{key}: {out['ms'][key]:.4f} ms, device "
              f"{out['device_ms'][key]:.4f} ms", flush=True)

    for label, (c, words, p) in shapes.items():
        adj = qc_bp._adjacency(c, dev)
        clamp = isinstance(c, qc.IrregularQCLDPCCode)
        dvb = adj.var_chk.shape[1]
        rx = bitops.bernoulli_packed(p, (c.n, words), seed=7, offset=3,
                                     device=dev)
        tx = bitops.info_planes(c.n, words, seed=2, device=dev)
        sent = rx ^ tx                  # the same flips on codewords tx
        msg0 = torch.empty((adj.num_rows * adj.Z, words), dtype=torch.int32,
                           device=dev)
        qc_gallager.qc_gallager_variable(adj, msg0, None, rx, None, None,
                                         init=True)
        out["digest"][f"init_{label}"] = digest(msg0)
        parity = qc_gallager.qc_gallager_check(adj, msg0)
        counts = torch.zeros((1, 2), dtype=torch.int32, device=dev)
        decided = rx.clone()
        qc_gallager.qc_gallager_variable(
            adj, msg0, parity, rx, decided, counts,
            threshold=dvb if clamp else dvb - 1, clamp=clamp)
        parity = qc_gallager.qc_gallager_check(adj, msg0)
        out["digest"][f"check_{label}"] = digest(parity)
        state = {"msg": msg0.clone(), "decided": rx.clone(),
                 "counts": torch.zeros((1, 2), dtype=torch.int32,
                                       device=dev)}

        def fresh(state=state, msg0=msg0, rx=rx):
            state["msg"].copy_(msg0)
            state["decided"].copy_(rx)
            state["counts"].zero_()

        def variable(with_tx=False, adj=adj, parity=parity, rx=rx,
                     sent=sent, tx=tx, clamp=clamp, state=state):
            qc_gallager.qc_gallager_variable(
                adj, state["msg"], parity, sent if with_tx else rx,
                state["decided"], state["counts"], threshold=1, clamp=clamp,
                tx=tx if with_tx else None)

        measure(f"check_{label}", lambda adj=adj, msg0=msg0:
                qc_gallager.qc_gallager_check(adj, msg0),
                "qc_gallager_check")
        for with_tx in (False, True):
            name = f"variable_{label}" + ("_tx" if with_tx else "")
            fresh()
            variable(with_tx)
            out["digest"][name] = digest(state["msg"], state["decided"],
                                         state["counts"])
            out["paths"][name] = {
                k: getattr(qc_gallager.qc_gallager_variable, k, None)
                for k in ("vec", "paths")}
            measure(name, lambda v=variable, x=with_tx: v(x),
                    "qc_gallager_variable", prepare=fresh)
        measure(f"init_{label}", lambda adj=adj, rx=rx, state=state:
                qc_gallager.qc_gallager_variable(adj, state["msg"], None, rx,
                                                 None, None, init=True),
                "qc_gallager_init")

    # the whole decode at n = 1,000,008 (chip_smoke.py phase 32's
    # gallager_index), its rounds and its device time by kernel
    c, words, p = shapes["n1e6"]
    flips = bitops.bernoulli_packed(p, (c.n, words), seed=12, device=dev)

    def decode():
        return qc_gallager.qc_gallager_decode_packed(c, flips, cs.ITERS)

    res = decode()
    out["digest"]["decode_n1e6"] = digest(res.decided, res.error_totals)
    out["decode_rounds"] = int(res.iterations)
    out["decode_ms"] = cs.time_ms(decode, reps=3)
    # Q4's first-message launch is a kernel of another name, so the trace
    # is held to Q3's launch count alone
    kernels = {"qc_gallager_check": {"wrapper": qc_gallager.qc_gallager_check}}
    out["decode_profile"] = json.loads(cs.device_time_breakdown(
        lambda: int(decode().iterations), out["decode_ms"], kernels))
    print(f"decode n1e6: {out['decode_ms']:.3f} ms, "
          f"{out['decode_rounds']} rounds", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("card", "ms", "device_ms",
                                          "decode_ms", "digest")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
