"""The port's multi-device Monte Carlo over real ``torch.distributed`` groups.

Groups of 2 and 4 ranks are spawned with ``torch.multiprocessing`` on a
free local port, over gloo on the CPU, and checked against one process:

  * a batch-sharded ``run_simulation`` over 2 ranks equals, counter for
    counter, the per-rank chunks (``make_chunk_fn(cfg, code, rank=r,
    size=D)``) summed in one process, for every chunk family;
  * the edge-sharded decode over 2 and 4 ranks equals JAX's edge-sharded
    decode on the same code and planes, on every rank, and the edge-sharded
    engine equals the unsharded one, with checkpoint and resume;
  * only rank 0 writes; a resume starts from rank 0's checkpoint on every
    rank; the peeling driver refuses a job of several processes;
  * the multi-process entry point (2 processes) prints equal lines, and the
    dry run prints its ``ok`` line;
  * 2-rank runs agree with the JAX package's 2-device runs by overlapping
    99% intervals (Philox is not threefry).

The spawned ranks import this module, so it imports JAX only inside the
tests.  Each group costs a few seconds of process start-up.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from iib_project_ldpc_codes_tpu_torch.models.code import code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.ensemble import sample_code
from iib_project_ldpc_codes_tpu_torch.models.irregular import \
    irregular_code_from_numpy
from iib_project_ldpc_codes_tpu_torch.models.qc import sample_qc_code
from iib_project_ldpc_codes_tpu_torch.ops.bitops import pack_bits
from iib_project_ldpc_codes_tpu_torch.parallel import distributed, dryrun
from iib_project_ldpc_codes_tpu_torch.parallel import edge_sharded as es
from iib_project_ldpc_codes_tpu_torch.parallel import montecarlo as mc
from iib_project_ldpc_codes_tpu_torch.utils.config import SimulationConfig

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
ARGV = ["0.45", "512", "20", "96", "3", "6", "3", "7"]   # mode 3, code 7
FIELDS = ("num_trials", "block_errors", "bit_errors", "bit_errors_sq",
          "excluded_trials", "code_bit_errors_sq", "trials_per_code",
          "error_counts_per_iteration", "stopped_by")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _family(name):
    """(config, fixed code or None) of one batch-sharded chunk family."""
    base = dict(channel="BEC", channel_param=0.42, n=240, dv=3, dc=6,
                decoder="bp", iterations=30, batch=256, num_tests=512,
                max_block_errors=10**9, seed=3, code_mode="fixed")
    code = sample_code(_gen(1), 240, 3, 6)
    kw = {"fixed_bec": {},
          "fixed_bec_expurgated": dict(expurgation=2),
          "random_bec": dict(transmit="random"),
          "ensemble_bec": dict(code_mode="ensemble", codes_per_chunk=4),
          "irregular_bec": dict(code_mode="ensemble", codes_per_chunk=2,
                                lam=LAM, rho=RHO, dv=None, dc=None),
          "gallager_a": dict(channel="BSC", decoder="gallager",
                             channel_param=0.03),
          "int8_soft": dict(channel="AWGN", decoder="minsum",
                            soft_msg_dtype="int8", channel_param=0.8,
                            batch=64, num_tests=128, iterations=15),
          "qc_bec": {}}[name]
    if name == "qc_bec":
        code = sample_qc_code(_gen(2), nb=12, dv=3, dc=6, Z=20)
    cfg = SimulationConfig(**{**base, **kw})
    return cfg, None if cfg.code_mode == "ensemble" else code


FAMILIES = ("fixed_bec", "fixed_bec_expurgated", "random_bec",
            "ensemble_bec", "irregular_bec", "gallager_a", "int8_soft",
            "qc_bec")


def _counters(res):
    return {f: getattr(res, f) for f in FIELDS}


def _per_rank_sum(cfg, code, size):
    """The counters of a ``size``-rank run, from the per-rank chunks added
    in this one process, when no stopping rule fires before the trial
    budget."""
    fns = [mc.make_chunk_fn(cfg, code, device="cpu", rank=r, size=size)
           for r in range(size)]
    tot = dict(block=0, bit=0, excl=0, sq=0.0, csq=0.0,
               et=np.zeros(cfg.iterations + 1, np.int64))
    chunks = -(-cfg.num_tests // cfg.batch)
    for c in range(chunks):
        for fn in fns:
            s = fn(c)
            tot["et"] += s.error_totals.numpy().astype(np.int64)
            tot["block"] += int(s.block_errors)
            tot["bit"] += int(s.bit_errors)
            tot["excl"] += int(s.excluded)
            tot["sq"] += float(s.bit_errors_sq)
            if s.code_bit_errors_sq is not None:
                tot["csq"] += float(s.code_bit_errors_sq)
    ens = cfg.code_mode == "ensemble"
    return {"num_trials": chunks * cfg.batch, "block_errors": tot["block"],
            "bit_errors": tot["bit"], "bit_errors_sq": tot["sq"],
            "excluded_trials": tot["excl"],
            "code_bit_errors_sq": tot["csq"] if ens else None,
            "trials_per_code": (32 * mc._ensemble_layout(cfg, size)[1]
                                if ens else None),
            "error_counts_per_iteration": tot["et"].tolist(),
            "stopped_by": "num_tests"}


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------

def _rank_entry(rank, worker, size, port, args):
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", size, rank, device="cpu",
                           timeout_s=120)
    try:
        worker(rank, size, *args)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(worker, size, outdir, *args):
    """Run ``worker(rank, size, outdir, *args)`` on ``size`` gloo ranks;
    returns what each rank saved to ``outdir/rank<r>.pt``."""
    mp.spawn(_rank_entry, args=(worker, size, dryrun.free_port(),
                                (outdir,) + args), nprocs=size, join=True)
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(size)]


def _jax_tables(seed, kind, n):
    """A JAX-sampled code's tables, as numpy, and numpy erasure planes."""
    import jax

    from iib_project_ldpc_codes_tpu.models.ensemble import sample_code \
        as jax_sample_code
    from iib_project_ldpc_codes_tpu.models.irregular import \
        IrregularEnsembleSpec

    if kind == "regular":
        jcode = jax_sample_code(jax.random.key(seed), n, 3, 6)
        tables = (np.asarray(jcode.chk_to_var),)
    else:
        jcode = IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO).sample(
            jax.random.key(seed))
        tables = tuple(np.asarray(getattr(jcode, f)) for f in
                       ("chk_to_var", "var_to_chk", "var_to_sock"))
    bits = np.random.default_rng(seed).random((n, 64)) < 0.44
    erased = pack_bits(torch.from_numpy(bits)).numpy()
    return jcode, tables, erased


def _port_code(kind, n, tables):
    if kind == "regular":
        return code_from_numpy(tables[0], n, 3, 6)
    return irregular_code_from_numpy(*tables, n, tables[0].shape[0] - 1)


def _edge_decodes(cases, group=None):
    out = {}
    for key, (kind, n, tables, erased) in cases.items():
        code = _port_code(kind, n, tables)
        decode = es.edge_sharded_bp_decode if kind == "regular" \
            else es.edge_sharded_bp_decode_irregular
        res = decode(code, torch.from_numpy(erased), 60, group)
        out[key] = (res.known.numpy(), res.error_totals.numpy(),
                    res.iterations)
    return out


def _jax_edge_decode(jcode, kind, erased, size):
    import jax
    import jax.numpy as jnp

    from iib_project_ldpc_codes_tpu.parallel import edge_sharded as jes
    from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh

    decode = jes.edge_sharded_bp_decode if kind == "regular" \
        else jes.edge_sharded_bp_decode_irregular
    res = decode(jcode, jnp.asarray(erased.view(np.uint32)), 60,
                 make_mesh(jax.devices()[:size]))
    return (np.asarray(res.known).view(np.int32),
            np.asarray(res.error_totals), int(res.iterations))


# ---------------------------------------------------------------------------
# The 2-rank group
# ---------------------------------------------------------------------------

def _edge_cfg(**kw):
    base = dict(channel="BEC", channel_param=0.45, n=512, dv=3, dc=6,
                decoder="bp", iterations=50, num_tests=256, batch=64,
                max_block_errors=10**9, seed=5, code_mode="fixed",
                edge_sharded=True)
    base.update(kw)
    return SimulationConfig(**base)


def _two_rank_worker(rank, size, outdir, cases, stats_tables):
    out = {"families": {}}
    for name in FAMILIES:
        cfg, code = _family(name)
        out["families"][name] = _counters(mc.run_simulation(
            cfg, code, device="cpu", group=distributed.global_group()))
    out["edge"] = _edge_decodes(cases)
    # the edge-sharded engine, with a checkpoint of this rank's own
    code = sample_code(_gen(9), 512, 3, 6)
    out["edge_full"] = _counters(mc.run_simulation(_edge_cfg(), code,
                                                   device="cpu"))
    ck = os.path.join(outdir, f"edge{rank}.ck")
    mc.run_simulation(_edge_cfg(num_tests=128, checkpoint_path=ck,
                                checkpoint_every_chunks=1), code,
                      device="cpu")
    out["edge_resumed"] = _counters(mc.run_simulation(
        _edge_cfg(checkpoint_path=ck, checkpoint_every_chunks=1), code,
        device="cpu"))
    out["edge_ck_written"] = os.path.exists(ck)
    # rank 0's checkpoint says the run is done; rank 1 has none
    ck0 = os.path.join(outdir, "done.ck") if rank == 0 else \
        os.path.join(outdir, "absent.ck")
    cfg, code = _family("fixed_bec")
    cfg.checkpoint_path = ck0
    out["resumed_from_rank0"] = _counters(mc.run_simulation(
        cfg, code, device="cpu", group=distributed.global_group()))
    out["wrote"] = distributed.save_result_primary(
        mc.run_simulation(_family("fixed_bec")[0], _family("fixed_bec")[1],
                          device="cpu", group=distributed.global_group()),
        os.path.join(outdir, "results"))
    try:
        mc.run_simulation(SimulationConfig(
            decoder="peeling", n=96, batch=64, num_tests=64,
            code_mode="fixed"), sample_code(_gen(3), 96, 3, 6),
            device="cpu")
        out["peeling"] = "ran"
    except RuntimeError as e:
        out["peeling"] = str(e)
    # the statistics run on a JAX-sampled code
    scfg = SimulationConfig(channel_param=0.40, n=512, iterations=50,
                            batch=512, num_tests=4096, seed=5,
                            max_block_errors=10**9, code_mode="fixed")
    out["stats"] = _counters(mc.run_simulation(
        scfg, code_from_numpy(stats_tables, 512, 3, 6), device="cpu",
        group=distributed.global_group()))
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("two_ranks"))
    jcodes, cases = {}, {}
    for key, (kind, n) in {"regular": ("regular", 384),
                           "irregular": ("irregular", 360)}.items():
        jcodes[key], tables, erased = _jax_tables(21, kind, n)
        cases[key] = (kind, n, tables, erased)
    stats_jcode, stats_tables, _ = _jax_tables(22, "regular", 512)
    cfg, _ = _family("fixed_bec")
    with open(os.path.join(outdir, "done.ck"), "w") as f:
        json.dump(dict(seed=cfg.seed, batch=cfg.batch, trials=cfg.num_tests,
                       chunk_idx=cfg.num_tests // cfg.batch,
                       error_totals=list(range(cfg.iterations + 1)),
                       block_errors=7, bit_errors=70, excluded=0,
                       bit_errors_sq=700.0), f)
    outs = _spawn(_two_rank_worker, 2, outdir, cases, stats_tables[0])
    return dict(outs=outs, cases=cases, jcodes=jcodes, outdir=outdir,
                stats_jcode=stats_jcode)


@pytest.mark.parametrize("name", FAMILIES)
def test_two_rank_run_equals_per_rank_sum(two_ranks, name):
    a, b = (o["families"][name] for o in two_ranks["outs"])
    assert a == b                     # every rank holds the totals
    cfg, code = _family(name)
    assert a == _per_rank_sum(cfg, code, 2)
    assert 0 < a["error_counts_per_iteration"][0]


@pytest.mark.parametrize("key", ["regular", "irregular"])
def test_two_rank_edge_decode_equals_jax(two_ranks, key):
    kind, n, tables, erased = two_ranks["cases"][key]
    want = _jax_edge_decode(two_ranks["jcodes"][key], kind, erased, 2)
    alone = _edge_decodes({key: two_ranks["cases"][key]})[key]
    for o in two_ranks["outs"]:
        got = o["edge"][key]
        for g, w, a in zip(got, want, alone):
            assert np.array_equal(g, w) and np.array_equal(g, a)


def test_two_rank_edge_engine_equals_unsharded_and_resumes(two_ranks):
    code = sample_code(_gen(9), 512, 3, 6)
    plain = _counters(mc.run_simulation(_edge_cfg(edge_sharded=False), code,
                                        device="cpu"))
    r0, r1 = two_ranks["outs"]
    assert r0["edge_full"] == r1["edge_full"] == plain
    assert r0["edge_resumed"] == r1["edge_resumed"] == plain
    # only rank 0 writes checkpoints
    assert r0["edge_ck_written"] and not r1["edge_ck_written"]


def test_resume_state_is_rank0s(two_ranks):
    for o in two_ranks["outs"]:
        res = o["resumed_from_rank0"]
        assert res["num_trials"] == 512 and res["block_errors"] == 7
        assert res["error_counts_per_iteration"] == list(range(31))


def test_only_rank0_writes(two_ranks):
    r0, r1 = two_ranks["outs"]
    assert r0["wrote"] and r1["wrote"] is None
    files = glob.glob(os.path.join(two_ranks["outdir"], "results", "*"))
    assert files == [r0["wrote"]]


def test_peeling_refuses_several_processes(two_ranks):
    for o in two_ranks["outs"]:
        assert "single-process only" in o["peeling"]


def test_two_rank_statistics_agree_with_jax_two_devices(two_ranks):
    import jax

    from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
    from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig \
        as JaxConfig
    from iib_project_ldpc_codes_tpu.utils.stats import wilson

    ours = two_ranks["outs"][0]["stats"]
    assert ours == two_ranks["outs"][1]["stats"]
    theirs = jmc.run_simulation(
        JaxConfig(channel_param=0.40, n=512, iterations=50, batch=512,
                  num_tests=4096, seed=5, max_block_errors=10**9,
                  code_mode="fixed"), code=two_ranks["stats_jcode"],
        mesh=make_mesh(jax.devices()[:2]))
    assert ours["num_trials"] == theirs.num_trials == 4096
    for a, b in ((ours["block_errors"], theirs.block_errors),
                 (ours["bit_errors"] / 512, theirs.bit_errors / 512)):
        lo_a, hi_a = wilson(a, 4096, alpha=0.01)
        lo_b, hi_b = wilson(b, 4096, alpha=0.01)
        assert lo_a <= hi_b and lo_b <= hi_a, (a, b)
    assert 0 < ours["block_errors"] < 4096


# ---------------------------------------------------------------------------
# The 4-rank group
# ---------------------------------------------------------------------------

def _four_rank_worker(rank, size, outdir, cases):
    out = {"edge": _edge_decodes(cases)}
    try:
        es.edge_sharded_bp_decode(sample_code(_gen(3), 100, 3, 6),
                                  torch.zeros((100, 1), dtype=torch.int32),
                                  10)
        out["indivisible"] = "ran"
    except ValueError as e:
        out["indivisible"] = str(e)
    cfg, code = _family("fixed_bec")
    out["fixed_bec"] = _counters(mc.run_simulation(
        cfg, code, device="cpu", group=distributed.global_group()))
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def test_four_rank_group(tmp_path):
    import jax
    import jax.numpy as jnp

    from iib_project_ldpc_codes_tpu.parallel import edge_sharded as jes
    from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh

    jcodes, cases = {}, {}
    for kind, n in (("regular", 384), ("irregular", 360)):
        jcodes[kind], tables, erased = _jax_tables(31, kind, n)
        cases[kind] = (kind, n, tables, erased)
    assert (cases["irregular"][2][0].shape[0]) % 4   # m + 1 gets padding
    outs = _spawn(_four_rank_worker, 4, str(tmp_path), cases)
    for key, (kind, _, _, erased) in cases.items():
        want = _jax_edge_decode(jcodes[key], kind, erased, 4)
        for o in outs:
            for g, w in zip(o["edge"][key], want):
                assert np.array_equal(g, w)
    with pytest.raises(ValueError) as jax_err:
        jes.edge_sharded_bp_decode(
            _jax_tables(3, "regular", 100)[0],
            jnp.zeros((100, 1), jnp.uint32), 10,
            make_mesh(jax.devices()[:4]))
    for o in outs:
        assert o["indivisible"] == str(jax_err.value)
    cfg, code = _family("fixed_bec")
    want = _per_rank_sum(cfg, code, 4)
    assert all(o["fixed_bec"] == want for o in outs)


# ---------------------------------------------------------------------------
# Single process: the per-rank streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fixed_bec", "ensemble_bec", "int8_soft",
                                  "qc_bec"])
def test_rank_chunk_is_the_single_device_chunk_at_its_offset(name):
    """Rank r of D draws chunk c at offset c * D + r: its stats are the
    one-device chunk of batch / D trials (codes_per_chunk / D codes) at
    chunk index c * D + r, so no two ranks or chunks share a draw."""
    cfg, code = _family(name)
    size = 2
    one = SimulationConfig(**{**json.loads(cfg.to_json()),
                              "batch": cfg.batch // size,
                              "codes_per_chunk": cfg.codes_per_chunk // size})
    single = mc.make_chunk_fn(one, code, device="cpu")
    for r in range(size):
        got = mc.make_chunk_fn(cfg, code, device="cpu", rank=r, size=size)(3)
        want = single(3 * size + r)
        for f in ("error_totals", "block_errors", "bit_errors", "excluded",
                  "bit_errors_sq", "code_bit_errors_sq"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("batch, codes, n_dev", [
    (1024, 32, 1), (1024, 32, 2), (1024, 32, 4), (768, 5, 2), (256, 64, 8)])
def test_ensemble_layout_equals_jax(batch, codes, n_dev):
    from iib_project_ldpc_codes_tpu.parallel import montecarlo as jmc
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig \
        as JaxConfig

    kw = dict(batch=batch, codes_per_chunk=codes, code_mode="ensemble")
    assert mc._ensemble_layout(SimulationConfig(**kw), n_dev) == \
        jmc._ensemble_layout(JaxConfig(**kw), n_dev)


def test_one_process_is_a_world_of_one():
    assert mc.world() == (None, 0, 1)
    with pytest.raises(ValueError, match="rank 2 outside a group of 2"):
        mc.make_chunk_fn(*_family("fixed_bec"), device="cpu", rank=2,
                         size=2)


def test_initialize_without_a_job_joins_nothing(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.is_primary() and distributed.global_group() is None
    assert distributed.local_device("cuda:1") == torch.device("cuda", 1)
    assert distributed.local_device("cuda", 3) == torch.device("cuda", 3)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        distributed.local_device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.local_device("cuda", 5) == torch.device("cuda", 2)
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="number of processes"):
        distributed.initialize(device="cpu")


def test_importing_the_parallel_modules_joins_and_spawns_nothing():
    code = ("import multiprocessing, torch.distributed as d\n"
            "from iib_project_ldpc_codes_tpu_torch.parallel import (\n"
            "    distributed, dryrun, edge_sharded, mesh, montecarlo,\n"
            "    multihost)\n"
            "assert not d.is_initialized()\n"
            "assert not multiprocessing.active_children()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

def test_multihost_two_processes_print_equal_lines(tmp_path):
    outdir = str(tmp_path / "out")
    port = dryrun.free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "iib_project_ldpc_codes_tpu_torch.parallel.multihost",
         f"--coordinator=127.0.0.1:{port}", "--num-processes=2",
         f"--process-id={pid}", "--device=cpu", f"--output-dir={outdir}"]
        + ARGV, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in (0, 1)]
    lines = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-3000:]
        lines.append(json.loads(stdout.strip().splitlines()[-1]))
    a, b = sorted(lines, key=lambda o: o["process_index"])
    assert (a["process_index"], b["process_index"]) == (0, 1)
    for o in (a, b):
        assert o["distributed"] is True
        assert o["process_count"] == o["mesh_devices"] == 2
    keys = ("num_trials", "block_errors", "bit_errors",
            "error_counts_per_iteration", "stopped_by")
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert a["is_primary"] and a["wrote"] and not b["is_primary"]
    assert b["wrote"] is None and os.listdir(outdir) == \
        [os.path.basename(a["wrote"])]
    # the same job in this one process, from the per-rank chunks
    from iib_project_ldpc_codes_tpu_torch.models.ensemble import \
        code_for_config

    cfg = SimulationConfig.from_reference_argv(ARGV)
    assert cfg.num_tests <= cfg.batch       # one chunk: no early stop
    want = _per_rank_sum(cfg, code_for_config(cfg), 2)
    for k in keys[:-1]:
        assert a[k] == want[k], k


def test_dryrun_two_ranks_prints_ok(capfd):
    assert dryrun.main(["2", "--device=cpu"]) == 0
    out = capfd.readouterr().out
    assert "dryrun(2) ok: batch-sharded BEC fixed/ensemble/irregular" in out
    assert "edge-sharded decode ran" in out


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    spawned = []
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs, join:
                        spawned.append((args[2], args[3], nprocs)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        dryrun.main(["2"])
    with pytest.raises(RuntimeError, match="--device=cpu"):
        dryrun.main(["2", "--device=cuda"])
    assert spawned == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, want in ((1, ("cuda:0", "gloo")), (2, ("cuda", None)),
                        (4, ("cuda", None))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        spawned.clear()
        assert dryrun.main(["2"]) == 0
        assert spawned == [want + (2,)], cards
    spawned.clear()
    assert dryrun.main(["2", "--device=cpu"]) == 0
    assert spawned == [("cpu", None, 2)]
    with pytest.raises(ValueError, match="unknown flag"):
        dryrun.main(["2", "--devices=2"])


@pytest.mark.parametrize("flag", ["--edge-shard", "--platform=cpu",
                                  "--cpu-devices=2"])
def test_multihost_rejects_unknown_flags(flag):
    from iib_project_ldpc_codes_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match=f"unknown flag {flag.split('=')[0]}"):
        multihost.main(ARGV + ["--device=cpu", flag])
    assert not torch.distributed.is_initialized()


def test_multihost_devices_must_match_the_job(tmp_path):
    from iib_project_ldpc_codes_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match="--devices=4 but this process runs "
                                         "in a job of 1 device"):
        multihost.main(ARGV + ["--device=cpu", "--devices=4",
                               f"--output-dir={tmp_path}"])
    assert os.listdir(tmp_path) == []
