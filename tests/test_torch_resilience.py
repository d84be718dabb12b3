"""The kill-a-host matrix on the port, against the reference where bytes
can be compared.

Every test states its failure with ``repro_torch.testing.faults`` — a host
dying between two save phases (``FaultInjector`` on the coordinator's
seams), at a barrier (``FaultyCollective``), torn shard files, corrupted
replica CRCs, partners dying mid-fetch — and checks the resilience
hierarchy's contract: saves land degraded-but-complete from partner L2
replicas (the degraded step dir byte for byte the reference's), restores
are served by the nearest live level with exact byte accounting, and
unrecoverable failures abort cleanly with the previous checkpoint intact.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_coordinated import expected_leaves, make_masks, make_state
from test_resilience import resilient_save as r_resilient_save
from test_torch_coordinated import (assert_dirs_identical, run_hosts,
                                    t_arrays, t_report, t_state)

import repro_torch.checkpoint as TC
from repro_torch._tensors import to_host
from repro_torch.checkpoint import levels as levels_mod
from repro_torch.checkpoint.levels import (L1_RESIDENT, L2_PARTNER,
                                           L4_STORE, LEVEL_ORDER,
                                           default_l2_root, partner_of)
from repro_torch.checkpoint.store import ALIVE_FILE
from repro_torch.distributed.collective import (BarrierTimeout,
                                                FileCollective,
                                                ProcessContext,
                                                process_segments)
from repro_torch.testing import faults
from repro_torch.testing.faults import (FaultInjector, FaultyCollective,
                                        HostKilled, corrupt_crc,
                                        injector_from_env,
                                        partner_fetch_failure, shard_files,
                                        stalled_writer, tear_file)

torch.set_num_threads(1)

BARRIER_S = 1.5         # land/commit barrier timeout in fault tests


def _mgr(root, coll, inj=None, keep_n=4, engine="host", **kw):
    report = t_report(make_masks())
    return TC.CoordinatedCheckpointManager(
        [TC.Level(root, keep_n=keep_n, shards=1)], collective=coll,
        scrutiny_fn=lambda s: report, save_mode="device",
        pipeline_engine=engine, barrier_timeout_s=BARRIER_S,
        fault_injector=inj, device="cpu", **kw)


def resilient_save(root, count, victim=None, point=None, barrier_kill=None,
                   keep_n=4, engine="host"):
    """Save step 1 on ``count`` simulated hosts; ``victim`` dies at the
    injector ``point`` or at the ``barrier_kill`` (mode, substr) barrier.
    Survivors return (state arrays, finalized last_save_stats)."""

    def host(p, coll):
        inj = None
        if p == victim and point is not None:
            inj = FaultInjector().kill_at(point)
        if p == victim and barrier_kill is not None:
            mode, substr = barrier_kill
            coll = FaultyCollective(coll)
            (coll.kill_before if mode == "before"
             else coll.kill_after)(substr)
        mgr = _mgr(root, coll, inj, keep_n=keep_n, engine=engine)
        state = t_state()
        mgr.save(1, state)
        mgr.wait()
        stats = dict(mgr.last_save_stats)
        mgr.close()
        return t_arrays(state), stats

    return run_hosts(count, host, timeout=30.0)


def expected():
    return expected_leaves({k: np.asarray(v) for k, v
                            in make_state().items()}, make_masks(),
                           scrutinized=True)


def assert_bit_identical_restore(root, expect_step=1):
    mgr = TC.CheckpointManager([TC.Level(root)], device="cpu")
    st, got = mgr.restore(t_state(step_val=0))
    assert st == expect_step
    for k, v in expected().items():
        np.testing.assert_array_equal(to_host(got[k]), v, err_msg=k)
    mgr.close()


def elastic_restore(root, count):
    def host(p, coll):
        mgr = TC.CoordinatedCheckpointManager([TC.Level(root)],
                                              collective=coll, device="cpu")
        st, got = mgr.restore(t_state(step_val=0), local_only=True)
        stats = dict(mgr.last_restore_stats)
        mgr.close()
        return st, t_arrays(got), stats

    results, errors = run_hosts(count, host, timeout=30.0)
    assert not any(errors), [e for e in errors if e]
    return results


def assert_owned_rows_match(results, count):
    exp = expected()
    for lo, hi, owner in process_segments(exp["w"].shape, count):
        np.testing.assert_array_equal(results[owner][1]["w"][lo:hi],
                                      exp["w"][lo:hi])


# --------------------------------------------------------------------------
# the liveness-aware barrier
# --------------------------------------------------------------------------

def test_barrier_timeout_names_missing_hosts(tmp_path):
    coll = FileCollective(str(tmp_path / "c"), ctx=ProcessContext(0, 3),
                          poll_s=0.01, timeout_s=0.5)
    with pytest.raises(BarrierTimeout) as ei:
        coll.barrier("b")
    e = ei.value
    assert isinstance(e, TimeoutError)
    assert e.missing == [1, 2] and e.expected == 3
    assert "host 1" in str(e) and "presumed dead" in str(e)
    assert "[1, 2]" in str(e)


def test_barrier_backoff_is_exponential_and_capped(tmp_path, monkeypatch):
    from repro_torch.distributed import collective as coll_mod
    sleeps = []
    monkeypatch.setattr(coll_mod.time, "sleep", lambda s: sleeps.append(s))
    coll = FileCollective(str(tmp_path / "c"), ctx=ProcessContext(0, 2),
                          poll_s=0.01, timeout_s=0.4, max_poll_s=0.25)
    with pytest.raises(BarrierTimeout):
        coll.barrier("b")
    assert len(sleeps) >= 3
    assert sleeps[1] > sleeps[0]
    assert max(sleeps) <= 0.25 * 1.25 + 1e-9
    base = sorted(sleeps)
    assert base[-1] > 4 * base[0]


def test_barrier_participants_quorum(tmp_path):
    d = str(tmp_path / "c")

    def host(p):
        FileCollective(d, ctx=ProcessContext(p, 3),
                       timeout_s=10.0).barrier("q", participants=[0, 2])

    ts = [threading.Thread(target=host, args=(p,)) for p in (0, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=15)
        assert not t.is_alive()
    FileCollective(d, ctx=ProcessContext(1, 3),
                   timeout_s=0.2).barrier("q", participants=[0, 2])


# --------------------------------------------------------------------------
# degraded saves
# --------------------------------------------------------------------------

_REF_DEGRADED = {}


def reference_degraded(tmp_path_factory, monkeypatch, victim):
    """The reference's degraded step dir with ``victim`` killed after its
    replicate, written once per test process."""
    if victim not in _REF_DEGRADED:
        import test_resilience
        monkeypatch.setattr(test_resilience, "BARRIER_S", BARRIER_S)
        root = str(tmp_path_factory.mktemp(f"ref_deg{victim}") / "lv")
        (_, errors), _ = r_resilient_save(root, 4, victim=victim,
                                          point="after_replicate")
        assert all(errors[p] is None for p in range(4) if p != victim)
        _REF_DEGRADED[victim] = root
    return _REF_DEGRADED[victim]


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("victim", [0, 2])
def test_kill_after_replicate_commits_degraded_from_partner(
        tmp_path, tmp_path_factory, monkeypatch, victim, engine):
    """A host dies after its L2 replica landed: the surviving quorum
    recovers its segments from the partner's replica and commits a
    complete (degraded) checkpoint, byte for byte the reference's
    degraded step dir under the same fault; ``victim=0`` also moves the
    fuse to the smallest survivor."""
    root = str(tmp_path / "lv")
    results, errors = resilient_save(root, 4, victim=victim,
                                     point="after_replicate", engine=engine)
    assert isinstance(errors[victim], HostKilled)
    survivors = [p for p in range(4) if p != victim]
    for p in survivors:
        assert errors[p] is None, (p, errors[p])
    _, stats = results[survivors[0]]
    lv = stats["levels"][root]
    assert lv["degraded"]["missing"] == [victim]
    assert lv["degraded"]["survivors"] == survivors
    assert lv["degraded"]["recovered_from"][str(victim)] == \
        partner_of(victim, 4)
    assert lv["l2_recovered_bytes"] > 0 and lv["replicate_s"] >= 0
    step_dir = os.path.join(root, "step_1")
    files = set(os.listdir(step_dir))
    assert any(f.startswith(f"l2r_h{victim}_") for f in files), files
    m = TC.read_manifest(root, 1)
    assert m["degraded"]["missing"] == [victim]
    assert m["resilience"]["levels"] == list(LEVEL_ORDER)
    with open(os.path.join(step_dir, "commit.json")) as f:
        assert json.load(f)["degraded"]["missing"] == [victim]
    assert_bit_identical_restore(root)

    assert_dirs_identical(step_dir, os.path.join(
        reference_degraded(tmp_path_factory, monkeypatch, victim), "step_1"))


def test_kill_at_commit_barrier_tolerated_once_marker_landed(tmp_path):
    root = str(tmp_path / "lv")
    results, errors = resilient_save(root, 4, victim=3,
                                     barrier_kill=("before", ".commit"))
    assert isinstance(errors[3], HostKilled)
    for p in range(3):
        assert errors[p] is None, (p, errors[p])
        assert results[p][1]["levels"][root]["commit_barrier_missing"] == [3]
    assert "degraded" not in TC.read_manifest(root, 1)
    assert_bit_identical_restore(root)


def test_kill_before_replicate_aborts_clean(tmp_path):
    root = str(tmp_path / "lv")
    _, errors = resilient_save(root, 4, victim=1, point="pack_done")
    assert isinstance(errors[1], HostKilled)
    for p in (0, 2, 3):
        assert isinstance(errors[p], TimeoutError), (p, errors[p])
        assert getattr(errors[p], "missing", None) == [1]
    assert not os.path.exists(os.path.join(root, "step_1"))
    assert TC.CheckpointManager([TC.Level(root)], device="cpu").latest() \
        is None


def test_degraded_save_preserves_previous_step(tmp_path):
    root = str(tmp_path / "lv")
    _, errors0 = resilient_save(root, 4)
    assert not any(errors0)

    def host(p, coll):
        inj = FaultInjector().kill_at("pack_done") if p == 2 else None
        mgr = _mgr(root, coll, inj)
        mgr.save(2, t_state(step_val=2))
        mgr.close()

    _, errors = run_hosts(4, host, timeout=30.0)
    assert isinstance(errors[2], HostKilled)
    assert all(isinstance(errors[p], TimeoutError) for p in (0, 1, 3))
    assert TC.CheckpointManager([TC.Level(root)], device="cpu") \
        .latest()[0] == 1
    assert_bit_identical_restore(root)


# --------------------------------------------------------------------------
# level-cascade restore with byte accounting
# --------------------------------------------------------------------------

def test_restore_after_host_death_reads_zero_store_bytes(tmp_path):
    root = str(tmp_path / "lv")
    _, errors = resilient_save(root, 4)
    assert not any(errors)
    shutil.rmtree(os.path.join(default_l2_root(root), "h2"))
    results = elastic_restore(root, 4)
    assert_owned_rows_match(results, 4)
    for p, (st, _, stats) in enumerate(results):
        assert st == 1
        assert stats["bytes_read_store"] == 0, (p, stats)
        assert stats["bytes_read_l2"] > 0
        assert stats["bytes_read"] == stats["bytes_read_l2"]
        assert stats["level_served"][L2_PARTNER] > 0
        assert stats["level_served"][L4_STORE] == 0


def test_restore_same_manager_serves_from_l1(tmp_path):
    root = str(tmp_path / "lv")

    def host(p, coll):
        mgr = _mgr(root, coll)
        mgr.save(1, t_state())
        mgr.wait()
        st, _ = mgr.restore(t_state(step_val=0), local_only=True)
        stats = dict(mgr.last_restore_stats)
        mgr.close()
        return st, stats

    results, errors = run_hosts(2, host)
    assert not any(errors), errors
    for st, stats in results:
        assert st == 1
        assert stats["level_served"][L1_RESIDENT] > 0
        assert stats["bytes_read_store"] == 0
        assert stats["bytes_read"] == stats["bytes_read_l2"]
        assert stats["bytes_l1"] > stats["bytes_read"]


def test_torn_store_shards_restore_via_l2(tmp_path):
    root = str(tmp_path / "lv")
    _, errors = resilient_save(root, 4)
    assert not any(errors)
    for f in shard_files(os.path.join(root, "step_1")):
        tear_file(f, frac=0.3)
    assert TC.CheckpointManager([TC.Level(root)], device="cpu").restore(
        t_state(step_val=0)) is None
    results = elastic_restore(root, 4)
    assert_owned_rows_match(results, 4)
    for _, _, stats in results:
        assert stats["bytes_read_store"] == 0


def test_corrupt_replica_crc_falls_back_to_store(tmp_path):
    root = str(tmp_path / "lv")
    _, errors = resilient_save(root, 2)
    assert not any(errors)
    l2 = default_l2_root(root)
    for holder in (0, 1):
        corrupt_crc(os.path.join(l2, f"h{holder}", "step_1", "src0",
                                 levels_mod.REPLICA_PAYLOAD))
    results = elastic_restore(root, 2)
    assert_owned_rows_match(results, 2)
    _, _, stats0 = results[0]
    assert stats0.get("l2_fallbacks", 0) >= 1
    assert stats0["bytes_read_store"] > 0


def test_partner_death_during_l2_fetch_falls_back_to_store(tmp_path):
    root = str(tmp_path / "lv")
    _, errors = resilient_save(root, 2)
    assert not any(errors)
    with partner_fetch_failure(times=10 ** 6, delete=True):
        results = elastic_restore(root, 2)
    assert_owned_rows_match(results, 2)
    for _, _, stats in results:
        assert stats["bytes_read_l2"] == 0
        assert stats["bytes_read_store"] > 0
        assert stats["level_served"][L4_STORE] > 0


def test_l2_store_gc_follows_retention(tmp_path):
    root = str(tmp_path / "lv")

    def host(p, coll):
        mgr = _mgr(root, coll, keep_n=2)
        for t in (1, 2, 3):
            mgr.save(t, t_state(step_val=t))
        mgr.close()

    _, errors = run_hosts(2, host)
    assert not any(errors), errors
    for h in (0, 1):
        assert sorted(os.listdir(os.path.join(default_l2_root(root),
                                              f"h{h}"))) == \
            ["step_2", "step_3"]


def test_stalled_writer_still_commits(tmp_path):
    """A writer slower than its peers (alive, within the barrier timeout)
    delays the land barrier but not the commit."""
    root = str(tmp_path / "lv")
    with stalled_writer(0.3, times=1):      # one host's one write
        results, errors = resilient_save(root, 2)
    assert not any(errors), errors
    assert max(r[1]["levels"][root]["land_barrier_s"] for r in results) \
        > 0.1
    assert_bit_identical_restore(root)


# --------------------------------------------------------------------------
# pipeline abort latency, writer-exception unicity
# --------------------------------------------------------------------------

def test_queue_source_abort_unblocks_within_one_poll():
    from repro_torch.checkpoint.pipeline import ABORT_POLL_S, QueueSource
    abort = threading.Event()
    src = QueueSource(nbytes=64, maxsize=1, abort=abort)
    src.put(b"x")
    t0 = []

    def blocked_put():
        try:
            src.put(b"y")
        except RuntimeError:
            t0.append(time.monotonic())

    th = threading.Thread(target=blocked_put)
    th.start()
    time.sleep(ABORT_POLL_S / 2)
    armed = time.monotonic()
    abort.set()
    th.join(timeout=5 * ABORT_POLL_S)
    assert not th.is_alive()
    assert t0 and t0[0] - armed <= 2 * ABORT_POLL_S


@pytest.mark.parametrize("coordinated", [False, True])
def test_writer_exception_raised_exactly_once(tmp_path, monkeypatch,
                                              coordinated):
    from repro_torch.checkpoint import pipeline as pipeline_mod

    class Boom(RuntimeError):
        pass

    real_chunks = pipeline_mod.ViewSource.chunks
    armed = [True]

    def dying_chunks(self):
        if armed[0]:
            armed[0] = False
            raise Boom("writer died")
        return real_chunks(self)

    monkeypatch.setattr(pipeline_mod.ViewSource, "chunks", dying_chunks)
    report = t_report(make_masks())
    if coordinated:
        mgr = TC.CoordinatedCheckpointManager(
            [TC.Level(str(tmp_path / "lv"))], scrutiny_fn=lambda s: report,
            force_coordinated=True, device="cpu")
    else:
        mgr = TC.CheckpointManager([TC.Level(str(tmp_path / "lv"))],
                                   scrutiny_fn=lambda s: report,
                                   io_chunk_bytes=256, device="cpu")
    mgr.save(1, t_state())
    with pytest.raises(Boom):
        mgr.wait()
    mgr.wait()
    mgr.close()


# --------------------------------------------------------------------------
# GC races and stale coordinated pending sweep
# --------------------------------------------------------------------------

def test_restore_racing_gc_falls_back_to_next_committed(tmp_path):
    root = str(tmp_path / "lv")
    mgr = TC.CheckpointManager([TC.Level(root, keep_n=4)], device="cpu")
    mgr.save(1, t_state(step_val=1), block=True)
    mgr.save(2, t_state(step_val=2), block=True)
    mgr.close()
    for f in shard_files(os.path.join(root, "step_2")):
        os.unlink(f)
    cmgr = TC.CoordinatedCheckpointManager(
        [TC.Level(root)], force_coordinated=True, device="cpu")
    st, got = cmgr.restore(t_state(), local_only=True)
    assert st == 1 and int(got["step"]) == 1
    assert cmgr.last_restore_stats["skipped"][0]["step"] == 2
    cmgr.close()


def test_stale_alive_coordinated_pending_swept(tmp_path):
    def plant(root, name=".pending_step_9", age=3600):
        pend = os.path.join(root, name)
        os.makedirs(pend)
        with open(os.path.join(pend, "shard_h0_0.bin"), "wb") as f:
            f.write(b"orphan")
        alive = os.path.join(pend, ALIVE_FILE)
        with open(alive, "w"):
            pass
        old = time.time() - age
        os.utime(alive, (old, old))
        return pend

    root = str(tmp_path / "b")
    cmgr = TC.CoordinatedCheckpointManager(
        [TC.Level(root, keep_n=2)], force_coordinated=True,
        pending_ttl_s=1.0, device="cpu")
    cmgr.save(1, t_state())
    cmgr.wait()
    pend = plant(root)
    cmgr.save(2, t_state(step_val=2))
    cmgr.close()
    assert not os.path.exists(pend)
    live = plant(root, ".pending_step_11", age=0)
    cmgr2 = TC.CoordinatedCheckpointManager(
        [TC.Level(root, keep_n=2)], force_coordinated=True,
        pending_ttl_s=600.0, device="cpu")
    cmgr2.save(3, t_state(step_val=3))
    cmgr2.close()
    assert os.path.exists(live)


def test_injector_from_env_and_faulty_collective(monkeypatch, tmp_path):
    monkeypatch.delenv(faults.FAULT_ENV, raising=False)
    assert injector_from_env() is None
    monkeypatch.setenv(faults.FAULT_ENV, "before_commit_barrier@q3:hard")
    inj = injector_from_env()
    (rule,) = inj.rules
    assert (rule.point, rule.match, rule.hard) == \
        ("before_commit_barrier", "q3", True)
    inj = FaultInjector().kill_at("after_commit", match="q2")
    inj.fire("after_commit", name="q1.L0")
    with pytest.raises(HostKilled, match="after_commit"):
        inj.fire("after_commit", name="q2.L0")
    inj.fire("after_commit", name="q2.L0")      # fired once only
    coll = FaultyCollective(FileCollective(str(tmp_path),
                                           ctx=ProcessContext(0, 1)))
    coll.kill_after("x")
    with pytest.raises(HostKilled):
        coll.barrier("x")
    assert coll.barriers_seen == ["x"]


# --------------------------------------------------------------------------
# real processes, a hard kill (os._exit) mid-save
# --------------------------------------------------------------------------

_PROG = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch._tensors import to_host
from repro_torch.checkpoint import CoordinatedCheckpointManager, Level
from repro_torch.convert import report_from_masks, state_from_numpy
from repro_torch.distributed.collective import get_collective
from repro_torch.testing.faults import injector_from_env

def state(step_val=7):
    # tests/test_coordinated.py's make_state and make_masks, in numpy
    rng = np.random.RandomState(0)
    return state_from_numpy({
        "w": rng.randn(96, 8).astype(np.float32),
        "b": rng.randn(40).astype(np.float32),
        "c": rng.randint(0, 1000, (10,)).astype(np.int32),
        "step": np.asarray(step_val, np.int32)}, "cpu")

rng = np.random.RandomState(1)
masks = {"w": rng.rand(96 * 8) < 0.4, "b": rng.rand(40) < 0.6}
role = os.environ["ROLE"]
root = os.environ["ROOT"]
idx = int(os.environ["REPRO_PROCESS_INDEX"])
report = report_from_masks(masks, state())
mgr = CoordinatedCheckpointManager(
    [Level(root, keep_n=4)], collective=get_collective(),
    scrutiny_fn=lambda s: report, save_mode="device", device="cpu",
    barrier_timeout_s=float(os.environ.get("BARRIER_TIMEOUT", "20")),
    fault_injector=injector_from_env())
if role == "save":
    mgr.save(1, state())
    mgr.wait()
    deg = mgr.last_save_stats["levels"][root].get("degraded")
    print("SAVED", "DEGRADED" if deg else "CLEAN",
          sorted(deg["missing"]) if deg else [])
elif role == "restore":
    st, got = mgr.restore(state(step_val=0), local_only=True)
    s = mgr.last_restore_stats
    np.save(os.path.join(root, f"restored_{idx}.npy"), to_host(got["w"]))
    print("RESTORED", st, int(s["bytes_read_store"]),
          int(s["bytes_read_l2"]))
mgr.close()
"""


def _spawn(n, role, root, coord, fault_for=None, fault=""):
    base = dict(os.environ, ROOT=root, ROLE=role, REPRO_COORD_DIR=coord,
                REPRO_PROCESS_COUNT=str(n), BARRIER_TIMEOUT="8",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                TEST_DIR=os.path.dirname(__file__))
    base["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + base.get("PYTHONPATH", "").split(os.pathsep))
    base.pop(faults.FAULT_ENV, None)
    procs = []
    for p in range(n):
        env = dict(base, REPRO_PROCESS_INDEX=str(p))
        if p == fault_for:
            env[faults.FAULT_ENV] = fault
        procs.append(subprocess.Popen([sys.executable, "-c", _PROG],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    for pr in procs:
        out, err = pr.communicate(timeout=300)
        outs.append((pr.returncode, out, err))
    return outs


@pytest.mark.multiprocess
def test_hard_kill_after_replicate_commits_and_restores_from_partner(
        tmp_path):
    """Four real processes; one is killed with ``os._exit`` right after its
    L2 replica lands.  The survivors commit the degraded step from the
    partner's replica; a fresh 4-process restore then serves every segment
    from L2 with zero shared-store reads."""
    root = str(tmp_path / "lv")
    os.makedirs(root)
    victim = 2
    outs = _spawn(4, "save", root, str(tmp_path / "coord"),
                  fault_for=victim, fault="after_replicate:hard")
    assert outs[victim][0] == 17, outs[victim]
    for p in range(4):
        if p != victim:
            rc, out, err = outs[p]
            assert rc == 0 and f"SAVED DEGRADED [{victim}]" in out, \
                (p, rc, out, err)
    files = set(os.listdir(os.path.join(root, "step_1")))
    assert "commit.json" in files
    assert any(f.startswith(f"l2r_h{victim}_") for f in files), files
    assert TC.read_manifest(root, 1)["degraded"]["missing"] == [victim]
    assert_bit_identical_restore(root)

    shutil.rmtree(os.path.join(default_l2_root(root), f"h{victim}"))
    outs = _spawn(4, "restore", root, str(tmp_path / "coord2"))
    for p, (rc, out, err) in enumerate(outs):
        assert rc == 0, (p, rc, out, err)
        tok = out.split()
        assert tok[0] == "RESTORED" and tok[1] == "1", (p, out)
        assert int(tok[2]) == 0, f"host {p} read {tok[2]} store bytes"
        assert int(tok[3]) > 0
    exp = expected()
    w = np.zeros_like(exp["w"])
    for lo, hi, owner in process_segments(exp["w"].shape, 4):
        w[lo:hi] = np.load(os.path.join(root, f"restored_{owner}.npy"))[lo:hi]
    np.testing.assert_array_equal(w, exp["w"])
