"""The port's coordinated checkpointing against the reference's, on the CPU.

Simulated hosts are threads, each with its own ``CoordinatedCheckpointManager``
and a ``FileCollective`` over one shared directory, as in
``tests/test_coordinated.py`` (whose state, masks and report this file
reuses, so both packages see the same numpy arrays).  The port writes its
step directories byte for byte as the reference does, over {1, 2, 4} hosts
× {full, device, delta} and both of its pipeline engines; each package
restores the other's coordinated checkpoints elastically; the failure
semantics (dead host, dead leader, gaps, shape mismatch, corruption,
carcasses) and the snapshot isolation of ``save(block=False)`` hold; the
ownership tables and the partition rules equal the reference's; and
``TorchCollective`` runs over a two-process gloo group.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from test_coordinated import (N_COLS, N_ROWS, _pipelined_coordinated_save,
                              expected_leaves, make_masks, make_state)

import repro.checkpoint as RC
from repro.distributed import collective as r_coll
from repro.distributed import sharding as r_sh
from repro.kernels.mask_pack import ops as r_ops
import repro_torch.checkpoint as TC
from repro_torch._tensors import to_host
from repro_torch.checkpoint import coordinator as t_coord_mod
from repro_torch.checkpoint.store import ALIVE_FILE, fuse_global_manifest
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core.criticality import CriticalityReport, LeafReport
from repro_torch.core.policy import LeafPolicy
from repro_torch.core.regions import RegionTable
from repro_torch.distributed import collective as t_coll
from repro_torch.distributed import sharding as t_sh
from repro_torch.kernels.mask_pack import ops as t_ops
from repro_torch.models import init_cache, init_params

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

TIMEOUT_S = 60.0
ENGINES = ["host", "device"]


# --------------------------------------------------------------------------
# the port's side of the shared harness
# --------------------------------------------------------------------------

def t_state(step_val=7, seed=0):
    return state_from_numpy({k: np.asarray(v) for k, v
                             in make_state(step_val, seed).items()}, "cpu")


def t_report(masks):
    leaves = {}
    for name, shape in (("w", (N_ROWS, N_COLS)), ("b", (40,))):
        mask = masks[name]
        leaves[name] = LeafReport(
            name=name, shape=shape, dtype="float32", policy=LeafPolicy.AD,
            mask=mask, table=RegionTable.from_mask(mask, 4), magnitude=None)
    return CriticalityReport(leaves=leaves)


def t_arrays(state):
    return {k: to_host(v) for k, v in state.items()}


def run_hosts(count, fn, timeout=TIMEOUT_S):
    """``fn(process_index, collective)`` once per simulated host, in threads
    over one shared port ``FileCollective`` dir; (results, errors)."""
    import tempfile
    results, errors = [None] * count, [None] * count
    coord_dir = tempfile.mkdtemp(prefix="tcoord_")

    def run(p):
        try:
            coll = t_coll.FileCollective(
                coord_dir, ctx=t_coll.ProcessContext(p, count),
                timeout_s=timeout)
            results[p] = fn(p, coll)
        except BaseException as e:      # noqa: BLE001 - surfaced by caller
            errors[p] = e

    threads = [threading.Thread(target=run, args=(p,)) for p in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


def t_manager(root, coll=None, report=None, mode="device", engine="host",
              keep_n=4, shards=1, force=False, **kw):
    return TC.CoordinatedCheckpointManager(
        [TC.Level(root, keep_n=keep_n, shards=shards,
                  max_chain=8 if mode == "delta" else 0)],
        collective=coll,
        scrutiny_fn=None if report is None else (lambda s: report),
        save_mode="device" if mode != "full" else "auto",
        delta_chunk_bytes=64, force_coordinated=force,
        pipeline_engine=engine, device="cpu", **kw)


def t_coordinated_save(root, count, mode, steps=1, engine="host", keep_n=4,
                       force=True):
    """The port's twin of the reference's pipelined coordinated save: the
    same mutation every host applies alike, here in place right after
    ``save(block=False)`` returned."""
    masks = make_masks()

    def host(p, coll):
        report = t_report(masks) if mode != "full" else None
        mgr = t_manager(root, coll, report, mode, engine, keep_n=keep_n,
                        force=force)
        state = t_state()
        for t in range(1, steps + 1):
            if t > 1:
                state["w"][t % N_ROWS, :] += 1.0
                state["step"].fill_(t)
            mgr.save(t, state)
        mgr.close()
        return t_arrays(state)

    results, errors = run_hosts(count, host)
    assert not any(errors), [e for e in errors if e]
    return results[0], masks


def final_expected(mode, steps):
    state = {k: np.asarray(v) for k, v in make_state().items()}
    for t in range(2, steps + 1):
        state["w"] = state["w"].copy()
        state["w"][t % N_ROWS, :] += 1.0
        state["step"] = np.asarray(t, np.int32)
    return expected_leaves(state, make_masks(), scrutinized=mode != "full")


def assert_dirs_identical(da, db):
    fa, fb = sorted(os.listdir(da)), sorted(os.listdir(db))
    assert fa == fb, (fa, fb)
    for f in fa:
        with open(os.path.join(da, f), "rb") as fh:
            got = fh.read()
        with open(os.path.join(db, f), "rb") as fh:
            want = fh.read()
        assert got == want, f"{da}: {f} differs from the reference's"


_REF_DIRS = {}


def reference_dirs(tmp_path_factory, count, mode):
    """The reference's coordinated step dirs for (count, mode), written
    once per test process."""
    key = (count, mode)
    if key not in _REF_DIRS:
        root = str(tmp_path_factory.mktemp(f"ref_{count}_{mode}") / "lv")
        _pipelined_coordinated_save(root, count, mode,
                                    steps=3 if mode == "delta" else 1)
        _REF_DIRS[key] = root
    return _REF_DIRS[key]


# --------------------------------------------------------------------------
# collective primitives and ownership
# --------------------------------------------------------------------------

def test_file_collective_barrier_and_timeout(tmp_path):
    def host(p, coll):
        coll.barrier("x", timeout=10)
        return p

    results, errors = run_hosts(3, host)
    assert results == [0, 1, 2] and not any(errors)
    coll = t_coll.FileCollective(str(tmp_path / "coord"),
                                 ctx=t_coll.ProcessContext(0, 2),
                                 timeout_s=0.3)
    with pytest.raises(t_coll.BarrierTimeout, match=r"\[1\]") as ei:
        coll.barrier("alone")
    assert ei.value.missing == [1]


def test_file_collective_leader_cleanup_and_quorum(tmp_path):
    d = str(tmp_path / "coord")
    os.makedirs(d)
    stale = os.path.join(d, "b_q1.L0.land.p1")
    with open(stale, "w") as f:
        f.write("1")
    t_coll.FileCollective(d, ctx=t_coll.ProcessContext(0, 2), timeout_s=0.2)
    assert not os.path.exists(stale)
    # a quorum without host 2 passes; a host outside it returns at once
    coll = t_coll.FileCollective(d, ctx=t_coll.ProcessContext(2, 3),
                                 timeout_s=0.2)
    coll.barrier("q", participants=[0, 1])

    def host(p, c):
        c.barrier("q1.land", participants=[0, 1], timeout=10)
        c.barrier("q2.land", participants=[0, 1], timeout=10)
        c.cleanup(2)        # every participant passed q1
        return sorted(f for f in os.listdir(c.directory)
                      if f.endswith(f".p{p}"))

    results, errors = run_hosts(2, host)
    assert not any(errors), errors
    assert results == [["b_q2.land.p0"], ["b_q2.land.p1"]]


def test_get_collective_rules(monkeypatch):
    monkeypatch.delenv("REPRO_PROCESS_COUNT", raising=False)
    assert isinstance(t_coll.get_collective(), t_coll.NullCollective)
    assert t_coll.current_context() == t_coll.ProcessContext(0, 1)
    monkeypatch.setenv("REPRO_PROCESS_COUNT", "2")
    monkeypatch.setenv("REPRO_PROCESS_INDEX", "1")
    monkeypatch.delenv("REPRO_COORD_DIR", raising=False)
    assert t_coll.current_context() == t_coll.ProcessContext(1, 2)
    with pytest.raises(ValueError, match="coord_dir"):
        t_coll.get_collective()
    with pytest.raises(ValueError, match="unknown collective"):
        t_coll.get_collective("jax")


SHAPES = [(10, 4), (2, 8), (), (0, 3), (97, 3), (40,), (1,), (5, 2, 3)]


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("pinned", [None, 0, 3])
def test_ownership_tables_match_reference(count, pinned):
    for shape in SHAPES:
        r_pin = None if pinned is None else r_coll.HostPinned(pinned)
        t_pin = None if pinned is None else t_coll.HostPinned(pinned)
        assert t_coll.process_segments(shape, count, t_pin) == \
            r_coll.process_segments(shape, count, r_pin), shape
        for p in range(count):
            assert t_coll.owned_ranges(shape, t_coll.ProcessContext(p, count),
                                       t_pin) == \
                r_coll.owned_ranges(shape, r_coll.ProcessContext(p, count),
                                    r_pin), (shape, p)


def test_leading_axis_layout_ownership_and_targets():
    """A layout whose pieces several processes hold owns rows by piece
    (lowest process of a replicated piece), as the reference's
    ``NamedSharding`` over a multi-process mesh does; its addressable
    pieces are the restore targets."""
    sh = t_sh.LeadingAxisSharding(
        (t_sh.ShardPiece(0, 6, "cpu", 1), t_sh.ShardPiece(0, 6, "cpu", 0),
         t_sh.ShardPiece(6, 10, "cpu", 2)), process=2)
    assert t_coll.process_segments((10, 3), 3, sh) == [(0, 6, 0), (6, 10, 2)]
    assert t_coll.owned_ranges((10, 3), t_coll.ProcessContext(2, 3), sh) == \
        [(18, 30)]
    assert t_sh.leading_axis_device_segments(sh, (10, 3)) == \
        [(6, 10, torch.device("cpu"))]
    one = t_sh.LeadingAxisSharding.even(10, ["cpu", "cpu"], [0, 0])
    # one process: the uniform split decides
    assert t_coll.process_segments((10,), 2, one) == [(0, 5, 0), (5, 10, 1)]
    with pytest.raises(ValueError):
        one.devices_indices_map((11,))
    words = t_sh.scrutiny_words_shardings(
        {"a": torch.zeros(16, 4), "b": torch.zeros(6, 1), "c": torch.zeros(3)},
        {"a": t_sh.LeadingAxisSharding.even(16, ["cpu"] * 2),
         "b": t_sh.LeadingAxisSharding.even(6, ["cpu"] * 2), "c": None})
    assert [(p.start, p.stop) for p in words["a"].pieces] == [(0, 4), (4, 8)]
    assert words["b"] is None and words["c"] is None


MESHES = [{"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2}]


def _duck_mesh(shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _spec_tree(tree):
    return jax.tree_util.tree_map(
        lambda s: tuple(s), tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _flat_specs(tree):
    return [tuple(s) for s in t_sh._spec_leaves(tree)]


@pytest.mark.parametrize("mesh", MESHES, ids=["dp2tp4", "pod2dp2tp2"])
@pytest.mark.parametrize("name", ["xlstm-125m", "recurrentgemma-2b",
                                  "olmoe-1b-7b", "deepseek-v3-671b",
                                  "qwen2-vl-7b", "qwen1.5-32b", "gemma2-27b",
                                  "gemma-7b", "phi4-mini-3.8b",
                                  "whisper-tiny"])
def test_partition_specs_match_reference(monkeypatch, name, mesh):
    """params, batch and cache specs for every config at full size, fitted
    to the mesh, against the reference's ``PartitionSpec``s (its
    ``NamedSharding`` is stood in by the spec itself)."""
    from repro.configs import get_config as r_get_config
    from repro.models import init_cache as r_init_cache
    from repro.models import init_params as r_init_params

    monkeypatch.setattr(r_sh, "NamedSharding", lambda m, spec: spec)
    rmesh = _duck_mesh(mesh)
    cfg, rcfg = get_config(name), r_get_config(name)
    t_params = init_params(cfg, None, device="meta")
    r_params = jax.eval_shape(lambda k: r_init_params(rcfg, k),
                              jax.random.PRNGKey(0))
    want = jax.tree_util.tree_leaves(
        _spec_tree(r_sh.params_shardings(rcfg, rmesh, r_params)),
        is_leaf=lambda x: isinstance(x, tuple))
    assert _flat_specs(t_sh.params_shardings(cfg, mesh, t_params)) == want
    t_cache = init_cache(cfg, 4, 32, device="meta")
    r_cache = jax.eval_shape(lambda: r_init_cache(rcfg, 4, 32))
    want = jax.tree_util.tree_leaves(
        _spec_tree(r_sh.cache_shardings(rcfg, rmesh, r_cache)),
        is_leaf=lambda x: isinstance(x, tuple))
    assert _flat_specs(t_sh.cache_shardings(cfg, mesh, t_cache)) == want
    batch = {"tokens": torch.empty(8, 64, device="meta"),
             "positions": torch.empty(8, 64, 3, device="meta"),
             "lens": torch.empty(8, device="meta"),
             "seed": torch.empty((), device="meta")}
    r_batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
               for k, v in batch.items()}
    for seq in (False, True):
        want = jax.tree_util.tree_leaves(
            _spec_tree(r_sh.batch_shardings(rcfg, rmesh, r_batch,
                                            seq_shard=seq)),
            is_leaf=lambda x: isinstance(x, tuple))
        assert _flat_specs(t_sh.batch_shardings(cfg, mesh, batch,
                                                seq_shard=seq)) == want
    text = t_sh.describe_shardings(
        cfg, mesh, t_params, t_sh.params_shardings(cfg, mesh, t_params),
        limit=3)
    assert len(text.splitlines()) == 3 and "embed" in text


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32"])
@pytest.mark.parametrize("lo,hi", [(0, 1029), (3, 517), (13, 1029),
                                   (512, 1024)])
def test_segment_pack_matches_reference_pack_critical(dtype, lo, hi):
    """A host's owned segment ``[lo, hi)`` of a leaf packs (K2's plain
    version, ``pack_group`` from ``segment_words`` of the leaf's words)
    to the bytes the reference's ``pack_critical`` gives the segment's own
    bool mask — also where ``lo`` is not on a byte."""
    import jax.numpy as jnp
    n = 1029
    rng = np.random.RandomState(lo + hi)
    vals = np.asarray(jnp.asarray(rng.randn(n) * 100, getattr(jnp, dtype))
                      if dtype != "int32" else rng.randint(-9, 9, n)
                      .astype(np.int32))
    mask = rng.rand(n) < 0.4
    leaf = state_from_numpy({"x": vals}, "cpu")["x"]
    words = torch.from_numpy(np.packbits(mask))
    seg_words = t_ops.segment_words(words, lo, hi)
    total = int(mask[lo:hi].sum())
    pay, counts = t_ops.pack_group([leaf[lo:hi]], [seg_words], [total])
    r_pay, r_counts, _ = r_ops.pack_critical(jnp.asarray(vals)[lo:hi],
                                             mask[lo:hi], use_kernel=False)
    assert to_host(pay).tobytes() == np.asarray(r_pay).tobytes()
    assert to_host(counts).tobytes() == np.asarray(r_counts).tobytes()


# --------------------------------------------------------------------------
# byte identity and cross-restore
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", ["full", "device", "delta"])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_step_dirs_byte_identical_to_reference(tmp_path, tmp_path_factory,
                                               count, mode, engine):
    """Every committed step dir — shards, per-host manifests, the global
    manifest, the commit marker — is the reference's byte for byte."""
    steps = 3 if mode == "delta" else 1
    ref = reference_dirs(tmp_path_factory, count, mode)
    root = str(tmp_path / "port")
    final, _ = t_coordinated_save(root, count, mode, steps=steps,
                                  engine=engine)
    for t in range(1, steps + 1):
        assert_dirs_identical(os.path.join(root, f"step_{t}"),
                              os.path.join(ref, f"step_{t}"))
    exp = final_expected(mode, steps)
    assert final["step"] == exp["step"]


def _restore_hosts(mgr_factory, count, local_only=True):
    def rhost(p, coll):
        mgr = mgr_factory(coll)
        st, got = mgr.restore(t_state(step_val=0), local_only=local_only)
        stats = dict(mgr.last_restore_stats)
        mgr.close()
        return st, t_arrays(got), stats

    results, errors = run_hosts(count, rhost)
    assert not any(errors), [e for e in errors if e]
    return results


def _stitch(results, exp, count):
    for k, v in exp.items():
        shape = v.shape
        row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        got = np.zeros_like(v).reshape(-1)
        for lo, hi, owner in t_coll.process_segments(shape or (1,), count):
            got[lo * row:hi * row] = \
                results[owner][1][k].reshape(-1)[lo * row:hi * row]
        if not shape:
            got = results[0][1][k].reshape(())
        np.testing.assert_array_equal(got.reshape(shape), v,
                                      err_msg=f"leaf {k}")


@pytest.mark.parametrize("mode", ["device", "delta"])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_port_restores_reference_checkpoints(tmp_path_factory, count, mode):
    """The port restores the reference's coordinated steps onto 1 host
    (whole leaves, device expand) and onto 2 (owned rows, range reads)."""
    steps = 3 if mode == "delta" else 1
    ref = reference_dirs(tmp_path_factory, count, mode)
    exp = final_expected(mode, steps)
    mgr = TC.CoordinatedCheckpointManager([TC.Level(ref)], device="cpu")
    st, got = mgr.restore(t_state(step_val=0))
    assert st == steps
    for k, v in exp.items():
        np.testing.assert_array_equal(to_host(got[k]), v, err_msg=k)
    mgr.close()
    results = _restore_hosts(
        lambda coll: TC.CoordinatedCheckpointManager(
            [TC.Level(ref)], collective=coll, device="cpu"), 2)
    assert all(r[0] == steps for r in results)
    _stitch(results, exp, 2)
    if mode != "delta":
        total = TC.read_manifest(ref, steps)["payload_bytes"]
        for _, _, stats in results:
            assert 0 < stats["bytes_read"] < total


@pytest.mark.parametrize("fill", [0.0, -3.5])
@pytest.mark.parametrize("count", [1, 2])
def test_chain_restore_expands_masked_leaves_through_the_scatter(
        tmp_path, monkeypatch, count, fill):
    """A delta chain's step restored in device mode expands each masked
    leaf's target range through ``mask_scatter`` from its payload slice
    and mask words (no host expand, no dense H2D), giving what the host
    mode gives, bit for bit."""
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 4, "delta", steps=3)
    calls = []
    real = t_ops.mask_scatter

    def counted(*a, **kw):
        calls.append(kw.get("n"))
        return real(*a, **kw)

    monkeypatch.setattr(t_ops, "mask_scatter", counted)

    def restore_all(mode):
        calls.clear()

        def host(p, coll):
            mgr = TC.CoordinatedCheckpointManager(
                [TC.Level(root)], collective=coll, device="cpu")
            st, got = mgr.restore(t_state(step_val=0), fill=fill,
                                  mode=mode, local_only=True)
            stats = dict(mgr.last_restore_stats)
            mgr.close()
            return st, t_arrays(got), stats

        results, errors = run_hosts(count, host)
        assert not any(errors), [e for e in errors if e]
        return results, list(calls)

    dev, dev_calls = restore_all("device")
    host, host_calls = restore_all("host")
    assert host_calls == []
    # one scatter a masked leaf (w, b) a host, each over its own rows
    assert len(dev_calls) == 2 * count, dev_calls
    for (st_d, got_d, stats_d), (st_h, got_h, stats_h) in zip(dev, host):
        assert st_d == st_h == 3 and stats_d["chain"]
        for k in got_h:
            np.testing.assert_array_equal(got_d[k], got_h[k], err_msg=k)
        assert stats_d["h2d_bytes"] < stats_h["h2d_bytes"]
    exp = final_expected("delta", 3)
    if fill == 0.0:
        _stitch(dev, exp, count)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", ["device", "delta"])
@pytest.mark.parametrize("count", [2, 4])
def test_reference_restores_port_checkpoints(tmp_path, count, mode, engine):
    """The reference restores the port's coordinated steps onto 1 host (its
    plain manager) and onto 2 (its coordinator, ``local_only``)."""
    from test_coordinated import run_hosts as r_run_hosts
    steps = 3 if mode == "delta" else 1
    root = str(tmp_path / "port")
    t_coordinated_save(root, count, mode, steps=steps, engine=engine)
    exp = final_expected(mode, steps)
    st, got = RC.CheckpointManager([RC.Level(root)]).restore(
        make_state(step_val=0))
    assert st == steps
    for k, v in exp.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)

    def rhost(p, coll):
        rmgr = RC.CoordinatedCheckpointManager(
            [RC.Level(root)], collective=coll, pack_use_kernel=False,
            pack_interpret=True)
        st, got = rmgr.restore(make_state(step_val=0), local_only=True)
        rmgr.close()
        return st, {k: np.asarray(v) for k, v in got.items()}, None

    results, errors = r_run_hosts(2, rhost)
    assert not any(errors), [e for e in errors if e]
    _stitch(results, exp, 2)


def test_restore_onto_leading_axis_layout(tmp_path):
    """A 4-host save restores onto a layout of two pieces of one process:
    each piece is read and expanded by itself, the rest is the fill."""
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 4, "device")
    exp = final_expected("device", 1)
    sh = {"w": t_sh.LeadingAxisSharding((t_sh.ShardPiece(0, 30, "cpu", 0),
                                         t_sh.ShardPiece(30, 50, "cpu", 0),
                                         t_sh.ShardPiece(50, 96, "cpu", 1))),
          "b": t_sh.LeadingAxisSharding.even(40, ["cpu"]),
          "c": None, "step": None}
    mgr = TC.CoordinatedCheckpointManager([TC.Level(root)], device="cpu")
    st, got = mgr.restore(t_state(step_val=0), shardings=sh, fill=-1)
    assert st == 1
    masks = make_masks()
    vals = {k: np.asarray(v) for k, v in make_state().items()}
    w = to_host(got["w"])
    want_w = np.where(masks["w"].reshape(N_ROWS, N_COLS), vals["w"], -1)
    np.testing.assert_array_equal(w[:50], want_w[:50])
    assert (w[50:] == -1).all()
    np.testing.assert_array_equal(to_host(got["b"]),
                                  np.where(masks["b"], vals["b"], -1))
    for k in ("c", "step"):
        np.testing.assert_array_equal(to_host(got[k]), exp[k])
    mgr.close()


def test_four_host_layout_and_segmented_manifest(tmp_path):
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 4, "device", force=False)
    gm = TC.GlobalManifest.load(root, 1)
    leaves = gm.leaves()
    assert gm.coordinated and gm.process_count == 4
    seg = TC.GlobalManifest.segments_of(leaves["step"])
    assert len(seg) == 1 and seg[0]["file"].startswith("shard_h0_")
    w_segs = TC.GlobalManifest.segments_of(leaves["w"])
    assert {s["file"].split("_")[1] for s in w_segs} == \
        {"h0", "h1", "h2", "h3"}
    b_segs = TC.GlobalManifest.segments_of(leaves["b"])
    assert [s["start"] for s in b_segs] == [0, 10, 20, 30]   # 10 % 8 != 0
    assert all(s["encoding"] == "full"
               for s in TC.GlobalManifest.segments_of(leaves["c"]))
    # each leaf covered exactly once, in order
    for e in leaves.values():
        segs = TC.GlobalManifest.segments_of(e)
        assert segs[0]["start"] == 0
        assert all(a["stop"] == b["start"] for a, b in zip(segs, segs[1:]))


# --------------------------------------------------------------------------
# snapshot isolation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("count", [1, 2])
def test_in_place_mutation_after_async_save_never_reaches_it(tmp_path,
                                                             count, engine):
    """The optimizer updates leaves in place: every byte the save wrote is
    the value at ``save()``, though the state changes right after it
    returned and before the writer thread ran."""
    root = str(tmp_path / "lv")
    masks = make_masks()
    gate = threading.Event()
    mutated = []
    real = t_coord_mod._CoordSnapshot.materialize

    def gated(self, heartbeat=None):
        gate.wait(10)
        return real(self, heartbeat)

    t_coord_mod._CoordSnapshot.materialize = gated
    try:
        def host(p, coll):
            mgr = t_manager(root, coll, t_report(masks), "device", engine,
                            force=True)
            state = t_state()
            mgr.save(1, state, block=False)
            for v in state.values():
                v.add_(3) if v.dtype != torch.int32 else v.fill_(-5)
            mutated.append(p)
            if len(mutated) == count:       # every host changed its state
                gate.set()
            mgr.close()

        _, errors = run_hosts(count, host)
    finally:
        t_coord_mod._CoordSnapshot.materialize = real
    assert not any(errors), errors
    mgr = TC.CoordinatedCheckpointManager([TC.Level(root)], device="cpu")
    st, got = mgr.restore(t_state(step_val=0))
    exp = expected_leaves({k: np.asarray(v) for k, v in make_state().items()},
                          masks, scrutinized=True)
    for k, v in exp.items():
        np.testing.assert_array_equal(to_host(got[k]), v, err_msg=k)
    mgr.close()


# --------------------------------------------------------------------------
# failure semantics
# --------------------------------------------------------------------------

def test_dead_host_before_commit_leaves_previous_latest(tmp_path):
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 2, "device")

    def host(p, coll):
        mgr = t_manager(root, coll, barrier_timeout_s=1.0)
        if p == 1:
            return "died"
        mgr.save(2, t_state(step_val=2))
        mgr.close()

    results, errors = run_hosts(2, host, timeout=1.0)
    assert results[1] == "died"
    assert isinstance(errors[0], t_coll.BarrierTimeout)
    assert errors[0].missing == [1]
    mgr = TC.CheckpointManager([TC.Level(root)], device="cpu")
    assert mgr.latest()[0] == 1
    assert mgr.restore(t_state(step_val=0))[0] == 1
    mgr.close()
    assert os.path.exists(os.path.join(root, ".pending_step_2"))


def test_leader_crash_mid_commit_falls_back(tmp_path, monkeypatch):
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 2, "device")
    real_marker = t_coord_mod.write_commit_marker

    def dying_marker(step_dir, info):
        raise RuntimeError("leader lost mid-commit")

    monkeypatch.setattr(t_coord_mod, "write_commit_marker", dying_marker)

    def host(p, coll):
        mgr = t_manager(root, coll, barrier_timeout_s=2.0)
        mgr.save(2, t_state(step_val=2))
        mgr.close()

    _, errors = run_hosts(2, host, timeout=2.0)
    assert isinstance(errors[0], RuntimeError)
    assert isinstance(errors[1], TimeoutError)
    assert os.path.isdir(os.path.join(root, "step_2"))
    assert not TC.is_step_committed(root, 2)
    mgr = TC.CheckpointManager([TC.Level(root)], device="cpu")
    assert mgr.latest()[0] == 1
    mgr.close()
    monkeypatch.setattr(t_coord_mod, "write_commit_marker", real_marker)
    t_coordinated_save(root, 2, "device", steps=3)
    assert not os.path.exists(os.path.join(root, "step_2")) or \
        TC.is_step_committed(root, 2)
    assert TC.CoordinatedCheckpointManager(
        [TC.Level(root)], device="cpu").latest()[0] == 3


def test_fuse_rejects_gaps(tmp_path):
    pending = str(tmp_path / ".pending_step_1")
    os.makedirs(pending)
    man = {"host": 0, "shards": 1, "leaves": [
        {"name": "w", "shape": [20], "dtype": "float32", "encoding": "full",
         "aux": "", "num_regions": 1, "checksum": 0, "tier_dtypes": [],
         "region_tiers": "", "start": 0, "stop": 10, "shard": 0,
         "offset": 0, "length": 40, "file": "shard_h0_0.bin"}]}
    with open(os.path.join(pending, "manifest.host0.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(FileNotFoundError):
        fuse_global_manifest(pending, 1, 2)
    man2 = dict(man, host=1)
    man2["leaves"] = [dict(man["leaves"][0], start=12, stop=20, length=32,
                           file="shard_h1_0.bin")]
    with open(os.path.join(pending, "manifest.host1.json"), "w") as f:
        json.dump(man2, f)
    with pytest.raises(ValueError, match="gap"):
        fuse_global_manifest(pending, 1, 2)
    man2["leaves"][0].update(start=10, stop=19, length=36)
    with open(os.path.join(pending, "manifest.host1.json"), "w") as f:
        json.dump(man2, f)
    with pytest.raises(ValueError, match=r"cover \[0, 19\)"):
        fuse_global_manifest(pending, 1, 2)


def test_restore_shape_mismatch_raises_not_silently_none(tmp_path):
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 2, "device")
    mgr = TC.CoordinatedCheckpointManager([TC.Level(root)], device="cpu")
    bad = dict(t_state(), w=torch.zeros(N_ROWS + 1, N_COLS))
    with pytest.raises(TC.StateShapeError, match="checkpoint shape"):
        mgr.restore(bad)
    with pytest.raises(TC.StateShapeError, match="shardings"):
        mgr.restore(t_state(), shardings={"w": None})
    mgr.close()


def test_restore_detects_corrupted_segment(tmp_path):
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 2, "device")
    shard = os.path.join(root, "step_1", "shard_h1_0.bin")
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(raw))
    mgr = TC.CoordinatedCheckpointManager([TC.Level(root)], device="cpu")
    assert mgr.restore(t_state(step_val=0)) is None
    assert "checksum mismatch" in \
        mgr.last_restore_stats["skipped"][0]["error"]
    mgr.close()


def test_gc_never_counts_carcass_toward_keep_n(tmp_path):
    root = str(tmp_path / "lv")
    t_coordinated_save(root, 2, "device")
    d = os.path.join(root, "step_5")
    os.makedirs(d)
    man = dict(TC.read_manifest(root, 1), step=5)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f)
    mgr = TC.CheckpointManager([TC.Level(root, keep_n=1)], device="cpu")
    mgr.save(7, t_state(step_val=7), block=True)
    steps = sorted(s for s in map(TC.step_of_entry, os.listdir(root))
                   if s is not None)
    assert 7 in steps and 5 not in steps
    assert mgr.restore(t_state(step_val=0))[0] == 7
    mgr.close()


def test_retry_after_crash_drops_foreign_pending_files(tmp_path):
    root = str(tmp_path / "lv")
    pending = os.path.join(root, ".pending_step_1")
    os.makedirs(pending)
    for junk in ("shard_h7_0.bin", "manifest.host7.json", "trash.txt"):
        with open(os.path.join(pending, junk), "w") as f:
            f.write("stale")
    t_coordinated_save(root, 2, "device")
    files = set(os.listdir(os.path.join(root, "step_1")))
    assert not files & {"shard_h7_0.bin", "manifest.host7.json",
                        "trash.txt"}
    assert ALIVE_FILE not in files
    assert TC.load_checkpoint(root)[0] == 1


def test_force_coordinated_single_process_and_delegate(tmp_path):
    """One process: ``force_coordinated`` writes the coordinated format;
    without it saves go to the pipelined manager, restores through the
    range reads either way."""
    masks = make_masks()
    report = t_report(masks)
    exp = expected_leaves({k: np.asarray(v) for k, v in make_state().items()},
                          masks, scrutinized=True)
    for force in (True, False):
        root = str(tmp_path / f"lv{force}")
        mgr = t_manager(root, None, report, force=force)
        assert (mgr._inner is None) == force
        mgr.save(1, t_state())
        mgr.wait()
        assert ("coordinated" in TC.read_manifest(root, 1)) == force
        assert os.path.exists(os.path.join(root, "step_1",
                                           "commit.json")) == force
        st, got = mgr.restore(t_state(step_val=0))
        assert st == 1 and mgr.latest()[0] == 1
        for k, v in exp.items():
            np.testing.assert_array_equal(to_host(got[k]), v)
        mgr.close()
    with pytest.raises(TypeError, match="unsupported keyword"):
        t_manager(str(tmp_path / "x"), None, force=True, io_threads=3)


# --------------------------------------------------------------------------
# TorchCollective over a real gloo group (two processes)
# --------------------------------------------------------------------------

_GLOO_PROG = r"""
import os, sys, time
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, os.environ["TEST_DIR"])
rank, world = int(os.environ["RANK"]), 2
LATE_S = float(os.environ["LATE_S"])
dist.init_process_group("gloo", init_method=os.environ["INIT"],
                        rank=rank, world_size=world)
from repro_torch.checkpoint import CoordinatedCheckpointManager, Level
from repro_torch.distributed.collective import (BarrierTimeout,
    TorchCollective, current_context, get_collective)
from test_torch_coordinated import t_report, t_state
from test_coordinated import make_masks
assert current_context().count == 2 and current_context().index == rank
coll = get_collective()
assert isinstance(coll, TorchCollective)
root = os.environ["ROOT"]
mgr = CoordinatedCheckpointManager(
    [Level(root)], collective=coll, scrutiny_fn=lambda s: t_report(
        make_masks()), save_mode="device", device="cpu",
    barrier_timeout_s=60)
state = t_state()
mgr.save(1, state, block=True)
st, got = mgr.restore(t_state(step_val=0), local_only=True)
assert st == 1
print("SAVED", rank, int(mgr.last_save_stats["host_bytes_written"]),
      flush=True)
mgr.close()
# a second manager in the same group numbers its barriers from q1. again:
# its save must wait for the late rank, not pass on the first one's keys
mgr = CoordinatedCheckpointManager(
    [Level(root)], collective=get_collective(), scrutiny_fn=lambda s:
    t_report(make_masks()), save_mode="device", device="cpu",
    barrier_timeout_s=60)
if rank == 1:
    time.sleep(LATE_S)
t0 = time.monotonic()
mgr.save(2, state, block=True)
print("SECOND", rank, round(time.monotonic() - t0, 3), flush=True)
mgr.close()
coll = TorchCollective(timeout_s=30)
coll.barrier("before_exit")
if rank == 1:
    dist.destroy_process_group()  # rank 1 leaves: it never reaches "late"
    sys.exit(0)
try:
    coll.barrier("late", timeout=1.5)
    print("UNEXPECTED")
except BarrierTimeout as e:
    print("TIMEOUT", e.missing, flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.multiprocess
def test_torch_collective_over_gloo(tmp_path):
    root = str(tmp_path / "lv")
    late_s = 2.0
    env = dict(os.environ, ROOT=root, TEST_DIR=os.path.dirname(__file__),
               INIT=f"tcp://localhost:{_free_port()}", OMP_NUM_THREADS="1",
               LATE_S=str(late_s))
    env.pop("REPRO_PROCESS_COUNT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_PROG],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
        assert "SAVED" in out, (out, err)
    assert "TIMEOUT [1]" in outs[0][0], outs[0]
    # the second manager's save on rank 0 waited for rank 1's late arrival
    second = float(re.search(r"SECOND 0 ([0-9.]+)", outs[0][0]).group(1))
    assert second >= late_s * 0.75, outs[0]
    assert TC.is_step_committed(root, 1) and TC.is_step_committed(root, 2)
    assert {"manifest.host0.json", "manifest.host1.json"} <= set(
        os.listdir(os.path.join(root, "step_2")))
    files = set(os.listdir(os.path.join(root, "step_1")))
    assert {"manifest.host0.json", "manifest.host1.json",
            "commit.json"} <= files
    exp = expected_leaves({k: np.asarray(v) for k, v in make_state().items()},
                          make_masks(), scrutinized=True)
    st, got = TC.CoordinatedCheckpointManager(
        [TC.Level(root)], device="cpu").restore(t_state(step_val=0))
    for k, v in exp.items():
        np.testing.assert_array_equal(to_host(got[k]), v)


# --------------------------------------------------------------------------
# a training state: four hosts save it, one restores it and trains on
# --------------------------------------------------------------------------

def test_training_state_four_hosts_to_one_continues_as_single_process(
        tmp_path):
    """The launcher's state and its participation report, saved by four
    host threads and restored onto one host from shapes alone, continue
    bit for bit as the single-process manager's restore does; the moments
    (no critical element) cost no pack and send nothing."""
    from repro_torch import _tree
    from repro_torch.core import ScrutinyConfig, participation
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import train as launch
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = get_config("xlstm-125m").reduced()
    oc = OptConfig(kind="adamw", lr=3e-3, warmup=2, decay_steps=6)
    step_fn = make_train_step(cfg, oc)
    state = launch.build_state(cfg, oc, 2, 16, seed=3, device="cpu")

    def train(st, n):
        out = []
        for _ in range(n):
            batch, st["data"] = dp.next_batch(cfg, st["data"])
            st["params"], st["opt"], m = step_fn(st["params"], st["opt"],
                                                 batch)
            st["step"] = st["step"] + 1
            out.append(float(m["loss"]))
        return out

    train(state, 2)
    rep = participation(launch.make_resume_fn(cfg), state,
                        config=ScrutinyConfig(), device="cpu")
    like = _tree.unflatten(_tree.flatten_with_names(state)[1],
                           [torch.empty_like(t, device="meta") for _, t
                            in _tree.flatten_with_names(state)[0]])
    single = str(tmp_path / "single")
    with TC.CheckpointManager([TC.Level(single)], scrutiny_fn=lambda s: rep,
                              device="cpu") as mgr:
        mgr.save(2, state, block=True)
    coord = str(tmp_path / "coord")

    def host(p, coll):
        with TC.CoordinatedCheckpointManager(
                [TC.Level(coord)], collective=coll,
                scrutiny_fn=lambda s: rep, partner_replication=False,
                pipeline_engine="device", device="cpu") as mgr:
            mgr.save(2, state, block=False)
            return dict(mgr.wait())

    stats, errors = run_hosts(4, host)
    assert not any(errors), errors
    moments = [n for n in rep.leaves if n.startswith(("opt/mu/", "opt/nu/"))]
    assert moments and all(rep[n].critical == 0 for n in moments)
    kept = sum(t.nbytes for n, t in _tree.flatten_with_names(state)[0]
               if n not in moments)
    assert sum(s["host_bytes_written"] for s in stats) == kept
    with TC.CheckpointManager([TC.Level(single)], device="cpu") as mgr:
        _, want = mgr.restore(like)
    with TC.CoordinatedCheckpointManager([TC.Level(coord)],
                                         device="cpu") as mgr:
        step, got = mgr.restore(like)
        assert mgr.last_restore_stats["h2d_bytes"] == kept
    assert step == 2
    for (n, a), (_, b) in zip(_tree.flatten_with_names(got)[0],
                              _tree.flatten_with_names(want)[0]):
        assert torch.equal(a, b), n
    assert train(got, 3) == train(want, 3)


# --------------------------------------------------------------------------
# masks with no critical element, or every element critical
# --------------------------------------------------------------------------

def _edge_masks():
    rng = np.random.RandomState(5)
    return {"w": np.zeros(N_ROWS * N_COLS, bool),
            "b": np.ones(40, bool),
            "c": rng.rand(10) < 0.5}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("count", [2, 4])
def test_empty_and_full_masks_byte_identical_and_restore(tmp_path, count,
                                                         engine):
    """A leaf with no critical element packs nothing (no words, no K2 on
    the card) and one with every element critical is stored whole: the
    step dirs are still the reference's byte for byte, and the restore
    gives the fill and the values back."""
    from test_coordinated import run_hosts as r_run_hosts
    import jax.numpy as jnp
    from repro.core.criticality import CriticalityReport as RReport
    from repro.core.criticality import LeafReport as RLeaf
    from repro.core.policy import LeafPolicy as RPolicy
    from repro.core.regions import RegionTable as RTable

    masks = _edge_masks()
    np_state = {k: np.asarray(v) for k, v in make_state().items()}

    def r_host(p, coll):
        leaves = {k: RLeaf(name=k, shape=np_state[k].shape,
                           dtype=np_state[k].dtype, policy=RPolicy.AD,
                           mask=m, table=RTable.from_mask(
                               m, np_state[k].dtype.itemsize),
                           magnitude=None) for k, m in masks.items()}
        rep = RReport(leaves=leaves)
        mgr = RC.CoordinatedCheckpointManager(
            [RC.Level(str(tmp_path / "ref"))], collective=coll,
            scrutiny_fn=lambda s: rep, save_mode="device",
            force_coordinated=True, pack_use_kernel=False,
            pack_interpret=True)
        mgr.save(1, {k: jnp.asarray(v) for k, v in np_state.items()})
        mgr.close()

    _, errors = r_run_hosts(count, r_host)
    assert not any(errors), errors

    def t_host(p, coll):
        state = t_state()
        leaves = {k: LeafReport(
            name=k, shape=tuple(np_state[k].shape),
            dtype=str(np_state[k].dtype), policy=LeafPolicy.AD, mask=m,
            table=RegionTable.from_mask(m, np_state[k].dtype.itemsize),
            magnitude=None) for k, m in masks.items()}
        rep = CriticalityReport(leaves=leaves)
        mgr = TC.CoordinatedCheckpointManager(
            [TC.Level(str(tmp_path / "port"))], collective=coll,
            scrutiny_fn=lambda s: rep, force_coordinated=True,
            pipeline_engine=engine, device="cpu")
        mgr.save(1, state)
        mgr.close()

    _, errors = run_hosts(count, t_host)
    assert not any(errors), errors
    assert_dirs_identical(str(tmp_path / "port" / "step_1"),
                          str(tmp_path / "ref" / "step_1"))
    mgr = TC.CoordinatedCheckpointManager([TC.Level(str(tmp_path / "port"))],
                                          device="cpu")
    _, got = mgr.restore(t_state(step_val=0), fill=-7)
    mgr.close()
    for k, m in masks.items():
        want = np.where(m.reshape(np_state[k].shape), np_state[k], -7)
        np.testing.assert_array_equal(to_host(got[k]), want, err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_segment_runs_are_the_segments_own(seed):
    """A leaf's critical runs cut to a segment are ``mask_to_regions`` of
    the segment's mask (what the stub's aux is chosen from)."""
    from repro_torch.core.regions import mask_to_regions
    rng = np.random.RandomState(seed)
    for _ in range(200):
        n = rng.randint(1, 300)
        m = rng.rand(n) < rng.rand()
        lo = rng.randint(0, n)
        hi = rng.randint(lo, n + 1)
        got = t_coord_mod._segment_regions(mask_to_regions(m), lo, hi)
        want = mask_to_regions(m[lo:hi])
        assert got.shape == want.shape and (got == want).all()


@pytest.mark.parametrize("count", [1, 3])
def test_port_state_and_report_carried_to_reference_write_same_dirs(
        tmp_path, count):
    """The other direction of ``convert``: a port state (a bf16 leaf
    among them) and its AD scrutiny report, carried to the reference with
    ``state_to_numpy`` / ``dtype_names`` / ``masks_from_report``, give
    both packages' coordinated saves the same step dir."""
    import jax.numpy as jnp
    from test_coordinated import run_hosts as r_run_hosts
    from repro.core.criticality import CriticalityReport as RReport
    from repro.core.criticality import LeafReport as RLeaf
    from repro.core.policy import LeafPolicy as RPolicy
    from repro.core.regions import RegionTable as RTable
    from repro_torch import ScrutinyConfig, scrutinize
    from repro_torch.convert import (dtype_names, masks_from_report,
                                     state_to_numpy)

    gen = torch.Generator().manual_seed(11)
    state = {"w": torch.randn(50, 6, generator=gen),
             "h": torch.randn(77, generator=gen).to(torch.bfloat16),
             "n": torch.arange(9, dtype=torch.int32)}
    rep = scrutinize(lambda s: (s["w"][::3] ** 2).sum()
                     + (s["h"][5:40].float() * 2).sum(), state,
                     config=ScrutinyConfig(probes=2), device="cpu")
    np_state, names = state_to_numpy(state), dtype_names(state)
    masks = masks_from_report(rep)
    assert set(masks) == {"w", "h"}

    def r_value(k):
        a = np_state[k]
        return (jnp.asarray(a.view(jnp.bfloat16)) if names[k] == "bfloat16"
                else jnp.asarray(a))

    def r_host(p, coll):
        leaves = {k: RLeaf(name=k, shape=np_state[k].shape,
                           dtype=np.dtype(r_value(k).dtype),
                           policy=RPolicy.AD, mask=m,
                           table=RTable.from_mask(
                               m, np_state[k].dtype.itemsize),
                           magnitude=None) for k, m in masks.items()}
        mgr = RC.CoordinatedCheckpointManager(
            [RC.Level(str(tmp_path / "ref"))], collective=coll,
            scrutiny_fn=lambda s: RReport(leaves=leaves), save_mode="device",
            force_coordinated=True, pack_use_kernel=False,
            pack_interpret=True)
        mgr.save(1, {k: r_value(k) for k in np_state})
        mgr.close()

    def t_host(p, coll):
        mgr = TC.CoordinatedCheckpointManager(
            [TC.Level(str(tmp_path / "port"))], collective=coll,
            scrutiny_fn=lambda s: rep, force_coordinated=True,
            device="cpu")
        mgr.save(1, state)
        mgr.close()

    for run, fn in ((r_run_hosts, r_host), (run_hosts, t_host)):
        _, errors = run(count, fn)
        assert not any(errors), errors
    assert_dirs_identical(str(tmp_path / "port" / "step_1"),
                          str(tmp_path / "ref" / "step_1"))
