"""The port's checkpoint layer against the reference's, on the CPU.

Given the same state and the same masks, the port's ``save_checkpoint``
and its ``CheckpointManager`` (both pipeline engines: the host engine and
the device engine forced onto CPU tensors, which runs the stage-1 pack and
the chunked transfer code with the kernels' plain versions) write step
directories byte-identical to ``repro``'s — full, regions, bitmap, delta
chains and parity shards, compared file by file.  Each package restores
the other's checkpoints; a mutation right after ``save(block=False)``
never reaches the checkpoint; and the whole slice (scrutinize → save →
delta → restore → resume) gives the reference's output.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
from repro.core import ScrutinyConfig as RConfig
from repro.core import scrutinize as r_scrutinize
from repro.core.criticality import CriticalityReport as RReport
from repro.core.criticality import LeafReport as RLeaf
from repro.core.policy import LeafPolicy as RPolicy
from repro.core.regions import RegionTable as RTable
import repro_torch.checkpoint as TC
from repro_torch import ScrutinyConfig, scrutinize
from repro_torch._tensors import to_host
from repro_torch.checkpoint import manager as t_manager
from repro_torch.convert import report_from_masks, state_from_numpy
from repro_torch.kernels.mask_pack import ops

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16", "int32"]
DENSITIES = [0.0, 0.03, 0.5, 1.0]


def _vals(n, dtype, seed):
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return np.asarray(jnp.asarray(rng.randint(-2 ** 30, 2 ** 30, n),
                                      jnp.int32))
    return np.asarray(jnp.asarray(rng.randn(n), getattr(jnp, dtype)))


def _mask(n, frac, seed):
    if frac in (0.0, 1.0):
        return np.full(n, frac == 1.0)
    return np.random.RandomState(seed).rand(n) < frac


def _case(dtype, frac, n=4000):
    np_state = {"w": _vals(n, dtype, 7).reshape(40, n // 40),
                "b": _vals(n // 8, dtype, 8),
                "s": np.asarray(5, np.int32)}
    masks = {"w": _mask(n, frac, 9), "b": _mask(n // 8, frac, 10)}
    return np_state, masks


def _r_report(np_state, masks):
    leaves = {}
    for name, leaf in np_state.items():
        n = int(np.prod(leaf.shape)) if leaf.ndim else 1
        m = masks.get(name, np.ones(n, bool))
        leaves[name] = RLeaf(
            name=name, shape=tuple(leaf.shape), dtype=np.dtype(leaf.dtype),
            policy=RPolicy.AD, mask=m,
            table=RTable.from_mask(m, np.dtype(leaf.dtype).itemsize),
            magnitude=None)
    return RReport(leaves=leaves)


def _j(np_state):
    return {k: jnp.asarray(v) for k, v in np_state.items()}


def _tree_bytes(d, step):
    sd = os.path.join(d, f"step_{step}")
    out = {}
    for f in sorted(os.listdir(sd)):
        with open(os.path.join(sd, f), "rb") as fh:
            out[f] = fh.read()
    return out


# --------------------------------------------------------------------------
# save_checkpoint: full / regions / bitmap / parity shards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frac", DENSITIES)
@pytest.mark.parametrize("layout", [(1, False), (3, True)])
def test_save_checkpoint_byte_identical(tmp_path, dtype, frac, layout):
    shards, parity = layout
    np_state, masks = _case(dtype, frac)
    t_state = state_from_numpy(np_state, "cpu")
    for tag, rep_r, rep_t in (("full", None, None),
                              ("scrutinized", _r_report(np_state, masks),
                               report_from_masks(masks, t_state))):
        dr, dt = str(tmp_path / f"r_{tag}"), str(tmp_path / f"t_{tag}")
        RC.save_checkpoint(dr, 1, _j(np_state), report=rep_r, shards=shards,
                           parity=parity)
        TC.save_checkpoint(dt, 1, t_state, report=rep_t, shards=shards,
                           parity=parity)
        assert _tree_bytes(dr, 1) == _tree_bytes(dt, 1), tag


def test_encodings_cover_regions_and_bitmap(tmp_path):
    """Both aux encodings appear in the identity matrix above: a solid
    mask picks regions, a fragmented one the bitmap."""
    np_state = {"solid": np.arange(4000, dtype=np.float32),
                "frag": np.arange(4000, dtype=np.float32)}
    masks = {"solid": np.arange(4000) < 1500, "frag": _mask(4000, 0.5, 1)}
    t_state = state_from_numpy(np_state, "cpu")
    TC.save_checkpoint(str(tmp_path), 1, t_state,
                       report=report_from_masks(masks, t_state))
    enc = {e["name"]: e["encoding"]
           for e in TC.read_manifest(str(tmp_path), 1)["leaves"]}
    assert enc == {"solid": "regions", "frag": "bitmap"}


# --------------------------------------------------------------------------
# CheckpointManager: both engines × save modes × a delta chain
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("save_mode", ["host", "device"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_manager_chain_byte_identical(tmp_path, monkeypatch, engine,
                                     save_mode, dtype):
    # 700-byte transfer chunks: every leaf streams in many chunks
    monkeypatch.setattr(t_manager, "D2H_CHUNK_BYTES", 700)
    np_state, masks = _case(dtype, 0.3)
    rep_r = _r_report(np_state, masks)
    t_state = state_from_numpy(np_state, "cpu")
    rep_t = report_from_masks(masks, t_state)
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    level = dict(keep_n=5, max_chain=2, shards=2, parity=True)
    hot = np.flatnonzero(masks["w"])[:6]
    with RC.CheckpointManager([RC.Level(dr, **level)],
                              scrutiny_fn=lambda s: rep_r,
                              save_mode=save_mode) as rm, \
            TC.CheckpointManager([TC.Level(dt, **level)],
                                 scrutiny_fn=lambda s: rep_t,
                                 save_mode=save_mode, pipeline_engine=engine,
                                 device="cpu") as tm:
        w = np_state["w"].reshape(-1).copy()
        for step in (1, 2, 3, 4):
            cur = dict(np_state, w=w.reshape(40, 100))
            rm.save(step, _j(cur), block=True)
            tm.save(step, state_from_numpy(cur, "cpu"), block=True)
            assert tm.last_save_stats["engine"] == (
                engine if save_mode == "device" else "host")
            assert _tree_bytes(dr, step) == _tree_bytes(dt, step), step
            kind = tm.last_save_stats["levels"][dt]["kind"]
            assert kind == ("base" if step in (1, 4) else "delta")
            w = w.copy()
            if dtype != "int32":
                w[hot] = (w[hot].astype(np.float32) + step).astype(w.dtype)
            else:
                w[hot] += step


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manager_uncritical_leaves_byte_identical(tmp_path, engine, dtype):
    """Leaves with no critical element (a training state's Adam moments)
    are stored as zero regions and an empty payload.  The step directories
    (a base and a delta) stay byte-identical to the reference's, and each
    package restores them to the fill."""
    np_state, masks = _case(dtype, 0.3)
    np_state["mu"] = _vals(3000, "float32", 11).reshape(30, 100)
    np_state["nu"] = _vals(33, dtype, 12)
    masks["mu"], masks["nu"] = np.zeros(3000, bool), np.zeros(33, bool)
    rep_r = _r_report(np_state, masks)
    t_state = state_from_numpy(np_state, "cpu")
    rep_t = report_from_masks(masks, t_state)
    dr, dt = str(tmp_path / "r"), str(tmp_path / "t")
    level = dict(keep_n=3, max_chain=1)
    with RC.CheckpointManager([RC.Level(dr, **level)],
                              scrutiny_fn=lambda s: rep_r,
                              save_mode="device") as rm, \
            TC.CheckpointManager([TC.Level(dt, **level)],
                                 scrutiny_fn=lambda s: rep_t,
                                 pipeline_engine=engine,
                                 device="cpu") as tm:
        for step in (1, 2):
            rm.save(step, _j(np_state), block=True)
            tm.save(step, t_state, block=True)
            assert _tree_bytes(dr, step) == _tree_bytes(dt, step), step
    enc = {e["name"]: (e["encoding"], e["num_regions"])
           for e in TC.read_manifest(dt, 1)["leaves"]}
    assert enc["mu"] == enc["nu"] == ("regions", 0)
    expect = {k: np.where(masks[k].reshape(v.shape), v, np.zeros((), v.dtype))
              if k in masks else v for k, v in np_state.items()}
    with TC.CheckpointManager([TC.Level(dt, keep_n=0)],
                              device="cpu") as tm:
        step, got = tm.restore({k: torch.ones_like(v)
                                for k, v in t_state.items()})
    with RC.CheckpointManager([RC.Level(dt, keep_n=0)]) as rm:
        _, got_r = rm.restore({k: jnp.ones_like(jnp.asarray(v))
                               for k, v in np_state.items()})
    assert step == 2
    for k, v in expect.items():
        assert to_host(got[k]).tobytes() == np.asarray(v).tobytes(), k
        assert np.asarray(got_r[k]).tobytes() == np.asarray(v).tobytes(), k


# --------------------------------------------------------------------------
# cross-restore, both ways
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("mode", ["host", "device"])
def test_cross_restore(tmp_path, writer, mode):
    np_state, masks = _case("bfloat16", 0.3)
    np_state["f"] = _vals(777, "float32", 3)
    masks["f"] = _mask(777, 0.03, 4)
    t_state = state_from_numpy(np_state, "cpu")
    d = str(tmp_path / "ckpt")
    level = dict(keep_n=3, max_chain=1)
    if writer == "reference":
        with RC.CheckpointManager([RC.Level(d, **level)],
                                  scrutiny_fn=lambda s: _r_report(np_state,
                                                                  masks),
                                  save_mode="device") as rm:
            rm.save(1, _j(np_state), block=True)
            rm.save(2, _j(np_state), block=True)     # a delta on top
    else:
        rep = report_from_masks(masks, t_state)
        with TC.CheckpointManager([TC.Level(d, **level)],
                                  scrutiny_fn=lambda s: rep,
                                  save_mode="device", device="cpu") as tm:
            tm.save(1, t_state, block=True)
            tm.save(2, t_state, block=True)
    assert TC.chain_steps(TC.read_manifest(d, 2)) == [1]
    expect = {k: np.where(masks[k].reshape(v.shape), v, np.zeros((), v.dtype))
              if k in masks else v for k, v in np_state.items()}
    # the port restores
    with TC.CheckpointManager([TC.Level(d, keep_n=0)], restore_mode=mode,
                              device="cpu") as tm:
        step, got = tm.restore({k: torch.zeros_like(v)
                                for k, v in t_state.items()})
    assert step == 2
    for k, v in expect.items():
        assert to_host(got[k]).tobytes() == np.asarray(v).tobytes(), k
    # the reference restores
    with RC.CheckpointManager([RC.Level(d, keep_n=0)],
                              restore_mode=mode) as rm:
        step, got_r = rm.restore({k: jnp.zeros_like(jnp.asarray(v))
                                  for k, v in np_state.items()})
    for k, v in expect.items():
        assert np.asarray(got_r[k]).tobytes() == np.asarray(v).tobytes(), k


def test_device_restore_h2d_matches_reference(tmp_path):
    np_state, masks = _case("float32", 0.148, n=40 * 400)
    t_state = state_from_numpy(np_state, "cpu")
    d = str(tmp_path / "c")
    TC.save_checkpoint(d, 1, t_state,
                       report=report_from_masks(masks, t_state))
    with RC.CheckpointManager([RC.Level(d, keep_n=0)]) as rm:
        rm.restore({k: jnp.zeros_like(jnp.asarray(v))
                    for k, v in np_state.items()})
    with TC.CheckpointManager([TC.Level(d, keep_n=0)], device="cpu") as tm:
        tm.restore({k: torch.zeros_like(v) for k, v in t_state.items()})
    for key in ("h2d_bytes", "full_bytes", "device_leaves", "bytes_read"):
        assert tm.last_restore_stats[key] == rm.last_restore_stats[key], key


# --------------------------------------------------------------------------
# snapshot isolation: mutate right after save(block=False)
# --------------------------------------------------------------------------

class _Gate:
    """Holds the writer thread inside the store write until released."""

    def __init__(self, monkeypatch):
        self.entered = threading.Event()
        self.release = threading.Event()
        real = t_manager.save_checkpoint

        def gated(*a, **k):
            self.entered.set()
            assert self.release.wait(timeout=30)
            return real(*a, **k)

        monkeypatch.setattr(t_manager, "save_checkpoint", gated)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("scrutinized", [False, True])
def test_mutation_after_async_save(tmp_path, monkeypatch, engine,
                                   scrutinized):
    np_state, masks = _case("float32", 0.5)
    state = state_from_numpy(np_state, "cpu")
    rep = report_from_masks(masks, state)
    gate = _Gate(monkeypatch)
    d = str(tmp_path / "c")
    with TC.CheckpointManager(
            [TC.Level(d)], scrutiny_fn=(lambda s: rep) if scrutinized
            else None, save_mode="device", pipeline_engine=engine,
            device="cpu") as mgr:
        mgr.save(1, state, block=False)
        assert gate.entered.wait(timeout=30)        # the write is in flight
        state["w"].add_(100.0)                      # in place, on purpose
        state["b"].zero_()
        state["s"].fill_(-1)
        gate.release.set()
        mgr.wait()
    _, leaves = TC.load_checkpoint(d)
    for k, v in np_state.items():
        m = masks.get(k, np.ones(v.size, bool)) if scrutinized \
            else np.ones(v.size, bool)
        got = leaves[k].reshape(-1)[m]
        assert got.tobytes() == v.reshape(-1)[m].tobytes(), k


# --------------------------------------------------------------------------
# the whole slice, both packages
# --------------------------------------------------------------------------

def test_whole_slice_matches_reference(tmp_path):
    rng = np.random.RandomState(0)
    n = 3000
    sel = rng.rand(n) < 0.148
    np_state = {"w": rng.randn(n).astype(np.float32),
                "b": (rng.rand(n // 8) + 0.5).astype(np.float32),
                "step": np.asarray(1, np.int32)}
    nb = (n // 8) * 7 // 8

    def j_resume(s):
        return (jnp.sum(s["w"] * jnp.asarray(sel, jnp.float32))
                + jnp.sum(s["b"][:nb] ** 2))

    fsel = torch.from_numpy(sel).float()

    def t_resume(s):
        return (s["w"] * fsel).sum() + (s["b"][:nb] ** 2).sum()

    outs = {}
    for pkg in ("reference", "port"):
        d = str(tmp_path / pkg)
        if pkg == "reference":
            state = _j(np_state)
            with RC.CheckpointManager(
                    [RC.Level(d, keep_n=3, max_chain=2)],
                    scrutiny_fn=lambda s: r_scrutinize(
                        j_resume, s, config=RConfig(probes=4)),
                    save_mode="device", restore_mode="device") as mgr:
                mgr.save(1, state, block=True)
                w = np.asarray(state["w"]).copy()
                w[:64] += 1.0
                state = dict(state, w=jnp.asarray(w))
                mgr.save(2, state, block=True)
                mgr.save(3, state, block=True)
                step, got = mgr.restore({k: jnp.zeros_like(v)
                                         for k, v in state.items()})
            outs[pkg] = (step, float(j_resume(got)), float(j_resume(state)))
        else:
            state = state_from_numpy(np_state, "cpu")
            with TC.CheckpointManager(
                    [TC.Level(d, keep_n=3, max_chain=2)],
                    scrutiny_fn=lambda s: scrutinize(
                        t_resume, s, config=ScrutinyConfig(probes=4),
                        device="cpu"),
                    save_mode="device", restore_mode="device",
                    pipeline_engine="device", device="cpu") as mgr:
                mgr.save(1, state, block=True)
                state["w"][:64] += 1.0
                mgr.save(2, state, block=True)
                mgr.save(3, state, block=True)
                assert mgr.last_save_stats["levels"][d]["delta_bytes"] == 0
                step, got = mgr.restore({k: torch.zeros_like(v)
                                         for k, v in state.items()})
            outs[pkg] = (step, float(t_resume(got)), float(t_resume(state)))
        # each package's own restart reproduces its own output exactly
        assert outs[pkg][1] == outs[pkg][2]
        # same step directories: the masks and the payload bytes agree
    for step in (1, 2, 3):
        assert _tree_bytes(str(tmp_path / "reference"), step) == \
            _tree_bytes(str(tmp_path / "port"), step), step
    assert outs["port"][0] == outs["reference"][0] == 3
    np.testing.assert_allclose(outs["port"][1], outs["reference"][1],
                               rtol=1e-6)       # sums in another order


# --------------------------------------------------------------------------
# the reference bench state: hardware-independent byte counts
# --------------------------------------------------------------------------

def test_bench_state_byte_counts(tmp_path):
    """``benchmarks/bench_pack.py:130-141`` at its full n = 2**23: the
    device-packed save writes 7,168,148 B and moves 5,594,532 B D2H; the
    device restore moves 6,774,180 B H2D (BENCH_pack.json,
    BENCH_restore.json)."""
    n = 1 << 23
    rng = np.random.RandomState(0)
    np_state = {"w": rng.randn(n).astype(np.float32),
                "b": rng.randn(n // 8).astype(np.float32),
                "step": np.asarray(7, np.int32)}
    masks = {"w": rng.rand(n) < 0.148, "b": rng.rand(n // 8) < 0.148}
    state = state_from_numpy(np_state, "cpu")
    rep = report_from_masks(masks, state)
    d = str(tmp_path / "bench")
    with TC.CheckpointManager([TC.Level(d, keep_n=1)],
                              scrutiny_fn=lambda s: rep, save_mode="device",
                              restore_mode="device", pipeline_engine="device",
                              device="cpu") as mgr:
        mgr.save(1, state, block=True)
        d2h = mgr.last_save_stats["d2h_bytes"]
        mgr.restore({k: torch.zeros_like(v) for k, v in state.items()})
        h2d = mgr.last_restore_stats["h2d_bytes"]
    disk = sum(os.path.getsize(os.path.join(d, "step_1", f))
               for f in os.listdir(os.path.join(d, "step_1")))
    assert (disk, d2h, h2d) == (7_168_148, 5_594_532, 6_774_180)


# --------------------------------------------------------------------------
# retention and error semantics
# --------------------------------------------------------------------------

def test_retention_keeps_chain_predecessors(tmp_path):
    np_state, masks = _case("float32", 0.3)
    state = state_from_numpy(np_state, "cpu")
    rep = report_from_masks(masks, state)
    d = str(tmp_path / "c")
    with TC.CheckpointManager([TC.Level(d, keep_n=1, max_chain=3)],
                              scrutiny_fn=lambda s: rep, device="cpu") as mgr:
        for step in (1, 2, 3):
            mgr.save(step, state, block=True)
    assert sorted(os.listdir(d)) == ["step_1", "step_2", "step_3"]
    assert TC.chain_steps(TC.read_manifest(d, 3)) == [1, 2]


def test_writer_error_surfaces_exactly_once(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(t_manager, "save_checkpoint", boom)
    mgr = TC.CheckpointManager([TC.Level(str(tmp_path))], device="cpu")
    mgr.save(1, {"x": torch.ones(3)}, block=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                  # drained: no second raise
    mgr.close()
    mgr.close()                                 # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(2, {"x": torch.ones(3)})


def test_foreign_live_tmp_dir_survives_gc(tmp_path):
    d = str(tmp_path)
    foreign = os.path.join(d, ".tmp_step_9.abcdef01")
    os.makedirs(foreign)
    with open(os.path.join(foreign, ".alive"), "w"):
        pass
    stale = os.path.join(d, ".tmp_step_8")
    os.makedirs(stale)
    with TC.CheckpointManager([TC.Level(d)], device="cpu") as mgr:
        mgr.save(1, {"x": torch.ones(3)}, block=True)
    assert os.path.isdir(foreign) and not os.path.exists(stale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frac", [0.0, 0.03, 0.5])
def test_single_device_sharding_matches_reference(dtype, frac):
    from repro.distributed import sharding as r_sh
    from repro_torch.distributed import sharding as t_sh

    n = 40 * 70
    np_state, masks = _case(dtype, frac, n=n)
    leaf_np, m = np_state["w"], masks["w"]
    leaf_t = state_from_numpy({"w": leaf_np}, "cpu")["w"]
    # the port packs a leaf as the coordinator and the manager do, with
    # pack_group from the mask's words: the reference's sharded pack bytes
    p_r, c_r, d_r = r_sh.pack_sharded_payload(jnp.asarray(leaf_np), m,
                                              use_kernel=False)
    pay_t, c_t = ops.pack_group([leaf_t.reshape(-1)],
                                [torch.from_numpy(np.packbits(m))],
                                [int(m.sum())])
    p_t = to_host(pay_t)
    assert p_t.tobytes() == np.asarray(p_r).tobytes()
    assert to_host(c_t).tobytes() == np.asarray(c_r).tobytes()
    out_r, h_r = r_sh.scatter_sharded_payload(
        np.asarray(p_r), m, leaf_np.shape, leaf_np.dtype, fill=1,
        use_kernel=False)
    out_t, h_t = t_sh.scatter_sharded_payload(p_t, m, leaf_np.shape,
                                              str(leaf_np.dtype), "cpu",
                                              fill=1)
    # with no critical element the port moves no mask words (the
    # reference moves its whole bitmap)
    assert tuple(out_t.shape) == leaf_np.shape
    assert h_t == (h_r if m.any() else 0)
    assert to_host(out_t).tobytes() == np.asarray(out_r).tobytes()
