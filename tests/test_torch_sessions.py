"""The port's serving sessions (``repro_torch.serve.{sessions,migrate}``)
against the reference, on the CPU.

Reduced phi4-mini-3.8b with the reference's parameters (``PRNGKey(0)``)
carried over by ``params_from_numpy``, prompts made with numpy from a
seed.  The matrix of ``tests/test_serve_sessions.py`` on the port:
ownership; same-host restores, full and delta, over 1, 4 and 16 sessions;
masks bit-identical after restore and to the reference's on the same
engine state; the cross-host migrate matrix; elastic restore with missing
sessions; no snapshot; torn shards restored through parity and through
the partner; a host killed mid-decode, its sessions adopted and
continued bit for bit; load shedding.  Then the byte targets of
``BENCH_serve.json`` (``bench_kv_scrutiny.py``'s settings: the snapshot
90,144 B of 262,176 B live, 65.6 % of the KV uncritical, 32,800 B per
step; quick: 20,496 B, 58.3 %, 16,400 B) and each package restoring the
other's session snapshots.

Every comparison is exact: masks and bytes bit for bit, greedy tokens
equal, restored states equal to the live states they were saved from.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as RC
from repro.configs import get_config as r_get_config
from repro.models import init_params as r_init_params
from repro.serve.engine import Engine as REngine
from repro.serve.sessions import SessionManager as RSessionManager
from repro_torch import _tree
from repro_torch.checkpoint import GlobalManifest, Level, read_manifest
from repro_torch.checkpoint.levels import L2_PARTNER, L3_PARITY
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.collective import (FileCollective, HostPinned,
                                                ProcessContext, owned_ranges,
                                                process_segments)
from repro_torch.serve import Engine, SessionManager, migrate
from repro_torch.testing.faults import (FaultInjector, session_shard_files,
                                        tear_session_shard)

torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
MAX_LEN = 24
PROMPT_T = 6
BARRIER_S = 5.0
TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def weights():
    rcfg = r_get_config(ARCH).reduced()
    rparams = jax.jit(lambda k: r_init_params(rcfg, k))(
        jax.random.PRNGKey(0))
    return rcfg, rparams, jax.tree_util.tree_map(np.asarray, rparams)


def make_engine(weights, max_len=MAX_LEN):
    cfg = get_config(ARCH).reduced()
    return Engine(cfg, params_from_numpy(cfg, weights[2], "cpu"), max_len,
                  device="cpu")


@pytest.fixture(scope="module")
def engine(weights):
    return make_engine(weights)


def prompt(vocab, seed, T=PROMPT_T):
    return np.random.RandomState(seed).randint(0, vocab, (1, T)).astype(
        np.int32)


def mk_batch(engine, seed, T=PROMPT_T):
    return {"tokens": torch.from_numpy(prompt(engine.cfg.vocab, seed, T))}


def mk_sm(engine, root, mode="full", collective=None, **kw):
    return SessionManager(
        engine, [Level(str(root), keep_n=3,
                       max_chain=8 if mode == "delta" else 0,
                       **kw.pop("level_kw", {}))],
        collective=collective, rescrutinize_every=4,
        delta_chunk_bytes=64, **kw)


def run_hosts(count, fn, timeout=TIMEOUT_S):
    """``fn(process_index, collective)`` once per simulated host, in
    threads over one shared ``FileCollective`` dir → (results, errors)."""
    import tempfile
    import threading
    results, errors = [None] * count, [None] * count
    coord_dir = tempfile.mkdtemp(prefix="tsess_")

    def run(p):
        try:
            coll = FileCollective(coord_dir, ctx=ProcessContext(p, count),
                                  timeout_s=timeout)
            results[p] = fn(p, coll)
        except BaseException as e:      # noqa: BLE001 - surfaced by caller
            errors[p] = e

    threads = [threading.Thread(target=run, args=(p,)) for p in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout * 4)
        assert not t.is_alive()
    return results, errors


def reference_tokens(engine, seed, n_steps):
    """Uninterrupted greedy decode: per-step tokens after the prefill."""
    state = engine.start(mk_batch(engine, seed))
    out = []
    for _ in range(n_steps):
        state, tok = engine.step(state)
        out.append(tok)
    return torch.stack(out, dim=1)


def assert_states_equal(a, b, what):
    na, nb = (_tree.flatten_with_names(x)[0] for x in (a, b))
    assert [n for n, _ in na] == [n for n, _ in nb], what
    for (n, x), (_, y) in zip(na, nb):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what} {n}"


# --------------------------------------------------------------------------
# HostPinned ownership
# --------------------------------------------------------------------------

def test_hostpinned_ownership():
    pin1 = HostPinned(1)
    assert process_segments((8, 4), 3, pin1) == [(0, 8, 1)]
    assert owned_ranges((8, 4), ProcessContext(1, 3), pin1) == [(0, 32)]
    assert owned_ranges((8, 4), ProcessContext(0, 3), pin1) == []
    assert owned_ranges((), ProcessContext(1, 3), pin1) == [(0, 1)]
    assert owned_ranges((), ProcessContext(0, 3), pin1) == []
    assert hasattr(pin1, "spec")
    with pytest.raises(ValueError):
        HostPinned(-1)


def test_session_ids_and_capacity(engine, tmp_path):
    sm = mk_sm(engine, tmp_path, max_sessions=1)
    with pytest.raises(ValueError, match="must not contain"):
        sm.open("a/b", mk_batch(engine, 0))
    tok = sm.open("a", mk_batch(engine, 0))
    assert tok.shape == (1,) and tok.dtype == torch.int32
    with pytest.raises(ValueError, match="already open"):
        sm.open("a", mk_batch(engine, 0))
    with pytest.raises(RuntimeError, match="capacity"):
        sm.open("b", mk_batch(engine, 1))
    assert sm.decode("a", 3).shape == (1, 3)
    sm.drop("a")
    assert sm.sessions == {}
    sm.close()


# --------------------------------------------------------------------------
# matrix: {1,4,16} sessions x {full, delta} x same-host resume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "delta"])
@pytest.mark.parametrize("n_sessions", [1, 4, 16])
def test_matrix_same_host(engine, tmp_path, n_sessions, mode):
    sids = [f"s{i}" for i in range(n_sessions)]
    sm = mk_sm(engine, tmp_path, mode)
    for i, sid in enumerate(sids):
        sm.open(sid, mk_batch(engine, i))
        sm.decode(sid, 2)
    sm.snapshot(0, block=True)
    if mode == "delta":
        for step in (1, 2):
            for sid in sids:
                sm.step(sid)
            sm.snapshot(step, block=True)
    at_snap = {sid: dict(sm.sessions[sid]) for sid in sids}
    cont = {sid: sm.decode(sid, 3) for sid in sids}
    sm.close()

    last = 2 if mode == "delta" else 0
    gm = GlobalManifest.load(str(tmp_path), last)
    assert bool(gm.chain) == (mode == "delta")
    assert sorted(migrate.manifest_sessions(gm)) == sorted(sids)

    sm2 = mk_sm(engine, tmp_path, mode)
    missing = []
    assert sm2.restore(missing_out=missing) == last
    assert missing == []
    assert sorted(sm2.sessions) == sorted(sids)
    # the restored state is the live state at the snapshot, bit for bit
    # (the scrutinized-away KV slots were zero in the live cache too)
    for sid in sids:
        assert_states_equal(sm2.sessions[sid], at_snap[sid], sid)
    for sid in sids:
        assert torch.equal(sm2.decode(sid, 3), cont[sid]), sid
    sm2.close()


def test_masks_bit_identical_after_restore_and_to_the_reference(
        weights, engine, tmp_path):
    """Scrutiny masks recomputed on the restored state match the live
    run's exactly, and the reference's on the same prompt and position."""
    sm = mk_sm(engine, tmp_path / "t")
    sm.open("s0", mk_batch(engine, 3))
    sm.decode("s0", 2)
    sm.snapshot(0, block=True)
    live = {n: lr.mask.copy() for n, lr in
            sm._scrutinize_tree(sm.state_tree()).leaves.items()}
    assert any(not m.all() for m in live.values())      # non-vacuous
    sm.close()

    sm2 = mk_sm(engine, tmp_path / "t")
    sm2.restore()
    restored = {n: lr.mask for n, lr in
                sm2._scrutinize_tree(sm2.state_tree()).leaves.items()}
    assert sorted(restored) == sorted(live)
    for name, m in live.items():
        np.testing.assert_array_equal(restored[name], m, err_msg=name)
    sm2.close()

    rcfg, rparams, _ = weights
    reng = REngine(rcfg, rparams, MAX_LEN)
    rsm = RSessionManager(reng, [RC.Level(str(tmp_path / "r"))],
                          rescrutinize_every=4, pack_use_kernel=False,
                          pack_interpret=True)
    rsm.open("s0", {"tokens": jnp.asarray(prompt(rcfg.vocab, 3))})
    rsm.decode("s0", 2)
    ref = {n: np.asarray(lr.mask) for n, lr in
           rsm._scrutinize_tree(rsm.state_tree()).leaves.items()}
    rsm.close()
    assert sorted(ref) == sorted(live)
    for name, m in ref.items():
        np.testing.assert_array_equal(live[name], m, err_msg=name)


# --------------------------------------------------------------------------
# matrix: cross-host migrate (coordinated 2-host save -> fresh host B)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "delta"])
@pytest.mark.parametrize("n_sessions", [1, 4, 16])
def test_matrix_migrate(engine, tmp_path, n_sessions, mode):
    root = str(tmp_path)
    sids = [f"s{i}" for i in range(n_sessions)]
    by_host = {0: sids[0::2], 1: sids[1::2]}
    cont = {}

    def host(p, coll):
        sm = mk_sm(engine, root, mode, collective=coll, save_mode="device")
        for sid in by_host[p]:
            sm.open(sid, mk_batch(engine, int(sid[1:])))
            sm.decode(sid, 2)
        sm.snapshot(0, block=True)
        if mode == "delta":
            for step in (1, 2):
                for sid in by_host[p]:
                    sm.step(sid)
                sm.snapshot(step, block=True)
        out = {sid: sm.decode(sid, 3) for sid in by_host[p]}
        sm.close()
        return out

    results, errors = run_hosts(2, host)
    assert not any(errors), [e for e in errors if e]
    for r in results:
        cont.update(r)

    smB = mk_sm(engine, tmp_path, mode)
    step = smB.restore()
    assert step == (2 if mode == "delta" else 0)
    assert sorted(smB.sessions) == sorted(sids)
    for sid in sids:
        assert torch.equal(smB.decode(sid, 3), cont[sid]), sid
    owners = migrate.session_owners(GlobalManifest.load(root, step))
    assert owners == {sid: p for p, ss in by_host.items() for sid in ss}
    smB.close()


# --------------------------------------------------------------------------
# elastic missing-session accounting
# --------------------------------------------------------------------------

def test_restore_missing_sessions_elastic(engine, tmp_path):
    sm = mk_sm(engine, tmp_path)
    sm.open("old", mk_batch(engine, 1))
    sm.decode("old", 2)
    sm.snapshot(0, block=True)
    sm.open("new", mk_batch(engine, 2))
    new_live = dict(sm.sessions["new"])
    missing = []
    assert sm.restore(missing_out=missing) == 0
    assert [m["sid"] for m in missing] == ["new"]
    assert missing[0]["reason"].startswith("opened after snapshot")
    assert_states_equal(sm.sessions["new"], new_live, "new")
    missing2 = []
    assert sm.restore(sids=["old", "ghost"], missing_out=missing2) == 0
    assert [m["sid"] for m in missing2] == ["ghost"]
    assert missing2[0]["reason"] == "not in manifest"
    sm.close()


def test_restore_without_snapshot_reports_all(engine, tmp_path):
    sm = mk_sm(engine, tmp_path)
    sm.open("a", mk_batch(engine, 1))
    missing = []
    assert sm.restore(missing_out=missing) is None
    assert [m["sid"] for m in missing] == ["a"]
    assert missing[0]["step"] is None
    assert migrate.restore_sessions(sm.ckpt, sids=["a"]) is None
    assert sm.ckpt.last_restore_stats["step"] is None
    sm.close()


# --------------------------------------------------------------------------
# session-shard faults: torn files restore through parity / partner
# --------------------------------------------------------------------------

def test_torn_session_shard_restores_via_parity(engine, tmp_path):
    sm = mk_sm(engine, tmp_path, level_kw={"shards": 2, "parity": True})
    for i in range(2):
        sm.open(f"s{i}", mk_batch(engine, i))
        sm.decode(f"s{i}", 2)
    sm.snapshot(0, block=True)
    cont = {sid: sm.decode(sid, 3) for sid in ("s0", "s1")}
    sm.close()

    files = session_shard_files(str(tmp_path), 0, "s0")
    assert files and all(os.path.exists(f) for f in files)
    torn = tear_session_shard(str(tmp_path), 0, "s0", frac=0.0)
    assert torn in files and os.path.getsize(torn) == 0

    sm2 = mk_sm(engine, tmp_path, level_kw={"shards": 2, "parity": True})
    assert sm2.restore() == 0
    assert sm2.ckpt.last_restore_stats["level_served"][L3_PARITY] > 0
    for sid in ("s0", "s1"):
        assert torch.equal(sm2.decode(sid, 3), cont[sid]), sid
    sm2.close()


def test_torn_session_shard_restores_via_partner(engine, tmp_path):
    root = str(tmp_path)
    cont = {}

    def save_host(p, coll):
        sm = mk_sm(engine, root, collective=coll, save_mode="device")
        sid = f"h{p}"
        sm.open(sid, mk_batch(engine, p))
        sm.decode(sid, 2)
        sm.snapshot(0, block=True)
        out = sm.decode(sid, 3)
        sm.close()
        return {sid: out}

    results, errors = run_hosts(2, save_host)
    assert not any(errors), [e for e in errors if e]
    for r in results:
        cont.update(r)

    tear_session_shard(root, 0, "h0")

    def restore_host(p, coll):
        if p != 1:      # only the partner of host 0 restores
            return None
        sm = mk_sm(engine, root, collective=coll)
        missing = []
        assert sm.restore(missing_out=missing) == 0
        assert missing == []
        stats = dict(sm.ckpt.last_restore_stats)
        toks = {sid: sm.decode(sid, 3) for sid in ("h0", "h1")}
        sm.close()
        return stats, toks

    results, errors = run_hosts(2, restore_host)
    assert not any(errors), [e for e in errors if e]
    stats, toks = results[1]
    assert stats["level_served"][L2_PARTNER] > 0
    assert stats["bytes_read_store"] == 0
    for sid in ("h0", "h1"):
        assert torch.equal(toks[sid], cont[sid]), sid


# --------------------------------------------------------------------------
# kill host A mid-decode; the survivor adopts and keeps serving
# --------------------------------------------------------------------------

def test_kill_host_mid_decode_adopt_and_continue(engine, tmp_path):
    root = str(tmp_path)
    by_host = {0: ["a0", "a1"], 1: ["b0"]}

    def host(p, coll):
        inj = FaultInjector().kill_at("after_replicate", match="q2") \
            if p == 0 else None
        sm = mk_sm(engine, root, collective=coll, save_mode="device",
                   barrier_timeout_s=BARRIER_S, fault_injector=inj)
        for sid in by_host[p]:
            sm.open(sid, mk_batch(engine, int(sid[1:]) + 10 * p))
            sm.decode(sid, 2)
        sm.snapshot(1, block=True)
        for sid in by_host[p]:
            sm.step(sid)
        sm.snapshot(2, block=True)          # host 0 dies inside this one
        rep = migrate.adopt_sessions(sm, dead_host=0)
        assert rep.step == 2
        assert rep.adopted == ["a0", "a1"]
        assert rep.shed == [] and rep.missing == []
        assert rep.partner_served, rep.read_stats
        out = {sid: sm.decode(sid, 3) for sid in by_host[1] + rep.adopted}
        sm.close()
        return out

    results, errors = run_hosts(2, host)
    assert errors[0] is not None            # host 0 really died
    assert errors[1] is None, errors[1]
    assert not [d for d in os.listdir(root) if d.startswith(".pending")]
    man = read_manifest(root, 2)
    assert [int(h) for h in man["degraded"]["missing"]] == [0]
    assert int(man["degraded"]["recovered_from"]["0"]) == 1
    for p, sids in by_host.items():
        for sid in sids:
            ref = reference_tokens(engine, int(sid[1:]) + 10 * p, 6)
            assert torch.equal(results[1][sid], ref[:, 3:]), sid


def test_adoption_load_shedding(engine, tmp_path):
    root = str(tmp_path)

    def host(p, coll):
        sm = mk_sm(engine, root, collective=coll, save_mode="device")
        for i in range(3 if p == 0 else 1):
            sm.open(f"h{p}s{i}", mk_batch(engine, 10 * p + i))
        sm.snapshot(0, block=True)
        sm.close()

    _, errors = run_hosts(2, host)
    assert not any(errors), [e for e in errors if e]

    sm = mk_sm(engine, tmp_path, max_sessions=3)
    sm.open("own", mk_batch(engine, 99))
    rep = migrate.adopt_sessions(sm, dead_host=0)
    assert rep.adopted == ["h0s0", "h0s1"]
    assert rep.shed == ["h0s2"]
    with pytest.raises(RuntimeError, match="capacity"):
        sm.open("overflow", mk_batch(engine, 98))
    sm.close()


# --------------------------------------------------------------------------
# the hardware-independent byte targets (BENCH_serve.json)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quick,want", [
    (False, {"snapshot_bytes": 90144, "live_state_bytes": 262176,
             "kv_uncritical_rate": 0.6561699011351153,
             "delta_bytes_per_step": 32800}),
    (True, {"snapshot_bytes": 20496,
            "kv_uncritical_rate": 0.5831435079726651,
            "delta_bytes_per_step": 16400}),
], ids=["full", "quick"])
def test_bench_serve_byte_targets(weights, tmp_path, quick, want):
    """``bench_kv_scrutiny.py``'s sessions section: warm base + delta,
    then a fresh-scrutiny base snapshot and a one-step delta; a fresh
    manager then adopts the snapshot and serves a token per session."""
    n_sessions, max_len, prompt_t, pre_steps = ((2, 24, 6, 2) if quick
                                                else (4, 64, 16, 4))
    eng = make_engine(weights, max_len)
    root = str(tmp_path)
    sm = SessionManager(eng, [Level(root, keep_n=4, max_chain=8)],
                        rescrutinize_every=2, delta_chunk_bytes=1024)
    for i in range(n_sessions):
        sm.open(f"s{i}", mk_batch(eng, i, prompt_t))
        sm.decode(f"s{i}", pre_steps)
    live = sum(t.nbytes for s in sm.sessions.values()
               for t in _tree.leaves(s))
    sm.snapshot(0, block=True)
    sm.snapshot(1, block=True)
    sm.snapshot(2, block=True)          # fresh scrutiny + full base save
    man = read_manifest(root, 2)
    assert not man.get("chain")
    st = sm.last_session_stats["sessions"]
    got = {"snapshot_bytes": int(man["payload_bytes"]),
           "live_state_bytes": live,
           "kv_uncritical_rate": (sum(s["uncritical"] for s in st.values())
                                  / sum(s["total"] for s in st.values()))}
    for i in range(n_sessions):
        sm.step(f"s{i}")
    sm.snapshot(3, block=True)
    man = read_manifest(root, 3)
    assert man.get("chain")
    got["delta_bytes_per_step"] = int(man["payload_bytes"])
    at_snap = {sid: dict(s) for sid, s in sm.sessions.items()}
    sm.close()
    assert {k: got[k] for k in want} == want

    sm2 = SessionManager(eng, [Level(root, keep_n=3, max_chain=8)])
    assert sm2.restore() == 3 and len(sm2.sessions) == n_sessions
    for sid, s in at_snap.items():
        assert_states_equal(sm2.sessions[sid], s, sid)
        sm2.step(sid)
    sm2.close()


# --------------------------------------------------------------------------
# each package restores the other's session snapshots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "delta"])
def test_cross_package_session_restores(weights, engine, tmp_path, mode):
    rcfg, rparams, _ = weights
    reng = REngine(rcfg, rparams, MAX_LEN)
    max_chain = 8 if mode == "delta" else 0

    def r_sm(root):
        return RSessionManager(reng, [RC.Level(root, keep_n=3,
                                               max_chain=max_chain)],
                               rescrutinize_every=4, delta_chunk_bytes=64,
                               pack_use_kernel=False, pack_interpret=True)

    def t_sm(root):
        return mk_sm(engine, root, mode)

    last = 2 if mode == "delta" else 0
    # the reference writes, the port restores
    rsm = r_sm(str(tmp_path / "r"))
    for i in range(2):
        rsm.open(f"s{i}", {"tokens": jnp.asarray(prompt(rcfg.vocab, i))})
        rsm.decode(f"s{i}", 2)
    rsm.snapshot(0, block=True)
    if mode == "delta":
        for step in (1, 2):
            for sid in ("s0", "s1"):
                rsm.step(sid)
            rsm.snapshot(step, block=True)
    r_live = {sid: jax.tree_util.tree_map(np.asarray, s)
              for sid, s in rsm.sessions.items()}
    rsm.close()
    sm = t_sm(tmp_path / "r")
    assert sm.restore() == last
    for sid, s in r_live.items():
        named = dict(_tree.flatten_with_names(s)[0])
        for n, t in _tree.flatten_with_names(sm.sessions[sid])[0]:
            np.testing.assert_array_equal(t.numpy(), named[n],
                                          err_msg=f"{sid} {n}")
    sm.close()
    # the port writes, the reference restores
    sm = t_sm(tmp_path / "t")
    for i in range(2):
        sm.open(f"s{i}", mk_batch(engine, i))
        sm.decode(f"s{i}", 2)
    sm.snapshot(0, block=True)
    if mode == "delta":
        for step in (1, 2):
            for sid in ("s0", "s1"):
                sm.step(sid)
            sm.snapshot(step, block=True)
    t_live = {sid: dict(_tree.flatten_with_names(s)[0])
              for sid, s in sm.sessions.items()}
    sm.close()
    rsm = r_sm(str(tmp_path / "t"))
    assert rsm.restore() == last
    for sid, named in t_live.items():
        got = dict(_tree.flatten_with_names(
            jax.tree_util.tree_map(np.asarray, rsm.sessions[sid]))[0])
        for n, t in named.items():
            np.testing.assert_array_equal(got[n], t.numpy(),
                                          err_msg=f"{sid} {n}")
    rsm.close()
