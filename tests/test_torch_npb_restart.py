"""The paper's §IV-C restart protocol on the port's NPB programs (CPU).

The matrix of ``tests/test_npb_paper.py:66-89`` under the port's AD masks:
a restart from the critical elements alone verifies, garbage in every
uncritical element changes nothing, and corrupting critical elements
breaks verification (every program but IS, whose state is all integer).
The restart packs each leaf through the tiled pack (K2) and rebuilds all
of a program's leaves with one grouped unpack (K5) from the masks' words
on the state's device; here their plain versions.  Each program's
state also goes through a scrutinized ``CheckpointManager`` save and a
restore into fresh tensors, and the resumed run verifies.
"""

import numpy as np
import pytest
import torch

import repro_torch.checkpoint as TC
from repro_torch._tensors import to_host
from repro_torch.kernels.mask_pack import ops as mask_ops
from repro_torch.npb import get_benchmark
from repro_torch.npb.common import verify_restart

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

NAMES = ["bt", "cg", "ep", "ft", "is", "lu", "mg", "sp"]


@pytest.fixture(scope="module")
def reports():
    out = {}
    for name in NAMES:
        bench = get_benchmark(name, device="cpu")
        out[name] = (bench, bench.scrutinize())
    return out


@pytest.mark.parametrize("name", NAMES)
def test_restart_with_reduced_checkpoint(reports, name, monkeypatch):
    """§IV-C: restoring only critical elements reproduces the output; every
    leaf goes through ``ops.pack`` once, and the program's leaves through
    one ``ops.unpack_group``."""
    bench, rep = reports[name]
    calls = {"pack": 0, "unpack_group": 0, "unpack": 0}
    for op in calls:
        real = getattr(mask_ops, op)

        def counted(*a, _op=op, _real=real, **k):
            calls[_op] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mask_ops, op, counted)
    assert verify_restart(bench, rep)
    assert calls == {"pack": len(rep.leaves), "unpack_group": 1,
                     "unpack": 0}


@pytest.mark.parametrize("name", NAMES)
def test_corrupting_uncritical_is_harmless(reports, name):
    bench, rep = reports[name]
    assert verify_restart(bench, rep, corrupt="uncritical")
    assert verify_restart(bench, rep, corrupt="uncritical", seed=1)


@pytest.mark.parametrize("name", ["bt", "sp", "lu", "mg", "ft", "ep", "cg"])
def test_corrupting_critical_breaks_verification(reports, name):
    bench, rep = reports[name]
    assert not verify_restart(bench, rep, corrupt="critical"), (
        f"{name}: corrupted critical elements but verification passed")


def test_integer_state_has_nothing_to_corrupt(reports):
    bench, rep = reports["is"]
    with pytest.raises(RuntimeError, match="no float critical elements"):
        verify_restart(bench, rep, corrupt="critical")
    with pytest.raises(ValueError, match="unknown corruption"):
        verify_restart(bench, rep, corrupt="everything")


@pytest.mark.parametrize("name", NAMES)
def test_scrutinized_save_restores_and_verifies(reports, name, tmp_path):
    """A scrutinized on-disk save and a restore into fresh tensors: the
    critical elements come back, the rest is 0, and the resumed run
    verifies against an uninterrupted one."""
    bench, rep = reports[name]
    state = bench.checkpoint_state()
    with TC.CheckpointManager([TC.Level(str(tmp_path), keep_n=1)],
                              scrutiny_fn=lambda s: rep, save_mode="device",
                              restore_mode="device", device="cpu") as mgr:
        mgr.save(1, state, block=True)
        saved = mgr.last_save_stats
        step, got = mgr.restore({k: torch.empty_like(v)
                                 for k, v in state.items()})
    assert step == 1
    full = sum(v.nbytes for v in state.values())
    assert saved["d2h_bytes"] <= full
    for leaf, v in state.items():
        mask = rep[leaf].mask.reshape(tuple(v.shape))
        want = np.where(mask, to_host(v), np.zeros((), to_host(v).dtype))
        assert to_host(got[leaf]).tobytes() == want.tobytes(), leaf
    assert bench.verify(bench.resume(got), bench.reference())


@pytest.mark.parametrize("name,saved", [("bt", 14.79), ("sp", 14.79),
                                        ("lu", 15.32), ("mg", 19.06),
                                        ("cg", 0.14), ("is", 0.0)])
def test_paper_storage_saved(reports, name, saved):
    """Table III under the paper's accounting (payload only), within 0.5
    points of the paper's 14.8 (BT, SP), 15.7 (LU), 19.1 (MG) and 0.1 (CG);
    IS saves nothing.  The values are the reference's (two decimals)."""
    _, rep = reports[name]
    assert round(100 * rep.paper_storage_saved, 2) == saved
    paper = {"bt": 14.8, "sp": 14.8, "lu": 15.7, "mg": 19.1, "cg": 0.1,
             "is": 0.0}[name]
    assert abs(100 * rep.paper_storage_saved - paper) < 0.5
