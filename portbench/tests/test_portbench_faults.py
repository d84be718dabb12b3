"""A whole run at a tiny size with the timed path broken underneath:
``correct`` comes out false for each fault the cell can have, and true
without one.  (One card: there is no exchange between chips to leave
out.)"""

import pytest
import torch

from portbench.tests import tiny


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def state_unchanged(mp):
    """Every decode step hands its state back as it came."""
    from repro_torch.serve import engine

    def decode(self, state, tokens=None):
        logits = torch.zeros((state["tokens"].shape[0], self.cfg.vocab))
        return logits, state
    mp.setattr(engine.Engine, "decode", decode)


def half_batch(mp):
    """The decode runs the first half of the batch and hands its rows to
    the other half."""
    from repro_torch.models import model
    real = model.decode_step

    def decode_step(cfg, params, cache, tokens, pos):
        h = tokens.shape[0] // 2
        logits, new = real(cfg, params, _tree_map(lambda c: c[:, :h], cache),
                           tokens[:h], pos)
        return (torch.cat([logits, logits]),
                _tree_map(lambda c: torch.cat([c, c], 1), new))
    mp.setattr(model, "decode_step", decode_step)


def token_altered(mp):
    """Row 0's greedy token is one off where the engine picks it."""
    from repro_torch.serve import engine
    real = engine._next_tokens

    def next_tokens(logits):
        t = real(logits).clone()
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t
    mp.setattr(engine, "_next_tokens", next_tokens)


def mask_bit_flipped(mp):
    """K1's words lose their first critical bit."""
    from repro_torch.kernels.mask_pack import ops
    real = ops.threshold_bitpack

    def threshold_bitpack(mag, tol):
        words, counts = real(mag, tol)
        words = words.clone()
        words[0] ^= 0x80
        return words, counts
    mp.setattr(ops, "threshold_bitpack", threshold_bitpack)


def durable_byte_flipped(mp):
    """Each delta step's first stored byte is flipped once it lands."""
    import os
    from repro_torch.checkpoint import manager
    real = manager.CheckpointManager._run_delta

    def run_delta(self, *a, **k):
        path = real(self, *a, **k)
        with open(os.path.join(path, "shard_0.bin"), "r+b") as f:
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 0xFF]))
        return path
    mp.setattr(manager.CheckpointManager, "_run_delta", run_delta)


def restored_element_altered(mp):
    """The restore's scatter hands back one element changed."""
    from repro_torch.checkpoint import manager
    real = manager.scatter_sharded_payload

    def scatter(*a, **k):
        t, moved = real(*a, **k)
        t.view(-1)[0] += 1
        return t, moved
    mp.setattr(manager, "scatter_sharded_payload", scatter)


def restore_hands_back_its_input(mp):
    """restore() returns the tensors it was handed for their shapes."""
    from repro_torch.checkpoint import manager
    real = manager.CheckpointManager.restore

    def restore(self, like, *a, **k):
        step, _ = real(self, like, *a, **k)
        return step, like
    mp.setattr(manager.CheckpointManager, "restore", restore)


DECODE = [state_unchanged, half_batch, token_altered]
CASES = (
    [("phi4-mini-3.8b.rescrutiny", f) for f in DECODE + [mask_bit_flipped]]
    + [("olmoe-1b-7b.rescrutiny", token_altered)]
    + [("phi4-mini-3.8b.snapshot", f)
       for f in DECODE + [durable_byte_flipped]]
    + [("phi4-mini-3.8b.restore", f)
       for f in (restored_element_altered, restore_hands_back_its_input)])


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny.run(cell, seconds=0.3)
    assert res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["phi4-mini-3.8b.rescrutiny",
                                  "olmoe-1b-7b.rescrutiny",
                                  "phi4-mini-3.8b.snapshot",
                                  "phi4-mini-3.8b.restore"])
def test_the_control_fails_the_cell(cell):
    """The control in the program's place (``control.py``) fails one of the
    cell's numbers, where the program passes them all."""
    from portbench.run import run_cell
    res = run_cell(cell, 2 ** 31 + 17, 0.3, False, control=True,
                   **tiny.arguments(cell))
    assert res["correct"] is True, res["checks"]
    assert any(v > res["checks"][k]["limit"]
               for k, v in res["control"]["control"].items()
               if k in res["checks"]), res["control"]
