"""The plain reference against the port at a tiny size on the CPU, and the
plain store reader against the port's own."""

import pytest
import torch

from portbench.tests import tiny
from portbench import serving
from portbench.reference import model as ref_model
from portbench.reference import store as ref_store


def _host(cell, seed=11):
    from portbench import bench
    a = tiny.arguments(cell)
    w = a["workload"]
    config = dict(bench.config(w["config"]), **a["config_overrides"])
    traffic = dict(bench.traffic(w["traffic"]), **a["traffic_overrides"])
    return serving.Host(config, traffic, seed, torch.device("cpu"),
                        port_cfg=a["port_cfg"])


@pytest.mark.parametrize("cell", ["phi4-mini-3.8b.rescrutiny",
                                  "olmoe-1b-7b.rescrutiny"])
def test_reference_matches_the_ports_forward(cell):
    from repro_torch.models import full_logits
    h = _host(cell)
    toks = h.prompts[:2, :24]
    with torch.no_grad():
        want = full_logits(h.cfg, h.params, {"tokens": toks}).float()
        for b in range(2):
            got = ref_model.forward_logits(h.config, h.named, toks[b], 0)
            assert torch.allclose(got, want[b], atol=2e-5, rtol=1e-4), \
                float((got - want[b]).abs().max())


@pytest.mark.parametrize("cell", ["phi4-mini-3.8b.rescrutiny",
                                  "olmoe-1b-7b.rescrutiny"])
def test_served_tokens_sit_on_the_references_best(cell):
    h = _host(cell)
    h.start()
    h.decode(6)
    with torch.no_grad():
        gaps = ref_model.served_gaps(h.config, h.named, h.prompts,
                                     h.served_tokens())
        wrong = h.served_tokens().clone()
        wrong[:, 1:] = (wrong[:, 1:] + 1) % h.cfg.vocab
        bad = ref_model.served_gaps(h.config, h.named, h.prompts, wrong)
    assert gaps.shape == (4, 7)
    assert float(gaps.max()) < tiny.GAP_LIMIT
    assert float(bad[:, 1:].min()) > 0


def test_control_separates_from_the_program():
    """fp8 in the program's place reads a gap that the float32 program
    does not come near: the control's judged number fails the limit."""
    h = _host("phi4-mini-3.8b.rescrutiny", seed=5)
    h.start()
    h.decode(12)
    with torch.no_grad():
        prog = float(ref_model.served_gaps(h.config, h.named, h.prompts,
                                           h.served_tokens()).max())
        ctl = float(ref_model.served_gaps(h.config, h.named, h.prompts,
                                          h.served_tokens(), "fp8").max())
    assert ctl > tiny.GAP_LIMIT > 3 * prog


def test_fp8_round_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.0])
    assert torch.equal(ref_model.fp8_round(x)[[0, 2, 3, 4]],
                       x[[0, 2, 3, 4]])
    assert ref_model.fp8_round(x)[1] in (1.0, 1.125)


def test_plain_reader_walks_a_delta_chain(tmp_path):
    from repro_torch import CheckpointManager, Level
    from repro_torch.checkpoint import load_checkpoint_raw
    h = _host("phi4-mini-3.8b.snapshot")
    h.start()
    rep = h.scrutinize(h.pos + 8)
    root = str(tmp_path)
    with CheckpointManager([Level(root, keep_n=5, max_chain=3)],
                           scrutiny_fn=lambda s: rep, device="cpu") as mgr:
        for step in range(3):
            mgr.save(step, h.state, block=True)
            h.decode(2)
    assert ref_store.chain_of(root, 2) == [0, 1, 2]
    got = ref_store.read_step(root, 2)
    _, want, _ = load_checkpoint_raw(root, 2)
    assert set(got) == set(want)
    for name, (shape, dtype, mask, payload) in got.items():
        assert payload == want[name].payload
        assert tuple(shape) == tuple(want[name].shape)
    assert ref_store.step_bytes(root, [0, 1, 2]) > 0
