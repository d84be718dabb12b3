"""The hybrid cell (``granite-4.0-h-micro.hybrid-restore``) at a tiny size
on the CPU: its configuration file against the port's, the plain
reference (``reference/hybrid.py``) against itself and against the port,
planted faults, and the control."""

import numpy as np
import pytest
import torch

from portbench.tests import tiny
from portbench import bench, serving
from portbench.loops import hybrid_restore
from portbench.reference import hybrid

CELL = "granite-4.0-h-micro.hybrid-restore"


def _host(seed=11):
    a = tiny.arguments(CELL)
    w = a["workload"]
    config = dict(bench.config(w["config"]), **a["config_overrides"])
    traffic = dict(bench.traffic(w["traffic"]), **a["traffic_overrides"])
    return serving.Host(config, traffic, seed, torch.device("cpu"),
                        port_cfg=a["port_cfg"])


def test_the_configuration_file_is_the_ports():
    from repro_torch import get_config
    c = bench.config("granite-4.0-h-micro")
    cfg = get_config(c["port_arch"])
    m = cfg.mamba
    assert (m.n_heads, m.head_dim, m.d_state, m.n_groups, m.conv_width,
            m.chunk) == (c["mamba_n_heads"], c["mamba_d_head"],
                         c["mamba_d_state"], c["mamba_n_groups"],
                         c["mamba_d_conv"], c["mamba_chunk_size"])
    assert m.d_inner == c["mamba_expand"] * c["hidden_size"]
    assert (cfg.embed_mult, cfg.residual_mult, cfg.attn_scale,
            cfg.logits_div, cfg.norm_eps) == (
        c["embedding_multiplier"], c["residual_multiplier"],
        c["attention_multiplier"], c["logits_scaling"], c["rms_norm_eps"])
    assert cfg.rope is False and c["position_embedding_type"] == "nope"
    kinds = {"M": "mamba", "g": "attention"}
    assert [kinds[cfg.pattern_at(l)] for l in range(cfg.n_layers)] == \
        c["layer_types"]
    assert c["reduced"] == [] and not c["mamba_proj_bias"]
    serving.check_config(cfg, c)


@pytest.mark.parametrize("block", [1, 4, 7, 64])
def test_blocked_dual_form_matches_the_recurrence(block):
    g = torch.Generator().manual_seed(block)
    L, H, P, N = 23, 3, 4, 5
    x = torch.randn(L, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(L, H, generator=g))
    a = -torch.exp(torch.randn(H, generator=g))
    b, c = (torch.randn(L, H, N, generator=g) for _ in range(2))
    y, h = hybrid.ssm_blocked(x, dt, a, b, c, block)
    want_y, want_h = hybrid.ssm_steps(x, dt, a, b, c)
    # f32 round-off of another summation order
    assert torch.allclose(y, want_y, atol=1e-5 * want_y.abs().max(), rtol=0)
    assert torch.allclose(h, want_h, atol=1e-5 * want_h.abs().max(), rtol=0)


def test_layers_follow_the_programs_segments():
    from repro_torch.models.model import layer_kinds, plan_segments
    h = _host()
    got = [(s, i) for s, i, _ in hybrid.layers(h.config)]
    want = [(s, i) for s, (_, count) in
            enumerate(plan_segments(layer_kinds(h.cfg)))
            for i in range(count)]
    assert got == want


def test_port_prefill_then_decode_matches_the_reference():
    """Prefill 32 positions (four scan chunks of 8), then decode; the
    logits of the prefill's last position and of every decode step against
    the reference's whole forward.  Float32 both, summed in other orders
    over ten layers (the scan's chunks against the reference's blocks,
    the cached decode against a whole forward): 1e-4 of the largest
    |logit| (seen: 1.4e-5); bfloat16 anywhere reads ~1e-2."""
    h = _host()
    cfg, params = h.cfg, h.params
    from repro_torch import Engine
    eng = Engine(cfg, params, 64, device="cpu")
    prompts = torch.cat([h.prompts[:2], h.prompts[:2, :5]], 1)   # T = 37
    toks, _, logits = eng.generate({"tokens": prompts}, 6)
    for b in range(2):
        seq = torch.cat([prompts[b], toks[b, :-1]])
        want = hybrid.forward_logits(h.config, h.named, seq,
                                     prompts.shape[1] - 1)
        got = logits[:, b]
        assert torch.allclose(got, want, atol=1e-4 * float(want.abs().max()),
                              rtol=0), float((got - want).abs().max())


def recurrent_leaf_as_fill(mp):
    """The host expand hands every SSM state back as fill."""
    from repro_torch.checkpoint import manager
    real = manager.unpack_leaf

    def unpack(p, fill=0):
        a = real(p, fill=fill)
        return np.zeros_like(a) if p.name.endswith("/ssm") else a
    mp.setattr(manager, "unpack_leaf", unpack)


def restored_element_altered(mp):
    """The restore's K4 scatter hands back one KV element changed."""
    from repro_torch.checkpoint import manager
    real = manager.scatter_sharded_payload

    def scatter(*a, **k):
        t, moved = real(*a, **k)
        t.view(-1)[0] += 1
        return t, moved
    mp.setattr(manager, "scatter_sharded_payload", scatter)


def token_altered(mp):
    """Row 0's greedy token is one off where the engine picks it."""
    from repro_torch.serve import engine
    real = engine._next_tokens

    def next_tokens(logits):
        t = real(logits).clone()
        t[0] = (t[0] + 1) % logits.shape[-1]
        return t
    mp.setattr(engine, "_next_tokens", next_tokens)


FAULTS = [recurrent_leaf_as_fill, restored_element_altered, token_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch)
    res = tiny.run(CELL, seconds=0.2)
    assert res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_control_fails_logit_rms():
    """fp8 in the program's place (``control.py``) reads a relative logit
    distance that the float32 program does not come near, held at float32
    round-off's limit (``tiny.GAP_LIMIT``); ``served_gap`` is reported
    beside it."""
    from portbench.run import run_cell
    a = tiny.arguments(CELL)
    a["limits"] = dict(a["limits"], logit_rms=tiny.GAP_LIMIT)
    res = run_cell(CELL, 2 ** 31 + 17, 0.2, False, control=True, **a)
    assert res["correct"] is True, res["checks"]
    ctl, prog = res["control"]["control"], res["numbers"]
    assert ctl["logit_rms"] > tiny.GAP_LIMIT > 3 * prog["logit_rms"]
    assert ctl["restore_mismatch"] > 0
    assert prog["served_gap"] == 0 <= ctl["served_gap"]


def test_logits_kept_are_the_served_ones():
    """The loop's own serving keeps, for each token served, the logits
    that chose it: their argmax is the token."""
    from portbench.serving import Window
    import tempfile
    h = _host(seed=3)
    with tempfile.TemporaryDirectory() as d:
        kept = hybrid_restore.run(h, Window(0.05), d)
    served = h.served_tokens()
    assert kept["logits"].shape[:2] == served.shape
    assert torch.equal(kept["logits"].argmax(-1).to(served.dtype), served)


def test_leaf_kinds():
    assert hybrid_restore.kind("cache/seg1/u0/k") == "slots"
    assert hybrid_restore.kind("cache/seg0/u0/ssm") == "whole"
    assert hybrid_restore.kind("cache/seg0/u0/conv") == "whole"
    assert hybrid_restore.kind("pos") == "whole"
    with pytest.raises(ValueError):
        hybrid_restore.kind("cache/seg0/u0/h")
