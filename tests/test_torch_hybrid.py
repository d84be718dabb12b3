"""The port's hybrid architecture (granite-4.0-h-micro: Mamba-2 layers and
attention without positions, a port-only configuration) at its reduced
size on the CPU, float32, seeded random weights:

- the Mamba-2 mixer's chunked SSD scan against its recurrence, one
  position at a time, over chunk sizes that leave a remainder, with one
  group and with two (f32 round-off of another summation order: 1e-5 of
  the largest output, 1e-5 of the largest state);
- prefill then decode against the port's own full forward, and the
  configuration's defaults leaving every other architecture's arithmetic
  as it was;
- scrutiny of ``resume_fn`` on the hybrid state: the KV slots below the
  probe critical, the SSM state and the conv history whole;
- a device-mode save, three deltas and a device restore give the critical
  elements back bit for bit;
- ``superseded_bytes``, the chain walk's bytes patched over by a later
  delta, against a count by hand, and its counter; the spans ``ssm.scan``
  and ``ssm.step``;
- the port-only names are not the reference's, and each builds an engine.

Participation (``core/taint.py``) on the Mamba-2 decode step: every aten
op has an exact rule (the conv is an einsum over the history), and the SSM
state and the conv history come out whole.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import all_arch_names as r_all_arch_names
from repro_torch import (CheckpointManager, Engine, Level, ScrutinyConfig,
                         _tree, get_config, obs, scrutinize)
from repro_torch.checkpoint import load_checkpoint_raw
from repro_torch.configs import all_arch_names, port_only_arch_names
from repro_torch.convert import report_from_masks
from repro_torch.core import participation
from repro_torch.models import full_logits, init_params
from repro_torch.models import mamba2

torch.set_num_threads(1)

ARCH = "granite-4.0-h-micro"


def _cfg():
    return get_config(ARCH).reduced()


@pytest.fixture
def obs_on():
    obs.reset()
    obs.enable()
    yield obs.get_obs()
    obs.disable()
    obs.reset()


def _params(cfg, seed=0):
    """The port's init, with the norms' offsets, the biases, D and dt_bias
    drawn too, so that every term of the arithmetic is exercised."""
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, device="cpu")
    named, treedef = _tree.flatten_with_names(params)
    out = []
    for name, t in named:
        last = name.split("/")[-1]
        if last in ("scale", "conv_bias", "D", "dt_bias"):
            t = t + 0.3 * torch.randn(t.shape, generator=gen)
        out.append(t)
    return _tree.unflatten(treedef, out)


def _map(fn, tree):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [fn(t) for _, t in named])


def _recurrence(x, dt, a, b, c):
    """The SSM one position at a time: x (B, T, G, R, P) → y, last h."""
    h = x.new_zeros(x.shape[:1] + x.shape[2:] + b.shape[-1:])
    ys = []
    for t in range(x.shape[1]):
        h = h * torch.exp(dt[:, t] * a)[..., None, None] \
            + (x[:, t] * dt[:, t][..., None])[..., None] \
            * b[:, t][:, :, None, None, :]
        ys.append(torch.einsum("bgrpn,bgn->bgrp", h, c[:, t]))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk,T", [(8, 21), (8, 8), (5, 23), (64, 23),
                                     (1, 6)])
def test_chunked_scan_matches_the_recurrence(groups, chunk, T):
    g = torch.Generator().manual_seed(chunk * 100 + T + groups)
    B, R, P, N = 2, 3, 4, 5
    x = torch.randn(B, T, groups, R, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, T, groups, R,
                                                  generator=g))
    a = -torch.exp(torch.randn(groups, R, generator=g))
    b = torch.randn(B, T, groups, N, generator=g)
    c = torch.randn(B, T, groups, N, generator=g)
    y, h = mamba2.ssd_scan(x, dt, a, b, c, chunk)
    want_y, want_h = _recurrence(x, dt, a, b, c)
    assert torch.allclose(y, want_y, atol=1e-5 * want_y.abs().max(), rtol=0)
    assert torch.allclose(h, want_h, atol=1e-5 * want_h.abs().max(), rtol=0)


def test_layer_pattern_puts_attention_at_5_15_25_35():
    cfg = get_config(ARCH)
    kinds = [cfg.pattern_at(l) for l in range(cfg.n_layers)]
    assert [l for l, k in enumerate(kinds) if k == "g"] == [5, 15, 25, 35]
    assert kinds.count("M") == 36
    small = _cfg()
    assert small.n_layers == 10 and small.pattern_at(5) == "g"
    assert small.mamba.chunk == 8 and small.norm_eps == 1e-5


def test_prefill_then_decode_matches_the_full_forward():
    """Prompt of 21 positions (two chunks of 8 and a remainder), then six
    greedy steps; the logits of every step against the train path's
    forward over the whole sequence (f32: 1e-5 of |logits|)."""
    cfg = _cfg()
    params = _params(cfg)
    eng = Engine(cfg, params, max_len=64, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 21),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    toks, _, logits = eng.generate({"tokens": prompt}, 7)
    seq = torch.cat([prompt, toks[:, :-1]], 1)
    want = full_logits(cfg, params, {"tokens": seq})[:, 20:]
    got = logits.permute(1, 0, 2)
    assert torch.allclose(got, want, atol=1e-5 * float(want.abs().max()),
                          rtol=0)


def test_ssm_spans(obs_on):
    """With tracing on, a prefill spans each Mamba-2 layer's scan
    (``ssm.scan``: batch, tokens, chunk) and each decode step each layer's
    update (``ssm.step``: batch)."""
    cfg = _cfg()
    eng = Engine(cfg, _params(cfg), max_len=32, device="cpu")
    n_mamba = [cfg.pattern_at(l) for l in range(cfg.n_layers)].count("M")
    mark = obs_on.buffer.mark()
    state = eng.start({"tokens": torch.zeros((2, 13), dtype=torch.int32)})
    for _ in range(2):
        state, _ = eng.step(state)
    ev = [e for e in obs_on.buffer.events_since(mark) if e["ph"] == "X"]

    def args(name, keys):
        return [{k: e["args"][k] for k in keys} for e in ev
                if e["name"] == name]
    assert args("ssm.scan", ("batch", "tokens", "chunk")) == \
        [{"batch": 2, "tokens": 13, "chunk": 8}] * n_mamba
    assert args("ssm.step", ("batch",)) == [{"batch": 2}] * (2 * n_mamba)


def test_other_architectures_keep_the_defaults():
    for name in all_arch_names():
        cfg = get_config(name)
        assert (cfg.mamba, cfg.rope, cfg.attn_scale, cfg.embed_mult,
                cfg.residual_mult, cfg.logits_div, cfg.norm_eps) == \
            (None, True, None, 1.0, 1.0, 1.0, 1e-6), name
        assert "mamba" not in dataclasses.asdict(cfg)


def _state(cfg, seed=0, decode=3, batch=2, T=13):
    params = _params(cfg, seed)
    eng = Engine(cfg, params, max_len=32, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (batch, T),
                           generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32)
    state = eng.start({"tokens": prompt})
    for _ in range(decode):
        state, _ = eng.step(state)
    return eng, state


def _by_kind(name, t, crit):
    """The mask by kind: KV slots < crit, everything else whole."""
    if name.split("/")[-1] in ("k", "v"):
        slots = torch.arange(t.shape[2]) < crit
        return slots.view(1, 1, -1, 1, 1).expand(t.shape)
    return torch.ones(t.shape, dtype=torch.bool)


def test_scrutiny_finds_the_mask_by_kind():
    cfg = _cfg()
    eng, state = _state(cfg)
    crit = int(state["pos"]) + 2
    probe = dict(state, pos=torch.tensor(crit, dtype=torch.int32))
    rep = scrutinize(eng.resume_fn(2), probe,
                     config=ScrutinyConfig(probes=2), device="cpu")
    named = _tree.flatten_with_names(state)[0]
    kinds = {n.split("/")[-1] for n, _ in named if n.startswith("cache/")}
    assert kinds == {"k", "v", "ssm", "conv"}
    for name, t in named:
        want = _by_kind(name, t, crit).reshape(-1).numpy()
        assert np.array_equal(rep[name].mask, want), name


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_bf16_scrutiny_finds_the_recurrent_state_whole(seed):
    """In bfloat16 compute, the conv history and the SSM state come out
    whole: the decode's conv runs in float64, where no conv output lands
    on silu's stationary point (computed in bfloat16, 1 to 8 history
    elements of this size got an exactly zero derivative on each of these
    seeds)."""
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    eng, state = _state(cfg, seed=seed, decode=2, batch=4, T=24)
    crit = int(state["pos"]) + 2
    probe = dict(state, pos=torch.tensor(crit, dtype=torch.int32))
    rep = scrutinize(eng.resume_fn(2), probe,
                     config=ScrutinyConfig(probes=2), device="cpu")
    for name, _ in _tree.flatten_with_names(state)[0]:
        if name.split("/")[-1] in ("ssm", "conv"):
            assert rep[name].all_critical, name


def test_a_c_channel_at_zero_leaves_the_ssm_state_whole():
    """A C channel that is exactly 0 in every step (its projection column
    and its conv bias zeroed: silu(0) = 0) leaves its column of the SSM
    state out of every logit, and with it the history of the B channel
    that feeds that column: a scrutiny of the logits alone finds both
    unread.  ``resume_fn`` also returns the Mamba-2 state after its steps,
    which every later step reads, so the scrutiny finds it whole."""
    cfg = _cfg()
    m = cfg.mamba
    n0 = 3
    params = _params(cfg)
    mixer = params["segments"]["seg0"]["u0"]["mixer"]
    mixer["w_in"][0, :, 2 * m.d_inner + m.d_state + n0] = 0
    mixer["conv_bias"][0, m.d_inner + m.d_state + n0] = 0
    eng = Engine(cfg, params, max_len=32, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 13),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    state = eng.start({"tokens": prompt})
    state, _ = eng.step(state)
    probe = dict(state, pos=state["pos"] + 2)
    fn = eng.resume_fn(2)
    sc = ScrutinyConfig(probes=2)
    logits_only = scrutinize(lambda s: {"logits": fn(s)["logits"]}, probe,
                             config=sc, device="cpu")
    rep = scrutinize(fn, probe, config=sc, device="cpu")
    ssm, conv = "cache/seg0/u0/ssm", "cache/seg0/u0/conv"
    shape = tuple(state["cache"]["seg0"]["u0"]["ssm"].shape)
    unread = ~logits_only[ssm].mask.reshape(shape)
    assert unread[0, ..., n0].all() and unread.sum() == unread[0, ..., n0].size
    hist = ~logits_only[conv].mask.reshape(
        state["cache"]["seg0"]["u0"]["conv"].shape)
    assert hist[0, :, :, m.d_inner + n0].all()
    assert rep[ssm].all_critical and rep[conv].all_critical


def test_participation_attributes_the_mixer_decode_exactly():
    """Every aten op of one Mamba-2 decode step has an exact taint rule
    (none falls to any→all: the conv is an einsum over the history), and
    participation finds the SSM state and the conv history whole."""
    from repro_torch.core.criticality import traced_step
    from repro_torch.core.taint import classify_rule
    cfg = _cfg()
    eng, state = _state(cfg, decode=1)
    p = _tree.flatten_with_names(eng._compute)[0]
    layer = {n.split("/", 4)[-1]: t[0] for n, t in p
             if n.startswith("segments/seg0/u0/mixer/")}
    layer = {"norm": {"scale": layer.pop("norm/scale")}, **layer}
    cache = {k: state["cache"]["seg0"]["u0"][k][0] for k in ("ssm", "conv")}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))

    def step(c):
        return mamba2.mamba2_decode(cfg, layer, x, c)

    ts = traced_step(step, cache, device="cpu")
    rules = {str(n.target): classify_rule(n) for n in ts.gm.graph.nodes
             if n.op == "call_function"}
    assert "fallback" not in rules.values(), rules
    assert not any("convolution" in t for t in rules)
    rep = participation(step, cache, device="cpu")
    for name in ("ssm", "conv"):
        assert rep[name].mask.all(), name


def test_device_save_three_deltas_and_restore(tmp_path):
    cfg = _cfg()
    eng, state = _state(cfg, seed=1)
    crit = int(state["pos"]) + 8
    probe = dict(state, pos=torch.tensor(crit, dtype=torch.int32))
    rep = scrutinize(eng.resume_fn(2), probe,
                     config=ScrutinyConfig(probes=2), device="cpu")
    root = str(tmp_path)
    with CheckpointManager([Level(root, keep_n=5, max_chain=3)],
                           scrutiny_fn=lambda s: rep, save_mode="device",
                           restore_mode="device", device="cpu") as mgr:
        mgr.save(0, state, block=True)
        for step in range(1, 4):
            for _ in range(2):
                state, _ = eng.step(state)
            mgr.save(step, state, block=True)
        like = _map(torch.ones_like, state)
        step, out = mgr.restore(like)
        stats = mgr.last_restore_stats
    assert step == 3 and stats["device_leaves"] > 0
    got = dict(_tree.flatten_with_names(out)[0])
    for name, t in _tree.flatten_with_names(state)[0]:
        m = _by_kind(name, t, crit)
        want = torch.where(m, t, torch.zeros_like(t))
        assert got[name].numpy().tobytes() == want.numpy().tobytes(), name
    # every delta carries the recurrent state whole
    assert 0 < stats["superseded_bytes"] < stats["bytes_read"]


def test_superseded_bytes_by_hand(tmp_path, obs_on):
    """A chain of a base and three deltas in 64-byte chunks.  ``rew`` (64
    f32, all critical) is rewritten each step: each delta patches its 256
    bytes over the last one's.  ``app`` (8 rows of 16 f32, rows < 4
    critical) gets a row appended past its stored rows: no delta carries
    it.  ``kv`` (the same, all 8 rows critical) gets row 4 + step
    appended inside its stored rows: each delta patches one 64-byte chunk
    of zeros the base read."""
    rng = np.random.RandomState(0)
    app = np.zeros((8, 16), np.float32)
    app[:4] = rng.randn(4, 16)
    state = {"rew": torch.from_numpy(rng.randn(64).astype(np.float32)),
             "app": torch.from_numpy(app.copy()),
             "kv": torch.from_numpy(app.copy())}
    rows4 = np.zeros((8, 16), bool)
    rows4[:4] = True
    masks = {"rew": np.ones(64, bool), "app": rows4.reshape(-1),
             "kv": np.ones(128, bool)}
    rep = report_from_masks(masks, state)
    root = str(tmp_path)
    with CheckpointManager([Level(root, keep_n=5, max_chain=3)],
                           scrutiny_fn=lambda s: rep, device="cpu",
                           delta_chunk_bytes=64) as mgr:
        mgr.save(0, state, block=True)
        for step in range(1, 4):
            state = {"rew": torch.from_numpy(
                rng.randn(64).astype(np.float32)),
                "app": state["app"].clone(), "kv": state["kv"].clone()}
            state["app"][3 + step] = 1.0
            state["kv"][3 + step] = 1.0
            mgr.save(step, state, block=True)
        mgr.restore(_map(torch.zeros_like, state))
        stats = mgr.last_restore_stats
    base = 256 + 4 * 64 + 8 * 64
    assert stats["bytes_read"] == base + 3 * (256 + 64)
    assert stats["superseded_bytes"] == 3 * 256 + 0 + 3 * 64
    reg = obs_on.registry
    assert reg.counter("restore.superseded_bytes").value == \
        stats["superseded_bytes"]
    assert reg.counter("restore.bytes_read").value == stats["bytes_read"]
    io = {}
    load_checkpoint_raw(root, 3, io_stats=io)
    assert io["superseded_bytes"] == stats["superseded_bytes"]
    io = {}
    load_checkpoint_raw(root, 0, io_stats=io)
    assert io["superseded_bytes"] == 0


def test_port_only_names_are_not_the_references():
    only = port_only_arch_names()
    assert only == [ARCH]
    assert not set(only) & set(all_arch_names())
    assert not set(only) & set(r_all_arch_names())
    assert all_arch_names() == r_all_arch_names()


@pytest.mark.parametrize("name", port_only_arch_names())
def test_port_only_archs_build_an_engine(name):
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, params, 16, device="cpu")
    toks, state, _ = eng.generate(
        {"tokens": torch.zeros((2, 5), dtype=torch.int32)}, 3)
    assert toks.shape == (2, 3) and int(state["pos"]) == 7
