"""The port's mask_pack ops (K1-K5, K8) on the CPU against the reference.

On the CPU every op runs its kernel's plain version; the same inputs, made
by numpy from a seed, go through ``repro.kernels.mask_pack.ops`` with
``use_kernel=False`` and, for finite f32 at a few tiles, through the raw
Pallas kernels in interpret mode.  Equality is on bytes.  The port's K2,
K4 and K5 take the mask as ``np.packbits`` words where the reference
takes a bool mask; ``_mask`` and ``_words`` make both from one numpy
mask.  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py`` (and by ``test_torch_rules.py``'s ``gpu`` case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.regions import mask_to_regions as reference_regions
from repro.kernels.mask_pack import kernel as RK
from repro.kernels.mask_pack import ops as R
from repro_torch._tensors import to_host
from repro_torch.convert import report_from_masks, state_from_numpy
from repro_torch.core.regions import mask_to_regions, regions_to_mask
from repro_torch.kernels.mask_pack import ops as T

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

DTYPES = ["float16", "bfloat16", "float32", "float64", "int32", "bool"]
DENSITIES = [0.0, 0.03, 0.5, 1.0]
SIZES = [513, 2053]


@pytest.fixture(autouse=True, scope="module")
def _x64():
    """f64 rows need genuine double precision on the reference side."""
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _pair(n, dtype, seed):
    """The same values as a jax array and as a CPU tensor."""
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        j = jnp.asarray(rng.rand(n) < 0.5)
    elif dtype == "int32":
        j = jnp.asarray(rng.randint(-2 ** 30, 2 ** 30, n), jnp.int32)
    else:
        j = jnp.asarray(rng.randn(n) * 10, getattr(jnp, dtype))
    return j, state_from_numpy({"x": np.asarray(j)}, "cpu")["x"]


def _mask(n, frac, seed):
    if frac in (0.0, 1.0):
        m = np.full(n, frac == 1.0)
    else:
        m = np.random.RandomState(seed).rand(n) < frac
    return m, jnp.asarray(m), torch.from_numpy(m)


def _words(m):
    """The port's form of a numpy bool mask: its ``np.packbits`` words."""
    return torch.from_numpy(np.packbits(m))


def _b(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return to_host(x).tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frac", DENSITIES)
@pytest.mark.parametrize("n", SIZES)
def test_pack_scatter_match_reference(dtype, frac, n):
    j, t = _pair(n, dtype, seed=n)
    m, jm, tm = _mask(n, frac, seed=n + 1)
    total = int(m.sum())
    p_r, c_r = R.pack(j, jm, use_kernel=False)
    p_t, c_t = T.pack(t, _words(m))
    assert _b(p_t) == _b(p_r) and _b(c_t) == _b(c_r)
    # the dense group payload (two leaves of one dtype)
    j2, t2 = _pair(n // 2 + 1, dtype, seed=n + 2)
    m2, jm2, tm2 = _mask(n // 2 + 1, frac, seed=n + 3)
    pay_r, cnt_r = R.pack_group([j, j2], [jm, jm2], [total, int(m2.sum())],
                                use_kernel=False)
    pay_t, cnt_t = T.pack_group([t, t2], [_words(m), _words(m2)],
                                [total, int(m2.sum())])
    assert _b(pay_t) == _b(pay_r) and _b(cnt_t) == _b(cnt_r)
    # the restore expand, with a zero and a non-zero fill
    for fill in (0, 3):
        o_r = R.mask_scatter(pay_r[:total], jm, n=n, fill=fill,
                             use_kernel=False)
        o_t = T.mask_scatter(pay_t[:total], _words(m), n=n, fill=fill)
        assert _b(o_t) == _b(o_r), fill


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("frac", DENSITIES)
@pytest.mark.parametrize("n", [1, 7, 8, 1023, 1025, 3001])
def test_threshold_bitpack_matches_reference(dtype, frac, n):
    rng = np.random.RandomState(n)
    m, _, _ = _mask(n, frac, seed=n + 5)
    mag = (np.abs(rng.randn(n)) * m).astype(dtype)
    w_r, c_r = R.threshold_bitpack(jnp.asarray(mag), 0.0, use_kernel=False)
    w_t, c_t = T.threshold_bitpack(torch.from_numpy(mag), 0.0)
    assert _b(w_t) == _b(w_r) == np.packbits(mag > 0).tobytes()
    assert _b(c_t) == _b(c_r)
    assert _b(T.expand_mask_bits(w_t, n=n)) == \
        _b(R.expand_mask_bits(w_r, n=n))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frac", DENSITIES)
@pytest.mark.parametrize("n", [513, 4099])
def test_delta_encode_matches_reference(dtype, frac, n):
    j, t = _pair(n, dtype, seed=n + 7)
    jb, tb = _pair(n, dtype, seed=n + 8)
    m, _, tm = _mask(n, frac, seed=n + 9)
    # base = curr except at the changed positions
    base_np = np.where(m, np.asarray(jb), np.asarray(j))
    base_t = torch.where(tm, tb, t)
    assert _b(base_t) == base_np.tobytes()
    assert _b(T.as_bytes(t)) == _b(R.as_bytes(j))
    i_r, p_r, d_r = R.delta_encode(j, jnp.asarray(base_np), chunk_bytes=64,
                                   use_kernel=False)
    i_t, p_t, d_t = T.delta_encode(t, base_t, chunk_bytes=64)
    assert i_t.tobytes() == i_r.tobytes()
    assert p_t.tobytes() == p_r.tobytes() and d_t == d_r


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32",
                                   "float64"])
@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
def test_uncritical_nonfinite_values(dtype, value):
    """An inf or NaN among the *uncritical* elements of a tile.

    The reference's Pallas ``_pack_kernel`` compacts with a 0/1 permutation
    matmul, so a single uncritical inf turns every output of its tile into
    NaN (0 * inf = NaN); ``_scatter_kernel`` has the same hazard for a
    non-finite critical value in its two-block window.  The port's kernels
    move bytes, so they are held against the reference's exact
    ``use_kernel=False`` path here."""
    n = 1500
    rng = np.random.RandomState(3)
    m = rng.rand(n) < 0.33
    vals = rng.randn(n) * 10
    vals[np.flatnonzero(~m)[:5]] = value
    j = jnp.asarray(vals, getattr(jnp, dtype))
    t = state_from_numpy({"x": np.asarray(j)}, "cpu")["x"]
    p_r, c_r = R.pack(j, jnp.asarray(m), use_kernel=False)
    p_t, c_t = T.pack(t, _words(m))
    assert _b(p_t) == _b(p_r) and _b(c_t) == _b(c_r)
    total = int(m.sum())
    pay_t, _ = T.pack_group([t], [_words(m)], [total])
    assert not torch.isnan(pay_t.float()).any()
    # the restore of a payload that itself holds non-finite values
    crit = np.asarray(j)[m].copy()
    crit[:3] = value
    o_r = R.mask_scatter(jnp.asarray(crit), jnp.asarray(m), n=n, fill=0,
                         use_kernel=False)
    o_t = T.mask_scatter(state_from_numpy({"p": crit}, "cpu")["p"],
                         _words(m), n=n, fill=0)
    assert _b(o_t) == _b(o_r)


# --------------------------------------------------------------------------
# the raw Pallas kernels (interpret mode, finite f32, at most 16 tiles)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("frac", DENSITIES)
def test_pallas_kernels_interpret_match_port(frac):
    rng = np.random.RandomState(int(frac * 100))
    n = 4 * 1024                          # 4 bitpack tiles, 8 pack tiles
    m = rng.rand(n) < frac if 0 < frac < 1 else np.full(n, frac == 1.0)
    vals = rng.randn(n).astype(np.float32)
    tv, tm = torch.from_numpy(vals), torch.from_numpy(m)
    # K1
    mag = (np.abs(vals) * m).astype(np.float32)
    w_k, c_k = RK.bitpack_blocks_kernel(jnp.asarray(mag), 0.0,
                                        interpret=True)
    w_t, c_t = T.threshold_bitpack(torch.from_numpy(mag), 0.0)
    assert _b(w_t) == _b(w_k) and _b(c_t) == _b(c_k)
    # K2
    p_k, pc_k = RK.pack_blocks_kernel(jnp.asarray(vals),
                                      jnp.asarray(m.astype(np.int8)),
                                      interpret=True)
    p_t, pc_t = T.pack(tv, _words(m))
    assert _b(p_t) == _b(p_k) and _b(pc_t) == _b(pc_k)
    # K4: payload + per-tile starts + mask → restored positions
    pay_t, _ = T.pack_group([tv], [_words(m)], [int(m.sum())])
    total = int(m.sum())
    npb = total // 512 + 2
    pad = np.zeros(npb * 512, np.float32)
    pad[:total] = vals[m]
    counts = m.reshape(-1, 512).sum(1).astype(np.int32)
    starts = np.cumsum(counts) - counts
    o_k = RK.scatter_blocks_kernel(jnp.asarray(pad.reshape(npb, 512)),
                                   jnp.asarray(starts.astype(np.int32)),
                                   jnp.asarray(m.astype(np.int8)), fill=2.0,
                                   interpret=True)
    o_t = T.mask_scatter(pay_t, _words(m), n=n, fill=2.0)
    assert _b(o_t) == _b(o_k)
    # K3: chunk flags over the payloads' bytes
    c8 = np.frombuffer(vals.tobytes(), np.uint8).copy()
    b8 = c8.copy()
    b8[np.flatnonzero(np.repeat(m, 4))[:64:7]] ^= 1
    f_k = RK.delta_blocks_kernel(jnp.asarray(c8), jnp.asarray(b8), 2048,
                                 interpret=True)
    idx_t, _, _ = T.delta_encode(torch.from_numpy(c8),
                                 torch.from_numpy(b8), chunk_bytes=2048)
    np.testing.assert_array_equal(np.flatnonzero(np.asarray(f_k)), idx_t)


def test_block_other_than_kernel_tile_is_cpu_only():
    """The plain versions take any tile size (the reference's ``block``
    argument); the ops accept it on the CPU and give the reference's
    result."""
    n = 700
    j, t = _pair(n, "float32", seed=1)
    m, jm, tm = _mask(n, 0.5, seed=2)
    p_r, c_r = R.pack(j, jm, block=128, use_kernel=False)
    p_t, c_t = T.pack(t, _words(m), block=128)
    assert _b(p_t) == _b(p_r) and _b(c_t) == _b(c_r)


def test_negative_zero_keeps_its_bytes():
    """The port moves bytes: a critical -0.0 stays -0.0.  (The reference's
    ``pack_blocks_ref`` places values by scatter-add onto zeros, which
    turns a critical -0.0 into +0.0; its Pallas kernel is not exact
    either, so this is checked on the port alone.)"""
    x = torch.arange(1.0, 1025.0)
    x[5] = -0.0
    m = torch.zeros(1024, dtype=torch.bool)
    m[:300] = True
    w = T.mask_to_words(m)
    p, _ = T.pack(x, w)
    pay, _ = T.pack_group([x], [w], [300])
    assert torch.signbit(p[0, 5]) and torch.signbit(pay[5])
    assert torch.signbit(T.mask_scatter(pay, w, n=1024)[5])


# --------------------------------------------------------------------------
# the mask as np.packbits words: what K2 and K4 read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("frac", DENSITIES)
@pytest.mark.parametrize("n", [1, 7, 8, 513, 4099])
def test_mask_to_words_inverts_expand_mask_bits(n, frac):
    m, jm, tm = _mask(n, frac, seed=n + 41)
    w = T.mask_to_words(tm)
    assert w.dtype == torch.uint8 and _b(w) == np.packbits(m).tobytes()
    assert torch.equal(T.expand_mask_bits(w, n=n), tm)
    assert torch.equal(T.mask_to_words(T.expand_mask_bits(w, n=n)), w)
    assert _b(T.expand_mask_bits(w, n=n)) == \
        _b(R.expand_mask_bits(jnp.asarray(np.packbits(m)), n=n))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32"])
@pytest.mark.parametrize("n", [1, 7, 513, 4099])
def test_set_tail_bits_change_nothing(dtype, n):
    """Bits past N in the last byte of the words are no element's: set,
    they change no count, payload or restored value (the kernels mask
    them off; the plain versions drop them)."""
    j, t = _pair(n, dtype, seed=n + 51)
    m, jm, _ = _mask(n, 0.5, seed=n + 52)
    m[0] = True                       # a payload for the restore
    jm = jnp.asarray(m)
    total = int(m.sum())
    w = _words(m)
    planted = w.clone()
    planted[-1] |= (1 << (8 - n % 8)) - 1
    assert not torch.equal(planted, w)
    p_r, c_r = R.pack(j, jm, use_kernel=False)
    pay_r, _ = R.pack_group([j], [jm], [total], use_kernel=False)
    o_r = R.mask_scatter(pay_r, jm, n=n, fill=3, use_kernel=False)
    for words in (w, planted):
        p_t, c_t = T.pack(t, words)
        pay_t, cg_t = T.pack_group([t], [words], [total])
        assert _b(p_t) == _b(p_r) and _b(c_t) == _b(c_r) == _b(cg_t)
        assert _b(pay_t) == _b(pay_r)
        assert _b(T.mask_scatter(pay_t, words, n=n, fill=3)) == _b(o_r)


def test_ops_take_words_not_a_bool_mask():
    x = torch.ones(20)
    m = torch.ones(20, dtype=torch.bool)
    p = torch.ones(1, 512)
    for call in (lambda: T.pack(x, m),
                 lambda: T.pack_group([x], [m], [20]),
                 lambda: T.mask_scatter(x, m, n=20),
                 lambda: T.unpack(p, m, n=20),
                 lambda: T.unpack_group([p, p], [T.mask_to_words(m), m],
                                        [20, 20]),
                 lambda: T.pack(x, T.mask_to_words(m)[:2])):
        with pytest.raises(ValueError, match="np.packbits words"):
            call()


def _stand_in_kernels(monkeypatch, calls):
    """The card's route on CPU tensors: ``ops`` takes its kernel branch and
    the kernels are stand-ins that check they got the words, unpack them
    with numpy and run the bool-mask plain versions."""
    from repro_torch.kernels.mask_pack import kernel as K
    from repro_torch.kernels.mask_pack import ref

    def bits(words, n):
        assert words.dtype == torch.uint8 and words.shape == ((n + 7) // 8,)
        return torch.from_numpy(_UNPACKBITS(words.numpy(), count=n)
                                .astype(bool))

    def pack_into(flat, words, dst, *, tiled):
        calls.append("pack")
        m = bits(words, flat.shape[0])
        if tiled:
            p, c = ref.pack_blocks_ref(flat, m)
            dst.copy_(p.reshape(-1))
            return c
        p, c = ref.pack_payload_ref(flat, m, dst.shape[0])
        dst.copy_(p)
        return c

    def mask_scatter(payload, words, n, fill):
        calls.append("mask_scatter")
        return ref.mask_scatter_ref(payload, bits(words, n), fill)

    def unpack_group(packs, words, ns, fill):
        calls.append("unpack_group")
        return [ref.unpack_blocks_ref(p.view(-1, 512), bits(w, n),
                                      ref.fill_tensor(fill, p.dtype, "cpu"))
                for p, w, n in zip(packs, words, ns)]

    def regions_words(regions, n):
        calls.append("regions_words")
        assert regions.dtype == torch.int64 and regions.shape[1:] == (2,)
        return torch.from_numpy(np.packbits(regions_to_mask(
            regions.numpy(), n)))

    monkeypatch.setattr(T, "_on_card", lambda *ts: True)
    monkeypatch.setattr(K, "pack_into", pack_into)
    monkeypatch.setattr(K, "mask_scatter", mask_scatter)
    monkeypatch.setattr(K, "unpack_group", unpack_group)
    monkeypatch.setattr(K, "regions_words", regions_words)
    monkeypatch.setattr(ref, "expand_mask_bits", _widened)


# the stand-ins' own, kept from tests that make np.unpackbits raise
_UNPACKBITS = np.unpackbits


def _widened(*args, **kwargs):
    raise AssertionError("a mask was widened to one byte per element")


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_save_and_device_restore_never_widen_the_mask(tmp_path, monkeypatch,
                                                      route):
    """The device save packs each leaf from the report's resident words
    (``device_words``) and the device restore scatters under the stored
    words (``scatter_sharded_payload``): neither calls
    ``expand_mask_bits`` or builds a report's byte mask.  ``kernel`` runs
    the ops' card branch with stand-in kernels."""
    from repro_torch import CheckpointManager, Level, scrutinize
    from repro_torch.core import criticality

    rng = np.random.RandomState(61)
    state = {"w": torch.from_numpy(rng.randn(3001).astype(np.float32)),
             "h": torch.from_numpy(rng.randn(700).astype(np.float32))
             .to(torch.bfloat16),
             "step": torch.tensor(3, dtype=torch.int32)}
    sel = torch.from_numpy(rng.rand(3001) < 0.3)
    rep = scrutinize(lambda s: (s["w"] * sel).sum()
                     + s["h"][:500].float().sum(), state, device="cpu")

    def run(d):
        with CheckpointManager([Level(str(d), keep_n=1)],
                               scrutiny_fn=lambda s: rep, save_mode="device",
                               restore_mode="device",
                               pipeline_engine="device", device="cpu") as mgr:
            mgr.save(1, state, block=True)
            _, got = mgr.restore({k: torch.zeros_like(v)
                                  for k, v in state.items()})
            assert mgr.last_restore_stats["device_leaves"] == 2
        return got

    want = run(tmp_path / "before")
    calls = []
    if route == "kernel":
        _stand_in_kernels(monkeypatch, calls)
    monkeypatch.setattr(T, "expand_mask_bits", _widened)
    monkeypatch.setattr(criticality.DeviceLeafReport, "device_mask",
                        _widened)
    monkeypatch.setattr(criticality.LeafReport, "device_mask", _widened)
    got = run(tmp_path / "after")
    for k in state:
        assert _b(got[k]) == _b(want[k]), k
    assert _b(got["w"]) == _b(torch.where(sel, state["w"], 0.0))
    if route == "kernel":
        # "h" is stored as one run: K8 writes its words
        assert calls == ["pack", "pack", "regions_words", "mask_scatter",
                         "mask_scatter"]


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_npb_restart_never_widens_the_mask(monkeypatch, route):
    """The §IV-C restart (``verify_restart``, ``corrupt=None``) packs each
    leaf from the report's resident words and rebuilds the program's
    leaves with one ``unpack_group`` on the same words: no
    ``device_mask`` and no ``expand_mask_bits``.  ``kernel`` runs the ops'
    card branch with stand-in kernels (K2 a launch per leaf, K5 one)."""
    from repro_torch.core import criticality
    from repro_torch.npb import get_benchmark
    from repro_torch.npb.common import verify_restart

    bench = get_benchmark("lu", device="cpu")
    rep = bench.scrutinize()
    calls = []
    if route == "kernel":
        _stand_in_kernels(monkeypatch, calls)
    monkeypatch.setattr(T, "expand_mask_bits", _widened)
    monkeypatch.setattr(criticality.DeviceLeafReport, "device_mask",
                        _widened)
    monkeypatch.setattr(criticality.LeafReport, "device_mask", _widened)
    assert verify_restart(bench, rep)
    if route == "kernel":
        assert calls == ["pack"] * len(rep.leaves) + ["unpack_group"]


# --------------------------------------------------------------------------
# K8: the words of a stored region table
# --------------------------------------------------------------------------

def _runs(*pairs):
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def _fragmented(n, seed):
    """Thousands of runs: a random mask's, every third one split into two
    adjacent runs (which ``mask_to_regions`` never writes)."""
    runs = []
    for i, (a, b) in enumerate(mask_to_regions(
            np.random.RandomState(seed).rand(n) < 0.5)):
        cut = (a + b) // 2
        runs += [(a, cut), (cut, b)] if i % 3 == 0 and cut > a else [(a, b)]
    return _runs(*runs)


REGION_CASES = {
    "empty": (_runs(), 100),
    "inside_one_byte": (_runs((2, 5)), 100),
    "mid_byte_ends": (_runs((3, 21), (35, 64), (65, 72), (75, 77)), 100),
    "whole_bytes": (_runs((8, 16), (24, 40)), 64),
    "adjacent": (_runs((0, 3), (3, 11), (11, 16), (16, 17)), 40),
    "ends_at_n": (_runs((5, 90), (93, 101)), 101),
    "n_not_a_multiple_of_8": (_runs((0, 1), (6, 13)), 13),
    "fragmented": (_fragmented(20011, 0), 20011),
    "fragmented_large": (_fragmented(200003, 1), 200003),
}


@pytest.mark.parametrize("case", sorted(REGION_CASES))
def test_regions_words_match_packbits(case):
    """K8's plain version gives ``np.packbits(regions_to_mask(r, n))``
    byte for byte."""
    r, n = REGION_CASES[case]
    if case.startswith("fragmented"):
        assert len(r) >= 1000
    got = T.regions_words(torch.from_numpy(r), n=n)
    assert got.dtype == torch.uint8 and got.shape == ((n + 7) // 8,)
    assert _b(got) == np.packbits(regions_to_mask(r, n)).tobytes()



@given(st.lists(st.booleans(), min_size=0, max_size=2000))
@settings(max_examples=200, deadline=None)
def test_region_table_words_match_packbits(bits):
    """K8's plain version writes the words of the reference's region table
    (``repro.core.regions.mask_to_regions``) from the runs alone, byte for
    byte ``np.packbits`` of the mask they encode."""
    mask = np.array(bits, dtype=bool)
    words = T.regions_words(torch.from_numpy(reference_regions(mask)),
                            n=mask.size)
    assert _b(words) == np.packbits(mask).tobytes()

def _no_host_mask(*args, **kwargs):
    raise AssertionError("a mask was rebuilt on the host")


@pytest.fixture
def obs_on():
    """The registry counts only while obs is on."""
    from repro_torch import obs
    obs.reset()
    obs.enable()
    yield obs.get_obs()
    obs.disable()
    obs.reset()


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_device_restore_takes_the_words_from_the_stored_aux(
        tmp_path, monkeypatch, obs_on, route):
    """A device-mode restore of a leaf stored as a region table and one
    stored as a bitmap: the table's words come from K8 (its plain version
    on the CPU), the bitmap's aux is sent as the words, and neither goes
    through ``regions_to_mask`` or ``np.unpackbits``.  The tensors are the
    host restore's, bit for bit; ``mask_words`` and the registry count
    each way."""
    from repro_torch import CheckpointManager, Level
    from repro_torch.checkpoint import packing
    from repro_torch.checkpoint.store import read_manifest
    from repro_torch.core import regions

    rng = np.random.RandomState(27)
    n = 4099
    np_state = {"kv": rng.randn(n).astype(np.float32),
                "w": rng.randn(n).astype(np.float32)}
    kv = np.zeros(n, bool)
    kv[:1003] = kv[2005:3001] = True
    masks = {"kv": kv, "w": rng.rand(n) < 0.3}
    state = state_from_numpy(np_state, "cpu")
    like = {k: torch.ones_like(v) for k, v in state.items()}
    with CheckpointManager([Level(str(tmp_path), keep_n=1)],
                           scrutiny_fn=lambda s: report_from_masks(masks, s),
                           device="cpu") as mgr:
        mgr.save(1, state, block=True)
        enc = {e["name"]: e["encoding"]
               for e in read_manifest(str(tmp_path), 1)["leaves"]}
        assert enc == {"kv": "regions", "w": "bitmap"}
        _, want = mgr.restore(like, fill=7, mode="host")
        calls = []
        if route == "kernel":
            _stand_in_kernels(monkeypatch, calls)
        for mod in (packing, regions):
            monkeypatch.setattr(mod, "regions_to_mask", _no_host_mask)
        monkeypatch.setattr(np, "unpackbits", _no_host_mask)
        before = mgr.obs.registry.to_dict()["counters"]
        _, got = mgr.restore(like, fill=7, mode="device")
        after = mgr.obs.registry.to_dict()["counters"]
        stats = mgr.last_restore_stats
    for k, m in masks.items():
        assert _b(got[k]) == _b(want[k]), k
        assert _b(got[k]) == np.where(m, np_state[k], 7).astype(
            np.float32).tobytes(), k
    if route == "kernel":
        assert calls == ["regions_words", "mask_scatter", "mask_scatter"]
    assert stats["device_leaves"] == 2
    assert stats["mask_words"] == {"regions_on_card": 1, "bitmap_aux": 1}
    for key in ("restore.words_from_regions", "restore.words_from_bitmap"):
        assert after[key] - before.get(key, 0) == 1, key
    # the table crossed (2 runs, 16 B each), not the words
    assert stats["h2d_bytes"] == 4 * int(sum(m.sum() for m in masks.values())
                                         ) + 2 * 16 + (n + 7) // 8


@pytest.mark.parametrize("table", [_runs((5, 3)), _runs((0, 9), (8, 12)),
                                   _runs((3, 9), (0, 2)), _runs((90, 101))],
                         ids=["inverted", "overlapping", "unsorted",
                              "past_n"])
def test_device_restore_refuses_a_malformed_region_table(tmp_path, table):
    """A region table read back from a step is checked on the host before
    K8 takes it (K8 binary-searches the runs' stops)."""
    from repro_torch.checkpoint import manager
    from repro_torch.checkpoint.packing import PackedLeaf

    leaf = PackedLeaf(name="x", shape=(100,), dtype="float32",
                      encoding="regions", aux=table.tobytes(),
                      num_regions=len(table), payload=b"", checksum=0)
    with pytest.raises(ValueError, match="region table"):
        manager._leaf_words(leaf, 100, "cpu")


# --------------------------------------------------------------------------
# K5: unpack, the inverse of the tiled pack
# --------------------------------------------------------------------------

UNPACK_DTYPES = ["float16", "bfloat16", "float32", "float64", "complex128",
                 "int32", "bool"]
SPECIALS = [np.inf, -np.inf, np.nan, -0.0]


def _packed_tiles(n, dtype, m, seed):
    """(nb, 512) tiles given directly, as the reference array and the
    port's tensor, with ±inf, NaN and -0.0 among the critical values (each
    tile's leading slots) of the float dtypes; ``pack_blocks_ref`` itself
    would turn -0.0 into +0.0."""
    rng = np.random.RandomState(seed)
    nb = -(-n // 512)
    if dtype == "bool":
        vals = rng.rand(nb, 512) < 0.5
    elif dtype == "int32":
        vals = rng.randint(-2 ** 30, 2 ** 30, (nb, 512)).astype(np.int32)
    else:
        vals = rng.randn(nb, 512) * 10
        if dtype == "complex128":
            vals = vals + 1j * rng.randn(nb, 512)
        counts = np.bincount(np.arange(n) // 512, weights=m,
                             minlength=nb).astype(int)
        for t in np.flatnonzero(counts):
            k = rng.randint(len(SPECIALS))
            vals[t, :min(2, counts[t])] = SPECIALS[k]
    j = jnp.asarray(vals, getattr(jnp, dtype))
    return j, state_from_numpy({"p": np.asarray(j)}, "cpu")["p"]


@pytest.mark.parametrize("dtype", UNPACK_DTYPES)
@pytest.mark.parametrize("frac", DENSITIES)
@pytest.mark.parametrize("n", [1, 511, 513, (1 << 20) + 7])
def test_unpack_matches_reference(dtype, frac, n):
    m, jm, _ = _mask(n, frac, seed=n + 31)
    j, t = _packed_tiles(n, dtype, m, seed=n + 32)
    w = _words(m)
    for fill in (0, 3):
        o_r = R.unpack(j, jm, n=n, fill=fill, use_kernel=False)
        o_t = T.unpack(t, w, n=n, fill=fill)
        assert _b(o_t) == _b(o_r), fill
    # and the round trip through the port's own tiled pack
    o_t = T.unpack(t, w, n=n)
    p_t, _ = T.pack(o_t, w)
    assert _b(T.unpack(p_t, w, n=n)) == _b(o_t)


def test_unpack_refuses_a_short_pack():
    m = torch.ones(600, dtype=torch.bool)
    w = T.mask_to_words(m)
    with pytest.raises(ValueError, match="does not hold"):
        T.unpack(torch.zeros(1, 512), w, n=600)
    with pytest.raises(ValueError, match="590 elements"):
        T.unpack(torch.zeros(2, 512), w, n=590)


# unpack_group: leaves of mixed widths in one list (int32, f64,
# complex128, bf16, bool), at n = 1, 511 and 513
GROUP_DTYPES = ["int32", "float64", "complex128", "bfloat16", "bool"]


@pytest.mark.parametrize("n", [1, 511, 513])
@pytest.mark.parametrize("frac", DENSITIES)
def test_unpack_group_matches_reference_and_each_leaf(n, frac):
    """One ``unpack_group`` over leaves of every width gives, leaf by leaf,
    the bytes of the reference's unpack and of the port's one-leaf
    ``unpack``, at fill 0 and 3, with the words' tail bits set or not."""
    leaves = []
    for k, dtype in enumerate(GROUP_DTYPES):
        size = max(1, n - k)             # ragged ends that differ by leaf
        m, jm, _ = _mask(size, frac, seed=size + 41 + k)
        j, t = _packed_tiles(size, dtype, m, seed=size + 42 + k)
        w = _words(m)
        tail = w.clone()
        if size % 8:
            tail[-1] |= (1 << (8 - size % 8)) - 1
        leaves.append((size, jm, j, t, w, tail))
    for fill in (0, 3):
        for form in (4, 5):              # words, tail bits set
            got = T.unpack_group([x[3] for x in leaves],
                                 [x[form] for x in leaves],
                                 [x[0] for x in leaves], fill=fill)
            assert len(got) == len(leaves)
            for (size, jm, j, t, w, _), o in zip(leaves, got):
                assert o.shape == (size,) and o.dtype == t.dtype
                assert _b(o) == _b(R.unpack(j, jm, n=size, fill=fill,
                                            use_kernel=False))
                assert _b(o) == _b(T.unpack(t, w, n=size, fill=fill))


def test_unpack_group_edges():
    """An empty list gives an empty list; an empty leaf gives an empty
    tensor beside the others; lengths must agree."""
    assert T.unpack_group([], [], []) == []
    m = np.random.RandomState(5).rand(700) < 0.4
    vals = torch.arange(1024, dtype=torch.float32).view(2, 512)
    got = T.unpack_group([torch.zeros(0, 512), vals],
                         [torch.zeros(0, dtype=torch.uint8), _words(m)],
                         [0, 700])
    assert got[0].shape == (0,) and got[1].shape == (700,)
    assert _b(got[1]) == _b(T.unpack(vals, _words(m), n=700))
    with pytest.raises(ValueError, match="length mismatch"):
        T.unpack_group([vals], [_words(m)], [700, 1])


def test_reference_unpack_kernel_poisons_a_tile():
    """The reference's K5 (``_unpack_kernel``) unpacks with the transposed
    0/1 permutation matmul, so one +inf among the *critical* values of a
    tile turns every other critical element of that tile into NaN (0 * inf
    = NaN); its ``use_kernel=False`` path and the port's plain version keep
    every value.  (ROADMAP Queue 3; the port's CUDA K5 moves bytes.)"""
    n = 1024
    rng = np.random.RandomState(0)
    m = rng.rand(n) < 0.3
    vals = rng.randn(n).astype(np.float32)
    vals[np.flatnonzero(m)[0]] = np.inf
    packed, _ = R.pack_blocks_ref(jnp.asarray(vals), jnp.asarray(m))
    poisoned = np.asarray(RK.unpack_blocks_kernel(
        packed, jnp.asarray(m.astype(np.int8)), interpret=True))
    tile0 = int(m[:512].sum())
    assert np.isnan(poisoned[:512]).sum() == tile0 - 1
    assert not np.isnan(poisoned[512:]).any()
    clean = np.asarray(R.unpack(packed, jnp.asarray(m), n=n,
                                use_kernel=False))
    ours = to_host(T.unpack(torch.from_numpy(np.array(packed)), _words(m),
                            n=n))
    want = np.where(m, vals, np.float32(0))
    assert clean.tobytes() == ours.tobytes() == want.tobytes()
