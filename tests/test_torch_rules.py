"""Rules of the PyTorch port: what it imports, where it runs, and that a
kernel wrapper never quietly runs its plain version.

- ``src/repro_torch/**``, ``scripts/*.py`` and ``chip_smoke.py`` import
  neither ``jax`` nor the reference package ``repro``.
- Entry points (the NPB programs' ``get_benchmark`` too) run on the card
  unless ``device="cpu"`` is asked for: with no card they raise, naming
  that option; a CPU tensor handed to an entry point on the card raises.
- A CUDA kernel wrapper refuses a tensor that is not on the card, and a
  missing compiler is an error, not a fallback, for every kernel library.
- ``gpu`` cases run the kernels against their plain versions on the card
  and skip where there is none.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import (CheckpointManager, Engine, Level, get_config,
                         scrutinize)
from repro_torch.checkpoint import restore_state
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.lru_scan import kernel as LK
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.kernels.lru_scan.ref import (FWD_CHUNK,
                                              lru_scan_chunked_ref,
                                              lru_scan_ref)
from repro_torch.kernels.mask_pack import kernel as K
from repro_torch.kernels.mask_pack import ops, ref
from repro_torch.models import init_params
from repro_torch.npb import get_benchmark
from repro_torch.npb.common import verify_restart

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "scripts").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_port_files_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"criticality.py", "manager.py", "kernel.py", "_build.py",
            "attention.py", "model.py", "engine.py", "chip_smoke.py",
            "report.py", "common.py", "bt.py", "sp.py", "lu.py", "mg.py",
            "cg.py", "ep.py", "ft.py", "is_.py"} <= names
    assert ROOT / "src" / "repro_torch" / "npb" / "common.py" in PORT_FILES
    assert ROOT / "src" / "repro_torch" / "core" / "report.py" in PORT_FILES


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_scrutinize_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        scrutinize(lambda s: s["x"].sum(), {"x": torch.ones(3)})
    rep = scrutinize(lambda s: s["x"].sum(), {"x": torch.ones(3)},
                     device="cpu")
    assert rep["x"].mask.all()


def test_manager_defaults_to_the_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CheckpointManager([Level(str(tmp_path))])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CheckpointManager([Level(str(tmp_path))], device="cuda")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        restore_state({"x": torch.ones(2)}, {"x": np.ones(2, np.float32)})


def test_engine_defaults_to_the_card(no_card):
    cfg = get_config("phi4-mini-3.8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(cfg, params, 16)
    assert Engine(cfg, params, 16, device="cpu").device.type == "cpu"


def test_cpu_tensor_on_a_card_entry_point_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="tensor on cpu"):
        scrutinize(lambda s: s["x"].sum(), {"x": torch.ones(3)})
    mgr = CheckpointManager([Level(str(tmp_path))])
    try:
        assert mgr.device.type == "cuda"
        with pytest.raises(RuntimeError, match="tensor on cpu"):
            mgr.save(1, {"x": torch.ones(3)})
    finally:
        mgr.close()


@pytest.mark.parametrize("opt", ["save_mode", "restore_mode",
                                 "pipeline_engine"])
def test_host_modes_refused_on_the_card(monkeypatch, tmp_path, opt):
    """On the card no option moves the pack or the expand to the CPU."""
    CheckpointManager([Level(str(tmp_path))], device="cpu",
                      **{opt: "host"}).close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=f'{opt}="host"'):
        CheckpointManager([Level(str(tmp_path))], **{opt: "host"})
    mgr = CheckpointManager([Level(str(tmp_path))])
    try:
        with pytest.raises(ValueError, match='restore mode="host"'):
            mgr.restore({"x": torch.ones(3)}, mode="host")
    finally:
        mgr.close()


def test_coordinated_manager_defaults_to_the_card(no_card, tmp_path):
    """``CoordinatedCheckpointManager()`` with no card raises, as every
    entry point; with ``device="cpu"`` it saves and restores."""
    from repro_torch.checkpoint import CoordinatedCheckpointManager
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CoordinatedCheckpointManager([Level(str(tmp_path))])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CoordinatedCheckpointManager([Level(str(tmp_path))],
                                     force_coordinated=True)
    with CoordinatedCheckpointManager([Level(str(tmp_path))],
                                      force_coordinated=True,
                                      device="cpu") as mgr:
        mgr.save(1, {"x": torch.arange(5.0)}, block=True)
        step, got = mgr.restore({"x": torch.zeros(5)})
    assert step == 1 and torch.equal(got["x"], torch.arange(5.0))


@pytest.mark.parametrize("opt", ["save_mode", "restore_mode",
                                 "pipeline_engine"])
def test_coordinated_host_modes_refused_on_the_card(monkeypatch, tmp_path,
                                                    opt):
    """The coordinator refuses host engines on the card as the manager
    does, and a CPU tensor handed to it there raises."""
    from repro_torch.checkpoint import CoordinatedCheckpointManager
    CoordinatedCheckpointManager([Level(str(tmp_path))], device="cpu",
                                 force_coordinated=True,
                                 **{opt: "host"}).close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for force in (True, False):
        with pytest.raises(ValueError, match=f'{opt}="host"'):
            CoordinatedCheckpointManager([Level(str(tmp_path))],
                                         force_coordinated=force,
                                         **{opt: "host"})
    mgr = CoordinatedCheckpointManager([Level(str(tmp_path))],
                                       force_coordinated=True)
    try:
        assert mgr._engine == "device"
        with pytest.raises(ValueError, match='restore mode="host"'):
            mgr.restore({"x": torch.ones(3)}, mode="host")
        with pytest.raises(RuntimeError, match="tensor on cpu"):
            mgr.save(1, {"x": torch.ones(3)})
    finally:
        mgr.close()


def _fa_call():
    q = torch.ones(1, 4, 2, 8)
    return FK.flash_attention(q, q[:, :, :1], q[:, :, :1], scale=1.0,
                              causal=True, window=None, attn_cap=None)


def _fa_backward_call():
    q = torch.ones(1, 4, 2, 8)
    kv = q[:, :, :1].contiguous()
    return FK.flash_attention_backward(q, kv, kv, q, torch.zeros(1, 2, 4), q,
                                       scale=1.0, causal=True, window=None,
                                       attn_cap=None)


@pytest.mark.parametrize("mod,call", [
    (K, lambda: K.bitpack(torch.ones(8), 0.0)),
    (K, lambda: K.pack_into(torch.ones(8), torch.ones(1, dtype=torch.uint8),
                            torch.zeros(8), tiled=True)),
    (K, lambda: K.delta_flags(torch.zeros(8, dtype=torch.uint8),
                              torch.zeros(8, dtype=torch.uint8), 2048)),
    (K, lambda: K.mask_scatter(torch.ones(8), torch.ones(1, dtype=torch.uint8),
                               8, torch.tensor(0.0))),
    (K, lambda: K.unpack_group([torch.ones(512)],
                               [torch.ones(1, dtype=torch.uint8)], [8])),
    (K, lambda: K.regions_words(torch.zeros(1, 2, dtype=torch.int64), 8)),
    (FK, _fa_call),
    (FK, _fa_backward_call),
    (LK, lambda: LK.lru_scan(torch.ones(1, 3, 2), torch.ones(1, 3, 2))),
    (LK, lambda: LK.lru_scan_backward(torch.ones(1, 3, 2), torch.ones(1, 3, 2),
                                      None, torch.ones(1, 3, 2))),
], ids=["bitpack", "pack", "delta_flags", "mask_scatter", "unpack",
        "regions_words", "flash_attention",
        "flash_attention_backward", "lru_scan", "lru_scan_backward"])
def test_kernel_wrappers_refuse_host_tensors(mod, call):
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        call()
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda t: ops.threshold_bitpack(t),
    lambda t: ops.pack(t, torch.ones(1, dtype=torch.uint8, device="meta")),
    lambda t: ops.mask_scatter(t, torch.ones(1, dtype=torch.uint8,
                                             device="meta"), n=8),
    lambda t: ops.delta_encode(t, t),
    lambda t: ops.unpack(t.reshape(1, 8), torch.ones(1, dtype=torch.uint8,
                                                     device="meta"),
                         n=8, block=8),
    lambda t: ops.regions_words(t.to(torch.int64).reshape(-1, 2), n=8),
], ids=["threshold_bitpack", "pack", "mask_scatter", "delta_encode",
        "unpack", "regions_words"])
def test_ops_raise_on_other_devices(call):
    with pytest.raises(RuntimeError, match="mask_pack"):
        call(torch.ones(8, device="meta"))


def test_ops_refuse_mixed_devices():
    with pytest.raises(RuntimeError, match="not a mix"):
        ops.pack(torch.ones(8), torch.ones(1, dtype=torch.uint8,
                                           device="meta"))


def test_missing_compiler_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    for mod in (K, FK, LK):
        monkeypatch.setattr(mod.LIBRARY, "_lib", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            mod.load_library()


def test_plain_versions_count_no_launches():
    K.reset_launches()
    FK.reset_launches()
    LK.reset_launches()
    x = torch.randn(3000)
    m = torch.rand(3000) < 0.3
    ops.threshold_bitpack(x.abs())
    w = ops.mask_to_words(m)
    ops.pack_group([x], [w], [int(m.sum())])
    ops.mask_scatter(x[m], w, n=3000)
    ops.delta_encode(x, x)
    ops.unpack(ops.pack(x, w)[0], w, n=3000)
    ops.unpack_group([ops.pack(x, w)[0], ops.pack(x[:7], w[:1])[0]],
                     [w, w[:1]], [3000, 7])
    ops.regions_words(torch.tensor([[3, 700], [900, 2999]]), n=3000)
    q = x[:2400].reshape(1, 20, 4, 30)
    live = q.clone().requires_grad_()
    fa_ops.flash_attention(live, q[:, :, :2], q[:, :, :2], window=5,
                           attn_cap=30.0).sum().backward()
    a = x[:2400].reshape(2, 30, 40).sigmoid().requires_grad_()
    lru_ops.lru_scan(a, x[:2400].reshape(2, 30, 40)).sum().backward()
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
    assert FK.LAUNCHES == dict.fromkeys(FK.LAUNCHES, 0)
    assert LK.LAUNCHES == dict.fromkeys(LK.LAUNCHES, 0)


def test_npb_path_on_the_cpu_counts_no_launches():
    """The NPB path (scrutiny, the §IV-C restart through pack and unpack)
    on CPU tensors runs the plain versions only."""
    K.reset_launches()
    bench = get_benchmark("mg", device="cpu")
    assert verify_restart(bench, bench.scrutinize())
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)
    assert set(K.LAUNCHES) == {"threshold_bitpack", "pack", "delta_flags",
                               "mask_scatter", "unpack", "regions_words"}


def test_flash_attention_raises_on_other_devices():
    q = torch.ones(1, 4, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="not a mix"):
        fa_ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="not a mix"):
        lru_ops.lru_scan(q[0], q[0])


def test_package_exports():
    for name in ("scrutinize", "ScrutinyConfig", "CheckpointManager",
                 "CoordinatedCheckpointManager", "Level", "save_checkpoint",
                 "load_checkpoint", "restore_state", "Engine", "get_config"):
        assert hasattr(repro_torch, name)


def test_checkpoint_exports_match_reference():
    """``repro_torch.checkpoint`` exports every name ``repro.checkpoint``
    does (read from the reference's source, not imported: this file runs
    on the card's machine, which has no jax)."""
    import repro_torch.checkpoint as TC
    tree = ast.parse((ROOT / "src" / "repro" / "checkpoint" /
                      "__init__.py").read_text())
    (ref_all,) = [ast.literal_eval(n.value) for n in tree.body
                  if isinstance(n, ast.Assign)
                  and n.targets[0].id == "__all__"]
    assert set(ref_all) <= set(TC.__all__)
    for name in ref_all:
        assert hasattr(TC, name), name


def test_new_modules_are_in_the_import_check():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("distributed/collective.py", "distributed/sharding.py",
                "checkpoint/levels.py", "checkpoint/coordinator.py",
                "testing/faults.py", "obs/drift.py", "obs/report.py"):
        assert f"src/repro_torch/{mod}" in names, mod


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_bytes(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64,
                                   torch.int32, torch.bool])
def test_kernels_match_plain_versions_on_the_card(card, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    n = 5003
    m = torch.rand(n, generator=g, device=card) < 0.3
    x = (torch.rand(n, generator=g, device=card) < 0.5 if dtype == torch.bool
         else (torch.randn(n, generator=g, device=card) * 100).to(dtype))
    total = int(m.sum())
    w = ops.mask_to_words(m)
    pay, _ = ops.pack_group([x], [w], [total])
    assert _same_bytes(pay, ref.pack_payload_ref(x, m, total)[0])
    p, c = ops.pack(x, w)
    p_r, c_r = ref.pack_blocks_ref(x, m)
    assert _same_bytes(p, p_r) and _same_bytes(c, c_r)
    assert _same_bytes(ops.mask_scatter(pay, w, n=n, fill=1),
                       ref.mask_scatter_ref(pay, m, 1))
    c8 = ops.as_bytes(x)
    b8 = c8.clone()
    b8[::997] ^= 1
    assert _same_bytes(K.delta_flags(c8, b8, 2048),
                       ref.delta_flags_ref(c8, b8, 2048))
    if dtype in (torch.float32, torch.float64):
        w, wc = ops.threshold_bitpack(x.abs() * m)
        w_r, wc_r = ref.bitpack_ref(x.abs() * m, 0.0)
        assert _same_bytes(w, w_r) and _same_bytes(wc, wc_r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64,
                                   torch.complex128, torch.int32, torch.bool])
@pytest.mark.parametrize("frac", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, 511, 513, 70001])
def test_pack_and_scatter_from_words_on_the_card(card, dtype, frac, n):
    """K2 (tiled and dense) and K4 read ``np.packbits`` words: bit for bit
    against the plain versions, also with the tail bits set, with words at
    an odd address and with the dense payload at an odd element offset of
    its group."""
    g = torch.Generator(device=card).manual_seed(n)
    m = torch.rand(n, generator=g, device=card) < frac
    if dtype == torch.bool:
        x = torch.rand(n, generator=g, device=card) < 0.5
    elif dtype == torch.int32:
        x = torch.randint(-2 ** 30, 2 ** 30, (n,), generator=g, device=card,
                          dtype=dtype)
    else:
        x = torch.randn(n, generator=g, device=card,
                        dtype=torch.complex128 if dtype.is_complex
                        else torch.float32).to(dtype)
    total = int(m.sum())
    w = ops.mask_to_words(m)
    planted = w.clone()
    planted[-1] |= (1 << (8 - n % 8)) - 1 if n % 8 else 0
    odd = torch.empty(w.shape[0] + 1, dtype=torch.uint8, device=card)[1:]
    odd.copy_(planted)
    head = x[:3]
    head_w = ops.mask_to_words(torch.ones_like(head, dtype=torch.bool))
    p_r, c_r = ref.pack_blocks_ref(x, m)
    pay_r = ref.pack_payload_ref(x, m, total)[0]
    for words in (w, planted, odd):
        before = K.LAUNCHES["pack"]
        p, c = ops.pack(x, words)
        assert _same_bytes(p, p_r) and _same_bytes(c, c_r)
        pay, cg = ops.pack_group([head, x], [head_w, words],
                                 [head.shape[0], total])
        # a group leaf with no critical element launches no K2
        assert K.LAUNCHES["pack"] == before + (3 if total else 2)
        assert _same_bytes(pay[head.shape[0]:], pay_r)
        assert _same_bytes(cg[-c_r.shape[0]:], c_r)
        if total:
            for fill in (0, 1):
                assert _same_bytes(
                    ops.mask_scatter(pay[head.shape[0]:], words, n=n,
                                     fill=fill),
                    ref.mask_scatter_ref(pay_r, m, fill))


def _card_region_table(case):
    """(table, n): ``cell``, a (32, 4, 2048, 8, 128) cache leaf of the
    restore cell with one run a (layer, batch) row, its first 1027
    positions; ``fragmented``, thousands of runs of every length, some
    adjacent; ``edges``, runs that start and end mid-byte, end at n, and
    n not a multiple of 8."""
    if case == "cell":
        n, rows = 32 * 4 * 2048 * 8 * 128, 32 * 4
        starts = np.arange(rows, dtype=np.int64) * (n // rows)
        return np.stack([starts, starts + 1027 * 8 * 128], 1), n
    if case == "fragmented":
        n = 3_000_017
        rng = np.random.RandomState(8)
        cuts = np.unique(rng.randint(0, n, 40_000))
        r = np.stack([cuts[:-1], cuts[1:]], 1)
        keep = rng.rand(len(r)) < 0.6          # touching runs stay adjacent
        return np.ascontiguousarray(r[keep]).astype(np.int64), n
    return np.array([[0, 1], [3, 5], [6, 17], [17, 120], [128, 129],
                     [131, 1000], [1003, 1005]], np.int64), 1005


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cell", "fragmented", "edges"])
def test_regions_words_match_plain_version_on_the_card(card, case):
    """K8 against its plain version and ``np.packbits(regions_to_mask)``,
    byte for byte, one launch, its words 16-byte aligned."""
    from repro_torch.core.regions import regions_to_mask
    r, n = _card_region_table(case)
    table = torch.from_numpy(r).to(card)
    before = K.LAUNCHES["regions_words"]
    w = ops.regions_words(table, n=n)
    torch.cuda.synchronize()
    assert K.LAUNCHES["regions_words"] == before + 1
    assert w.shape == ((n + 7) // 8,) and w.data_ptr() % 16 == 0
    assert torch.equal(w, ref.regions_words_ref(table, n))
    assert w.cpu().numpy().tobytes() == \
        np.packbits(regions_to_mask(r, n)).tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64,
                                   torch.complex128, torch.int32, torch.bool])
@pytest.mark.parametrize("n", [1, 511, 513, 5003])
def test_unpack_matches_plain_version_on_the_card(card, dtype, n):
    """K5 bit for bit against ``unpack_blocks_ref``, ±inf, NaN and -0.0
    among the packed values, fill 0 and 1, the ragged last tile, from the
    mask's words as packed, with the tail bits set and at an odd address,
    and the packed tiles at an odd element address; one launch each."""
    g = torch.Generator(device=card).manual_seed(n)
    m = torch.rand(n, generator=g, device=card) < 0.3
    nb = -(-n // 512)
    if dtype == torch.bool:
        p = torch.rand((nb, 512), generator=g, device=card) < 0.5
    else:
        p = (torch.randn((nb, 512), generator=g, device=card,
                         dtype=torch.float64) * 100).to(dtype)
        if dtype != torch.int32:
            p[:, :4] = torch.tensor([float("inf"), float("-inf"),
                                     float("nan"), -0.0]).to(dtype)
    w = ops.mask_to_words(m)
    planted = w.clone()
    planted[-1] |= (1 << (8 - n % 8)) - 1 if n % 8 else 0
    odd = torch.empty(w.shape[0] + 1, dtype=torch.uint8, device=card)[1:]
    odd.copy_(planted)
    p_odd = torch.empty(p.numel() + 1, dtype=dtype, device=card)[1:]
    p_odd.copy_(p.reshape(-1))
    for words, packed in ((w, p), (planted, p), (odd, p_odd.view(nb, 512))):
        for fill in (0, 1):
            before = K.LAUNCHES["unpack"]
            got = ops.unpack(packed, words, n=n, fill=fill)
            assert K.LAUNCHES["unpack"] == before + 1
            assert _same_bytes(got, ref.unpack_blocks_ref(p, m, fill))


@pytest.mark.gpu
def test_unpack_group_matches_plain_version_on_the_card(card):
    """K5 over 70 leaves of every width (f16, bf16, f32, f64, complex128,
    int32, bool) at ragged n: three launches (32 leaves a launch), each
    leaf's bytes those of the plain version and of its own ``unpack``."""
    g = torch.Generator(device=card).manual_seed(70)
    dtypes = [torch.float16, torch.bfloat16, torch.float32, torch.float64,
              torch.complex128, torch.int32, torch.bool]
    packs, words, ns, masks = [], [], [], []
    for k in range(70):
        dt, n = dtypes[k % len(dtypes)], 1 + 97 * k
        nb = -(-n // 512)
        m = torch.rand(n, generator=g, device=card) < 0.3
        p = (torch.rand((nb, 512), generator=g, device=card) < 0.5
             if dt == torch.bool else
             (torch.randn((nb, 512), generator=g, device=card,
                          dtype=torch.float64) * 100).to(dt))
        packs.append(p)
        words.append(ops.mask_to_words(m))
        ns.append(n)
        masks.append(m)
    before = K.LAUNCHES["unpack"]
    got = ops.unpack_group(packs, words, ns, fill=1)
    assert K.LAUNCHES["unpack"] == before + 3
    for p, w, n, m, o in zip(packs, words, ns, masks, got):
        assert _same_bytes(o, ref.unpack_blocks_ref(p, m, 1))
        assert _same_bytes(o, ops.unpack(p, w, n=n, fill=1))


@pytest.mark.gpu
def test_npb_restart_on_the_card(card):
    """BT's §IV-C restart on the card goes through K1, K2 (a launch per
    leaf) and K5 (one launch for the program)."""
    K.reset_launches()
    bench = get_benchmark("bt")
    assert bench.device.type == "cuda"
    rep = bench.scrutinize()
    assert rep["u"].uncritical == 1500
    assert verify_restart(bench, rep)
    assert not verify_restart(bench, rep, corrupt="critical")
    assert K.LAUNCHES["threshold_bitpack"] > 0
    assert K.LAUNCHES["pack"] == len(rep.leaves) == 2
    assert K.LAUNCHES["unpack"] == 1


# (B, Tq, Tk, H, K, D, Dv, window, causal, cap): the serving slice's shapes
# at small T, ragged T, non-causal, D = 256 and Dv != D; then two edges of
# the bf16 tensor-core kernels: D and Dv off the 16-column grid with a
# window, and MQA at D = 256 with a window shorter than T
FA_CARD_CASES = [
    (2, 128, 128, 8, 2, 128, 128, None, True, None),
    (1, 17, 17, 4, 4, 64, 64, None, True, None),
    (1, 200, 200, 4, 1, 64, 64, None, False, None),
    (2, 100, 100, 2, 2, 256, 256, 16, True, 50.0),
    (1, 70, 70, 6, 3, 96, 32, None, True, None),
    (1, 77, 77, 4, 2, 72, 40, 20, True, None),
    (2, 300, 300, 8, 1, 256, 256, 100, True, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", FA_CARD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_plain_version_on_the_card(card, dtype, case):
    B, Tq, Tk, H, Kh, D, Dv, window, causal, cap = case
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype) for s in
               ((B, Tq, H, D), (B, Tk, Kh, D), (B, Tk, Kh, Dv)))
    kw = dict(window=window, causal=causal, scale=D ** -0.5, attn_cap=cap)
    FK.reset_launches()
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert FK.LAUNCHES == {"flash_attention": 1,
                           "flash_attention_backward": 0}
    want = flash_attention_ref(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# K6 at the shapes of the model families chip_smoke.py's phase 9 serves:
# (B, Tq, H, K, D, Dv, causal) of olmoe-1b-7b, deepseek-v3-671b's MLA (D =
# 192 takes the 256 bucket), whisper-tiny's encoder (non-causal, T = 1500)
# and qwen2-vl-7b (256 patches + 1024 tokens)
FA_FAMILY_CASES = {
    "olmoe": (4, 1024, 16, 16, 128, 128, True),
    "deepseek-mla": (4, 1024, 128, 128, 192, 128, True),
    "whisper-encoder": (4, 1500, 6, 6, 64, 64, False),
    "qwen2-vl": (4, 1280, 28, 4, 128, 128, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FA_FAMILY_CASES))
def test_flash_attention_at_the_families_shapes_on_the_card(card, name):
    B, T, H, Kh, D, Dv, causal = FA_FAMILY_CASES[name]
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn(s, generator=g, device=card).to(torch.bfloat16)
               for s in ((B, T, H, D), (B, T, Kh, D), (B, T, Kh, Dv)))
    kw = dict(window=None, causal=causal, scale=D ** -0.5, attn_cap=None)
    got = fa_ops.flash_attention(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# K1's edges: n one short of and one past 4, 32 and 1024 elements
K1_CARD_N = [1, 3, 31, 33, 1023, 1025, 4097, (1 << 20) + 5]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", K1_CARD_N)
def test_threshold_bitpack_edges_on_the_card(card, dtype, n):
    """K1 bit for bit against ``bitpack_ref``: ragged n, NaN and ±inf
    magnitudes, tol 0 and 0.5, and a view one element past a 16-byte
    boundary (the kernel's unaligned variant)."""
    g = torch.Generator(device=card).manual_seed(n)
    mag = torch.rand(n + 1, generator=g, device=card, dtype=dtype)
    mag[::5] = float("nan")
    mag[1::7] = float("inf")
    mag[2::11] = float("-inf")
    K.reset_launches()
    for skip in (0, 1):
        m = mag[skip:skip + n]
        assert m.data_ptr() % 16 == skip * m.element_size()
        for tol in (0.0, 0.5):
            w, c = ops.threshold_bitpack(m, tol)
            w_r, c_r = ref.bitpack_ref(m, tol)
            assert _same_bytes(w, w_r) and _same_bytes(c, c_r)
    assert K.LAUNCHES["threshold_bitpack"] == 4


# (B, T, R, h0) for K7: T = 1, odd T and R, T one short of and one past a
# 32-step boundary, B = 1, T = 4096, the training slice's width
LRU_CARD_CASES = [(1, 1, 5, True), (2, 7, 100, False), (2, 300, 2560, True),
                  (3, 64, 33, False), (1, 31, 100, True),
                  (2, 33, 2560, False), (1, 4096, 2560, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LRU_CARD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_lru_scan_matches_plain_version_on_the_card(card, dtype, case):
    """K7 forward and backward against the plain version and autograd's
    gradient through it: f32 1e-5, bf16 2e-2 (atol and rtol)."""
    B, T, R, with_h0 = case
    g = torch.Generator(device=card).manual_seed(2)
    a = torch.rand((B, T, R), generator=g, device=card).to(dtype)
    b = torch.randn((B, T, R), generator=g, device=card).to(dtype)
    h0 = (torch.randn((B, R), generator=g, device=card).to(dtype)
          if with_h0 else None)
    dh = torch.randn((B, T, R), generator=g, device=card).to(dtype)
    ins = [a, b] + ([h0] if with_h0 else [])
    live = [t.clone().requires_grad_() for t in ins]
    LK.reset_launches()
    got = lru_ops.lru_scan(*live)
    got_grads = torch.autograd.grad(got, live, dh)
    assert LK.LAUNCHES == {"lru_scan": 1, "lru_scan_backward": 1}
    ref_live = [t.clone().requires_grad_() for t in ins]
    want = lru_scan_ref(*ref_live)
    want_grads = torch.autograd.grad(want, ref_live, dh)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for x, y in zip((got,) + got_grads, (want,) + want_grads):
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_backward_is_deterministic_on_the_card(card, dtype):
    """Two launches of K7's backward on the same inputs give the same
    bytes (no atomics), at the training slice's shape."""
    g = torch.Generator(device=card).manual_seed(4)
    a = torch.rand((2, 1024, 2560), generator=g, device=card).to(dtype)
    b, dh = (torch.randn((2, 1024, 2560), generator=g, device=card).to(dtype)
             for _ in range(2))
    h0 = torch.randn((2, 2560), generator=g, device=card).to(dtype)
    h = LK.lru_scan(a, b, h0)
    first = LK.lru_scan_backward(a, h, h0, dh)
    again = LK.lru_scan_backward(a, h, h0, dh)
    assert all(_same_bytes(x, y) for x, y in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LRU_CARD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_lru_scan_forward_chunks_on_the_card(card, dtype, case):
    """K7's forward in its chunked order: bit for bit
    ``lru_scan_chunked_ref`` and, over each row's first chunk, the plain
    version; within the tolerance of the plain version; the same bytes
    from two launches."""
    B, T, R, with_h0 = case
    g = torch.Generator(device=card).manual_seed(3)
    a = torch.rand((B, T, R), generator=g, device=card).to(dtype)
    b = torch.randn((B, T, R), generator=g, device=card).to(dtype)
    h0 = (torch.randn((B, R), generator=g, device=card).to(dtype)
          if with_h0 else None)
    got = LK.lru_scan(a, b, h0)
    assert _same_bytes(got, LK.lru_scan(a, b, h0))
    assert _same_bytes(got[:, :FWD_CHUNK],
                       lru_scan_ref(a, b, h0)[:, :FWD_CHUNK])
    assert _same_bytes(got, lru_scan_chunked_ref(a, b, h0))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), lru_scan_ref(a, b, h0).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CARD_CASES + [
    (1, 300, 300, 10, 1, 256, 256, 2048, True, None)],
    ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_backward_matches_plain_version_on_the_card(
        card, dtype, case):
    """K6's backward (dq, dk, dv) against autograd through
    flash_attention_ref: f32 2e-5, bf16 2e-2 (atol and rtol)."""
    B, Tq, Tk, H, Kh, D, Dv, window, causal, cap = case
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype) for s in
               ((B, Tq, H, D), (B, Tk, Kh, D), (B, Tk, Kh, Dv)))
    do = torch.randn((B, Tq, H, Dv), generator=g, device=card).to(dtype)
    kw = dict(window=window, causal=causal, scale=D ** -0.5, attn_cap=cap)
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    FK.reset_launches()
    got = torch.autograd.grad(fa_ops.flash_attention(*live, **kw), live, do)
    assert FK.LAUNCHES == {"flash_attention": 1,
                           "flash_attention_backward": 1}
    ref_live = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*ref_live, **kw),
                               ref_live, do)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for x, y in zip(got, want):
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)
