"""The port's launch tooling (``repro_torch.launch``: specs, mesh, roofline,
the dry run, the build cache) against the reference's ``repro.launch``,
and the port's examples (``examples/torch``) on the CPU.

The reference's ``dryrun`` module sets ``XLA_FLAGS`` to 512 host devices
when it is imported, so it is imported only inside a fixture that puts
the variable back."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.launch import roofline as r_roofline
from repro.launch import specs as r_specs
from repro_torch import _tree
from repro_torch._tensors import leaf_dtype_name
from repro_torch.configs import all_arch_names, get_config
from repro_torch.kernels import _build
from repro_torch.launch import compile_cache, dryrun, mesh, roofline, specs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in all_arch_names() for s in specs.SHAPES
         if s not in get_config(a).skip_shapes]


def _sig(tree):
    """name → (shape, dtype name) of a port tree (meta tensors) or a
    reference tree (``ShapeDtypeStruct``s)."""
    out = {}
    for name, leaf in _tree.flatten_with_names(tree)[0]:
        dt = (leaf_dtype_name(leaf) if isinstance(leaf, torch.Tensor)
              else str(leaf.dtype))
        out[name] = (tuple(leaf.shape), dt)
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Every leaf of every part of the bundle: the reference's name, shape
    and dtype (``jax.eval_shape`` against meta tensors)."""
    got = specs.input_specs(get_config(arch), shape)
    want = r_specs.input_specs(r_get_config(arch), shape)
    assert sorted(got) == sorted(want)
    assert got["cell"] == specs.ShapeCell(**dataclasses.asdict(want["cell"]))
    for part in want:
        if part != "cell":
            assert _sig(got[part]) == _sig(want[part]), part
            assert all(t.device.type == "meta"
                       for t in _tree.leaves(got[part]))


# whisper-tiny's encoder attention: 4 projections of d × (H·hd) a layer,
# which the reference's expression (roofline.py:184-186) counts as d × hd
def _encoder_attention_missing(cfg) -> int:
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    return cfg.n_encoder_layers * 4 * d * hd * (H - 1)


@pytest.mark.parametrize("arch", all_arch_names())
def test_model_flops_match_reference(arch):
    """Exactly the reference's on every cell of nine archs; on
    whisper-tiny's, the reference's plus exactly the missing term."""
    cfg, rcfg = get_config(arch), r_get_config(arch)
    missing = _encoder_attention_missing(cfg) if cfg.enc_dec else 0
    if cfg.enc_dec:
        assert missing == 1_966_080
        assert r_roofline._active_params(rcfg) == 34_465_152
        assert roofline._active_params(cfg) == 36_431_232
    for name, cell in specs.SHAPES.items():
        B, T = cell.global_batch, cell.seq_len
        per_token = {"train": 6.0 * B * T, "prefill": 2.0 * B * T,
                     "decode": 2.0 * B}[cell.kind]
        want = r_roofline.model_flops(rcfg, r_specs.SHAPES[name]) \
            + missing * per_token
        assert roofline.model_flops(cfg, cell) == want, name


def test_roofline_terms_h100():
    """The reference's ``test_roofline_terms`` with the H100's peaks."""
    rl = roofline.Roofline(
        arch="a", shape="s", mesh="m", chips=256,
        hlo_flops=256 * 989e12 * 0.01,                 # 10 ms compute
        hlo_bytes=256 * 3.35e12 * 0.02,                # 20 ms memory
        coll_bytes={"all-reduce": int(256 * 50e9 * 0.005)},
        model_flops=256 * 989e12 * 0.008)
    assert (mesh.PEAK_FLOPS, mesh.HBM_BW, mesh.LINK_BW, mesh.NVLINK_BW) == \
        (989e12, 3.35e12, 50e9, 900e9)
    assert abs(rl.t_compute - 0.01) < 1e-9
    assert abs(rl.t_memory - 0.02) < 1e-9
    assert abs(rl.t_collective - 0.005) < 1e-9
    assert rl.dominant == "memory"
    assert abs(rl.roofline_fraction - 0.4) < 1e-9
    assert abs(rl.useful_fraction - 0.8) < 1e-9
    assert rl.row().startswith("| a | s | m | 10.00 | 20.00 | 5.00 | memory")
    assert roofline.TABLE_HEADER == r_roofline.TABLE_HEADER


def test_meshes():
    assert mesh.make_production_mesh() == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}
    assert mesh.mesh_name(mesh.make_production_mesh(multi_pod=True)) == \
        "pod2x16x16"
    assert mesh.mesh_chips(mesh.make_production_mesh()) == 256
    assert mesh.make_host_mesh(4, 4) == {"data": 1, "model": 1}


@pytest.fixture
def r_dryrun(monkeypatch):
    """The reference's dry-run module, its ``NamedSharding`` stood in by a
    class that keeps the spec; ``XLA_FLAGS`` put back afterwards."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.distributed import sharding as r_sh
    from repro.launch import dryrun as mod

    class Spec:
        def __init__(self, mesh, spec):
            self.spec = spec

    monkeypatch.setattr(mod, "NamedSharding", Spec)
    monkeypatch.setattr(r_sh, "NamedSharding", Spec)
    return mod


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "2pod"])
@pytest.mark.parametrize("arch", all_arch_names())
def test_opt_shardings_match_reference(r_dryrun, arch, multi_pod):
    """AdamW's moments as the parameters; Adafactor's ``vr`` / ``vc`` drop
    a dim: leaf for leaf the reference's specs on train_4k's state."""
    import types

    m = mesh.make_production_mesh(multi_pod=multi_pod)
    rmesh = types.SimpleNamespace(axis_names=tuple(m), shape=dict(m))
    cfg, rcfg = get_config(arch), r_get_config(arch)
    kind = specs.optimizer_kind(cfg)
    got_b = specs.input_specs(cfg, "train_4k")
    want_b = r_specs.input_specs(rcfg, "train_4k")
    got = dryrun.opt_shardings(cfg, m, got_b["params"], got_b["opt"], kind)
    want = r_dryrun.opt_shardings(rcfg, rmesh, want_b["params"],
                                  want_b["opt"], kind)
    flat_want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: hasattr(x, "spec"))]
    from repro_torch.distributed.sharding import _spec_leaves
    assert [tuple(s) for s in _spec_leaves(got)] == flat_want
    assert len(flat_want) == len(_tree.leaves(got_b["opt"]))


@pytest.mark.parametrize("shape", list(specs.SHAPES))
def test_lower_cell_xlstm(shape, tmp_path):
    """xlstm-125m at each production shape: the fake run completes, FLOPs
    are counted, the JSON states what its collectives cover."""
    res = dryrun.lower_cell("xlstm-125m", shape, verbose=False)
    cell = specs.SHAPES[shape]
    assert res["status"] == "ok" and res["mesh"] == "pod16x16"
    assert res["flops"] > 0 and res["bytes"] > 0 and res["n_nodes"] > 0
    assert res["model_flops"] == roofline.model_flops(
        get_config("xlstm-125m"), cell)
    assert res["moe_load"] is None
    assert "tensor-parallel" in res["collective_scope"]
    assert res["memory"]["argument_bytes_per_device"] > 0
    assert res["memory"]["global_peak_bytes"] > 0
    assert res["dominant"] in ("compute", "memory", "collective")
    # train: gradient all-reduce over the data axis (no FSDP here)
    assert (set(res["collective_bytes"]) == {"all-reduce"}) == \
        (cell.kind == "train")


def test_lower_cell_moe_balanced():
    """olmoe-1b-7b's decode cell: each of 64 experts is answered with
    B·K/E = 128·8/64 = 16 rows; the expert products' FLOPs are those."""
    res = dryrun.lower_cell("olmoe-1b-7b", "decode_32k", multi_pod=True,
                            verbose=False)
    cfg = get_config("olmoe-1b-7b")
    assert res["status"] == "ok" and res["chips"] == 512
    assert "= 16 rows" in res["moe_load"]
    assert "1024 calls" in res["moe_load"]          # 64 experts × 16 layers
    # the weight products of the experts: 3 a routed row, 16 rows each
    d, f, E = cfg.d_model, cfg.moe.d_expert, cfg.moe.num_experts
    experts = cfg.n_layers * E * 3 * 2 * 16 * d * f
    assert res["flops"] > experts
    assert res["collective_bytes"] == {}            # decode, no FSDP


def test_fake_and_real_flops_equal_on_the_cpu():
    """The accountant over fake tensors and over the real step (plain K6
    and K7 on the CPU, forward and backward) count the same FLOPs: the
    check phase 14 makes on the card, here on a reduced
    recurrentgemma-2b train step and a reduced phi4-mini prefill."""
    from repro_torch.launch.graph_analysis import Accountant
    from repro_torch.launch.train import build_state
    from repro_torch.models import prefill
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    for arch, kind in (("recurrentgemma-2b", "train"),
                       ("phi4-mini-3.8b", "prefill")):
        cfg = get_config(arch).reduced()
        cell = specs.ShapeCell("t", kind, 32, 2)
        fake = dryrun.fake_account(cfg, cell)["accounting"]
        oc = OptConfig(kind=specs.optimizer_kind(cfg))
        state = build_state(cfg, oc, 2, 32, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with Accountant() as acct:
            if kind == "train":
                make_train_step(cfg, oc)(state["params"], state["opt"],
                                         batch)
            else:
                with torch.no_grad():
                    prefill(cfg, state["params"],
                            {"tokens": batch["tokens"]}, 32)
        real = acct.result()
        assert real["flops"] == fake["flops"] > 0, arch
        assert real["flops_by_op"] == fake["flops_by_op"], arch
        if kind == "train":
            assert "repro_torch.flash_attention_backward" in \
                real["flops_by_op"]


def test_compile_cache_env_rules(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(_build, "_build_dir", _build._UNSET)
    assert compile_cache.default_cache_dir() == str(_build.BUILD_DIR)
    assert _build.build_dir() == _build.BUILD_DIR
    for off in ("0", "off", "None", " disable "):
        monkeypatch.setenv("REPRO_COMPILE_CACHE", off)
        assert compile_cache.default_cache_dir() is None
        tmp = _build.build_dir()            # a per-process directory
        assert tmp != _build.BUILD_DIR and tmp.name.startswith(
            "repro_torch_build_")
    monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path / "c"))
    assert _build.build_dir() == tmp_path / "c"
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()
    assert _build.build_dir() == tmp_path / "c"
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert compile_cache.enable_persistent_cache(str(blocker / "x")) is None
    assert _build.build_dir() != tmp_path / "c"     # off: per-process
    compile_cache.enable_persistent_cache(str(tmp_path / "d"))
    assert _build.build_dir() == tmp_path / "d"


def _example(name):
    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,args,expect", [
    ("quickstart", [], "match=True"),
    ("serve_lm", [], "% saved"),
    ("npb_checkpoint_demo", ["bt"],
     "bt: restart=True corrupt-uncritical-still-passes=True"),
    ("lint_findings_demo", [], "CKPT103"),
    ("train_lm", ["--steps", "2", "--more", "1"], "resumed from step 2"),
])
def test_example_runs_on_the_cpu(name, args, expect, capsys, monkeypatch):
    """Each example of ``examples/torch`` with ``--device cpu``."""
    _example(name).main(["--device", "cpu"] + args)
    out = capsys.readouterr().out
    assert expect in out, out[-2000:]


def test_port_launch_imports_no_jax():
    """The launch tooling and the examples import torch, never jax or the
    reference package."""
    import ast
    files = [os.path.join(ROOT, "src", "repro_torch", "launch", f)
             for f in ("mesh.py", "roofline.py", "specs.py",
                       "graph_analysis.py", "dryrun.py", "compile_cache.py")]
    files += [os.path.join(ROOT, "examples", "torch", f) for f in
              sorted(os.listdir(os.path.join(ROOT, "examples", "torch")))
              if f.endswith(".py")]
    assert len(files) == 11
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro"), (path, n)
    assert np.isfinite(mesh.PEAK_FLOPS)
