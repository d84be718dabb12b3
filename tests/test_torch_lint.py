"""The port's checkpoint-safety linter (``repro_torch.analysis.lint``): the
lint cases of ``tests/test_analysis.py`` in PyTorch idiom, with the same
rules, severities and anchors.

- the graph pass on a toy step (the traced aten graph in place of the
  jaxpr): a read leaf missing from the checkpoint (CKPT001, with the nodes
  that read it), a saved leaf that is statically dead (CKPT002) and not
  when the policy pins it, randomness drawn with no key-like leaf saved
  (CKPT003: an aten random op; a leaf named for a key, or a generator's
  state, silences it);
- the AST pass on synthetic sources: a buffer changed outside the
  caller's stream order beside a pipelined save (CKPT101: a side stream,
  or a storage resize; an error with an explicit ``block=False``), saves
  never drained (CKPT102), a generator re-seeded or drawn from but never
  saved (CKPT103, identifiers matched exactly), a clean file and an
  unparseable one (CKPT100);
- the findings JSON, the CLI (``main`` and ``python -m``), and the CI
  gate: zero error findings on the port's training launcher and on
  ``chip_smoke.py`` (``examples/`` holds only JAX code, which the
  torch-idiom rules do not read).

The graph pass runs on the CPU (``device="cpu"``).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import findings_json, lint_file, lint_paths
from repro_torch.analysis import lint_step as _lint_step
from repro_torch.analysis.lint import main as lint_main
from repro_torch.core import ScrutinyConfig
from repro_torch.core.policy import LeafPolicy, default_leaf_policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_step(*args, **kw):
    return _lint_step(*args, device="cpu", **kw)


def toy_step(s):
    """Reads w and step; never reads scratch (statically dead)."""
    tmp = s["w"][:6] * 2.0
    out = (s["w"] ** 2).sum() + tmp.sum() + s["step"].to(torch.float32)
    return {"out": out}


def toy_state():
    return {
        "w": torch.arange(8, dtype=torch.float32),
        "scratch": torch.zeros(6, dtype=torch.float32),
        "step": torch.zeros((), dtype=torch.int32),
    }


# --- lint: graph pass ------------------------------------------------------

def test_lint_step_missing_from_checkpoint():
    state = toy_state()
    ckpt = {"w": state["w"], "scratch": state["scratch"]}   # drops step
    rules = {f.rule: f for f in lint_step(toy_step, state, ckpt)}
    assert rules["CKPT001"].severity == "error"
    assert rules["CKPT001"].details["leaf"] == "step"
    assert rules["CKPT001"].details["readers"]


def test_lint_step_saved_but_dead():
    state = toy_state()
    rules = {f.rule: f for f in lint_step(toy_step, state)}
    assert "CKPT001" not in rules          # full state saved
    dead = rules["CKPT002"]
    assert dead.severity == "warning"
    assert dead.details["leaf"] == "scratch"
    assert dead.details["wasted_bytes"] == 6 * 4
    assert 0.0 < dead.details["fraction"] < 1.0


def test_lint_step_pinned_float_is_not_dead():
    """A leaf the policy pins ALWAYS_CRITICAL keeps its all-ones mask, so
    CKPT002 does not advise dropping it."""

    def pin_scratch(leaf):
        if leaf.dim() and tuple(leaf.shape) == (6,) and \
                leaf.is_floating_point():
            return LeafPolicy.ALWAYS_CRITICAL
        return default_leaf_policy(leaf)

    rules = {f.rule for f in lint_step(
        toy_step, toy_state(), config=ScrutinyConfig(leaf_policy=pin_scratch))}
    assert "CKPT002" not in rules


def _noisy_step(s):
    return {"x": torch.randn(4) + s["x"] + s["i"].to(torch.float32)}


def test_lint_step_rng_not_threaded():
    state = {"i": torch.zeros((), dtype=torch.int32),
             "x": torch.zeros(4, dtype=torch.float32)}
    (f,) = [f for f in lint_step(_noisy_step, state) if f.rule == "CKPT003"]
    assert f.severity == "warning" and f.details["random_ops"] == ["randn"]

    keyed = {"rng_key": torch.zeros(2, dtype=torch.int64), **state}
    assert "CKPT003" not in {f.rule for f in lint_step(_noisy_step, keyed)}
    # a generator's state saved under any name counts as the key
    gen_state = {"g": torch.Generator().manual_seed(0).get_state(), **state}
    assert "CKPT003" not in {f.rule for f in lint_step(_noisy_step,
                                                       gen_state)}


def test_lint_step_finds_every_form_of_random_op():
    """Functional, ``_like`` and in-place draws are all randomness."""

    def step(s):
        y = torch.zeros(4)
        y.uniform_()
        drop = torch.nn.functional.dropout(s["x"], 0.5, training=True)
        return {"x": torch.rand_like(s["x"]) + y + drop}

    state = {"x": torch.ones(4)}
    (f,) = [f for f in lint_step(step, state) if f.rule == "CKPT003"]
    assert f.details["random_ops"] == ["bernoulli", "rand", "uniform"]


# --- lint: AST pass --------------------------------------------------------

SIDE_STREAM_ASYNC = """
import torch
side = torch.cuda.Stream()
with torch.cuda.stream(side):
    state["w"].add_(1.0)
mgr.save(step_no, state, block=False)
mgr.wait()
"""

SIDE_STREAM_BLOCKING = """
import torch
side = torch.cuda.Stream()
with torch.cuda.stream(side):
    state["w"].add_(1.0)
mgr.save(step_no, state)
mgr.wait()
"""

RESIZED_ASYNC = """
mgr.save(step_no, state, block=False)
state["w"].untyped_storage().resize_(0)
mgr.wait()
"""

NO_DRAIN = """
mgr.save(1, state)
mgr.save(2, state)
"""

KEY_NOT_SAVED = """
import torch
gen = torch.Generator().manual_seed(0)
noise = torch.randn(4, generator=gen)
mgr.save(1, {"params": params})
mgr.wait()
"""

CLEAN = """
import torch
gen = torch.Generator().manual_seed(0)
noise = torch.randn(4, generator=gen)
with CheckpointManager(levels) as mgr:
    mgr.save(1, {"params": params, "rng": gen.get_state()})
"""

SUBGEN_ONLY_SAVED = """
import torch
gen = torch.Generator()
gen.manual_seed(0)
subgen = torch.Generator().manual_seed(1)
x = torch.randn(4, generator=subgen)
mgr.save(1, {"k": subgen.get_state()})
mgr.wait()
"""


def test_lint_file_mutated_while_inflight():
    (f,) = lint_file("d.py", SIDE_STREAM_ASYNC)
    assert (f.rule, f.severity) == ("CKPT101", "error")   # explicit block=False
    assert f.line == 6 and f.details["offstream_lines"] == [4]
    (f,) = lint_file("d.py", SIDE_STREAM_BLOCKING)
    assert (f.rule, f.severity) == ("CKPT101", "warning")
    (f,) = lint_file("r.py", RESIZED_ASYNC)
    assert (f.rule, f.severity) == ("CKPT101", "error")
    assert f.details["offstream_lines"] == [3]


def test_lint_file_save_not_drained():
    (f,) = lint_file("n.py", NO_DRAIN)
    assert (f.rule, f.severity) == ("CKPT102", "warning")
    assert f.line == 2 and f.details["save_lines"] == [2, 3]


def test_lint_file_key_not_saved():
    (f,) = lint_file("k.py", KEY_NOT_SAVED)
    assert (f.rule, f.severity) == ("CKPT103", "warning")
    assert f.details["key_var"] == "gen"
    assert f.line == 3 and f.details["split_line"] == 4


def test_lint_file_key_substring_not_saved():
    """'gen' is not saved just because a save call mentions 'subgen':
    CKPT103 must match identifiers exactly, not substrings."""
    findings = {f.details.get("key_var"): f for f in
                lint_file("k.py", SUBGEN_ONLY_SAVED)
                if f.rule == "CKPT103"}
    assert "gen" in findings                  # re-seeded, never saved
    assert "subgen" not in findings           # subgen really is saved


def test_lint_file_clean_and_unparseable():
    assert lint_file("c.py", CLEAN) == []
    (f,) = lint_file("b.py", "def broken(:\n")
    assert (f.rule, f.severity) == ("CKPT100", "error")


def test_findings_json_shape():
    fs = lint_file("n.py", NO_DRAIN) + lint_file("d.py", SIDE_STREAM_ASYNC)
    payload = findings_json(fs)
    assert payload["version"] == 1
    assert payload["counts"] == {"error": 1, "warning": 1, "info": 0}
    rec = payload["findings"][0]
    assert set(rec) == {"rule", "severity", "path", "line", "message",
                        "details"}
    json.dumps(payload)                    # machine-readable


# --- lint: CLI + CI gate ---------------------------------------------------

def test_lint_cli(tmp_path, capsys):
    hazard = tmp_path / "hazard.py"
    hazard.write_text(NO_DRAIN)
    out_json = tmp_path / "findings.json"

    # warnings only: passes at --fail-on error, fails at --fail-on warning
    assert lint_main([str(hazard), "--json", str(out_json)]) == 0
    assert lint_main([str(hazard), "--fail-on", "warning"]) == 1
    payload = json.loads(out_json.read_text())
    assert payload["counts"]["warning"] == 1
    assert "CKPT102" in capsys.readouterr().out

    (tmp_path / "bad.py").write_text("def broken(:\n")
    assert lint_main([str(tmp_path)]) == 1      # directory walk finds error
    with pytest.raises(FileNotFoundError):
        lint_paths([str(tmp_path / "notes.txt")])


def test_lint_cli_module_entrypoint(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text(CLEAN)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(clean)],
        capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint:" in proc.stdout


def test_ci_gate_train_launcher_and_chip_smoke_clean():
    """The gate over the port: error findings in its training launcher or in
    ``chip_smoke.py`` fail the build — keep them at zero."""
    findings = lint_paths([
        os.path.join(REPO, "src/repro_torch/launch/train.py"),
        os.path.join(REPO, "chip_smoke.py")])
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], "\n".join(str(f) for f in errors)
