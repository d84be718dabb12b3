"""Checkpoint-safety linter — save-time hazards, caught before the crash
(port of ``repro.analysis.lint``).

Two coordinated passes share one findings model:

- **Graph pass** (:func:`lint_step`): given the step fn, its full state,
  and the pytree actually being checkpointed, walk the traced aten graph
  (``criticality.traced_step``) with the static analyzer
  (``repro_torch.analysis.analyze_static``) and flag semantic hazards —
  state the restart will silently miss, and bytes the paper's analysis
  says are wasted.
- **AST pass** (:func:`lint_file` / :func:`lint_paths`): scan manager call
  sites in source files for API-usage hazards in PyTorch idiom — buffers
  changed outside the stream order of a pipelined save, async saves never
  drained, generators never threaded into the saved state.

Rules (severity ``error`` fails CI):

====================  ========  =====  ====================================
rule                  severity  pass   hazard
====================  ========  =====  ====================================
CKPT001 missing-      error     graph  leaf read by the step fn but absent
 from-checkpoint                       from the checkpointed pytree —
                                       restart silently corrupts
CKPT002 saved-but-    warning   graph  checkpointed leaf statically fully
 dead                                  uncritical — wasted bytes (reported
                                       vs the paper's 20 % headline)
CKPT003 rng-not-      warning   graph  step fn draws random numbers (an
 threaded                              aten random op) but no key-like leaf
                                       is saved — restart replays a
                                       different stream
CKPT101 mutated-      warning*  AST    a buffer changed outside the
 while-inflight                        caller's stream order in a file with
                                       pipelined saves (*error when
                                       ``block=False`` is explicit)
CKPT102 save-not-     warning   AST    ``.save(`` calls but no ``wait()``/
 drained                               ``close()``/``with`` — writer
                                       errors are lost, exit may truncate
CKPT103 rng-key-      warning   AST    a ``torch.Generator`` (or the one
 not-saved                             ``torch.manual_seed`` returns) is
                                       re-seeded or drawn from
                                       (``generator=``) but never appears
                                       in a ``save(...)`` call
====================  ========  =====  ====================================

CKPT101's torch counterpart.  The reference flags ``donate_argnums``: XLA
may reuse a donated buffer while a pipelined save still reads it.  Torch
has no donation, and the port's ``save(block=False)`` snapshots the state
on the caller's current stream before it returns
(``checkpoint/manager.py``), so every write the caller issues later on
that stream is ordered after the snapshot.  What can still race the
snapshot is a change outside that order: a write issued under
``torch.cuda.stream(...)`` (or after ``torch.cuda.set_stream(...)``) on
another stream, and a storage freed or shrunk under the tensor
(``.untyped_storage().resize_(...)``, ``.storage().resize_(...)``).  The
rule looks for those calls; a file without pipelined saves is not
flagged.

CKPT103's torch counterpart.  ``torch.Generator(...)`` and
``torch.manual_seed(...)`` stand for ``jax.random.PRNGKey``; re-seeding a
generator (``g.manual_seed(...)``) or drawing from it (``generator=g``)
stands for ``split``/``fold_in``.  CKPT003's key-like leaf is one whose
name holds key, rng or seed, or a uint8 tensor of the shape of a
generator's ``get_state()`` (the CPU generator's, or the 16 bytes of a
CUDA generator's seed and offset).

CLI (the CI gate over the port's training launcher and ``chip_smoke.py``)::

    python -m repro_torch.analysis.lint src/repro_torch/launch/train.py \\
        chip_smoke.py --json lint_findings.json --fail-on error

Findings JSON is machine-readable: ``{"version": 1, "findings": [{rule,
severity, path, line, message, details}, ...], "counts": {...}}``.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import _tree
from repro_torch.analysis.static import analyze_static
from repro_torch.core.policy import ScrutinyConfig

SEVERITIES = ("error", "warning", "info")

# The paper's headline: scrutiny cuts ~20 % of checkpoint bytes.  A saved
# leaf that is *entirely* dead is waste on top of that.
PAPER_HEADLINE_SAVED = 0.20

# aten random ops, by their packet name with the functional (``_functional``),
# ``_like`` and in-place (``_``) suffixes stripped
_RANDOM_OPS = {"rand", "randn", "randint", "bernoulli", "normal", "uniform",
               "multinomial", "randperm", "native_dropout"}
# what a generator's get_state() returns: the CPU generator's state and a
# CUDA generator's (seed, offset)
_GENERATOR_STATE_SHAPES = {tuple(torch.Generator().get_state().shape), (16,)}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str              # file path, or "<graph>" for step-fn findings
    line: int              # 0 when not anchored to a source line
    message: str
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.severity.upper():7s} {self.rule} {loc}: {self.message}"


def _looks_like_key(name: str, leaf) -> bool:
    lname = name.lower()
    if "key" in lname or "rng" in lname or "seed" in lname:
        return True
    return (isinstance(leaf, torch.Tensor) and leaf.dtype == torch.uint8
            and tuple(leaf.shape) in _GENERATOR_STATE_SHAPES)


def _random_op(node) -> Optional[str]:
    """The base name of a node's aten random op, None for any other node."""
    name = getattr(node.target, "_opname", None)
    if node.op != "call_function" or name is None:
        return None
    for suffix in ("_functional", "_like", "_"):
        name = name[:-len(suffix)] if name.endswith(suffix) else name
    return name if name in _RANDOM_OPS else None


def lint_step(
    fn: Callable[[Any], Any],
    state: Any,
    checkpoint_state: Any = None,
    *,
    config: ScrutinyConfig = ScrutinyConfig(),
    path: str = "<graph>",
    device=None,
) -> List[Finding]:
    """Graph-level rules for one step fn.

    ``state``: the full state the step fn reads (what ``fn`` is traced
    with).  ``checkpoint_state``: the pytree actually passed to
    ``manager.save`` (defaults to ``state`` — then CKPT001 cannot fire and
    the check degenerates to dead-weight + RNG accounting).  ``device``:
    where the graph is traced and walked; the card unless ``"cpu"`` is
    asked for.
    """
    from repro_torch.core.criticality import traced_step

    findings: List[Finding] = []
    ts = traced_step(fn, state, device=device)
    static = analyze_static(fn, state, config=config, traced=ts,
                            device=device)
    saved = _tree.flatten_with_names(
        checkpoint_state if checkpoint_state is not None else state)[0]
    saved_names = {n for n, _ in saved}

    # CKPT001: read but not saved — restart silently corrupts.
    for name in ts.names:
        leaf = static[name]
        if name in saved_names or not leaf.mask.any():
            continue
        readers = [str(r) for r in static.provenance.get(name, ())[:3]]
        findings.append(Finding(
            "CKPT001", "error", path, 0,
            f"state leaf {name!r} is read by the step fn "
            f"({leaf.critical}/{leaf.total} elements critical) but absent "
            "from the checkpointed pytree — restart will silently corrupt",
            {"leaf": name, "critical": leaf.critical, "total": leaf.total,
             "readers": readers}))

    # CKPT002: saved but statically dead — wasted bytes.
    total_bytes = sum(static[n].table.full_bytes for n in ts.names
                      if n in saved_names)
    for name in ts.names:
        leaf = static[name]
        if name not in saved_names or leaf.mask.any():
            continue
        frac = leaf.table.full_bytes / total_bytes if total_bytes else 0.0
        findings.append(Finding(
            "CKPT002", "warning", path, 0,
            f"checkpointed leaf {name!r} is statically dead "
            f"({leaf.table.full_bytes} wasted bytes, {frac:.1%} of the "
            f"checkpoint; the paper's scrutiny headline is "
            f"{PAPER_HEADLINE_SAVED:.0%}) — drop it or gate it with a "
            "policy",
            {"leaf": name, "wasted_bytes": leaf.table.full_bytes,
             "fraction": frac}))

    # CKPT003: randomness drawn but no key-like leaf saved.
    ops = sorted({op for op in map(_random_op, ts.gm.graph.nodes) if op})
    if ops and not any(_looks_like_key(n, l) for n, l in saved):
        findings.append(Finding(
            "CKPT003", "warning", path, 0,
            f"step fn draws random numbers ({ops}) but no key-like leaf "
            "is checkpointed — a restart replays a different random "
            "stream", {"random_ops": ops}))
    return findings


# --------------------------------------------------------------------------
# AST pass
# --------------------------------------------------------------------------

def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_storage_resize(node: ast.Call) -> bool:
    """``x.untyped_storage().resize_(...)`` / ``x.storage().resize_(...)``."""
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "resize_"
            and isinstance(f.value, ast.Call)
            and isinstance(f.value.func, ast.Attribute)
            and f.value.func.attr in ("untyped_storage", "storage"))


class _FileScan(ast.NodeVisitor):
    def __init__(self):
        self.offstream_calls: List[ast.Call] = []  # CKPT101 hazards
        self.save_calls: List[ast.Call] = []
        self.drain_calls: List[ast.Call] = []     # .wait() / .close()
        self.with_manager = False
        self.key_vars: Dict[str, int] = {}        # name -> lineno assigned
        self.split_vars: Dict[str, int] = {}      # re-seeded / drawn from

    def visit_Call(self, node: ast.Call):
        fname = ast.unparse(node.func)
        if (fname.endswith(("cuda.stream", "cuda.set_stream"))
                or _is_storage_resize(node)):
            self.offstream_calls.append(node)
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "save":
                self.save_calls.append(node)
            elif node.func.attr in ("wait", "close"):
                self.drain_calls.append(node)
            elif node.func.attr == "manual_seed" and \
                    isinstance(node.func.value, ast.Name):
                self.split_vars.setdefault(node.func.value.id, node.lineno)
        gen = _kw(node, "generator")
        if isinstance(gen, ast.Name):
            self.split_vars.setdefault(gen.id, node.lineno)
        if "Generator" in fname or fname.endswith("manual_seed"):
            parent = getattr(node, "_assign_target", None)
            if parent:
                self.key_vars[parent] = node.lineno
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        if isinstance(node.value, ast.Call) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            call = node.value
            # torch.Generator(...).manual_seed(...): the chain's inner call
            while isinstance(call.func, ast.Attribute) and \
                    isinstance(call.func.value, ast.Call):
                call.func.value._assign_target = node.targets[0].id
                call = call.func.value
            node.value._assign_target = node.targets[0].id
        self.generic_visit(node)

    def visit_With(self, node: ast.With):
        for item in node.items:
            if "Manager" in ast.unparse(item.context_expr):
                self.with_manager = True
        self.generic_visit(node)


def lint_file(path: str, source: Optional[str] = None) -> List[Finding]:
    """AST rules over one Python source file (manager call sites)."""
    if source is None:
        with open(path, "r") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("CKPT100", "error", path, e.lineno or 0,
                        f"unparseable: {e.msg}", {})]
    scan = _FileScan()
    scan.visit(tree)
    findings: List[Finding] = []

    # CKPT101: a change outside the stream order + in-flight pipelined save.
    if scan.offstream_calls and scan.save_calls:
        explicit_async = [c for c in scan.save_calls
                          if isinstance(_kw(c, "block"), ast.Constant)
                          and _kw(c, "block").value is False]
        sev = "error" if explicit_async else "warning"
        anchor = (explicit_async or scan.save_calls)[0]
        findings.append(Finding(
            "CKPT101", sev, path, anchor.lineno,
            "a buffer is changed outside the caller's stream order (a "
            "side stream or a storage resize at line "
            f"{scan.offstream_calls[0].lineno}) in a file with pipelined "
            "saves — the change may land before the save's snapshot "
            "reads the buffer; wait() for the save first, or synchronize "
            "the side stream with the caller's before the save",
            {"offstream_lines": [c.lineno for c in scan.offstream_calls],
             "save_lines": [c.lineno for c in scan.save_calls]}))

    # CKPT102: async saves never drained.
    if scan.save_calls and not scan.drain_calls and not scan.with_manager:
        findings.append(Finding(
            "CKPT102", "warning", path, scan.save_calls[0].lineno,
            "manager.save() is called but the file never drains the "
            "pipeline (no wait()/close()/`with` manager) — writer errors "
            "are lost and process exit can truncate the last checkpoint",
            {"save_lines": [c.lineno for c in scan.save_calls]}))

    # CKPT103: a live generator stream that never reaches a save call.
    if scan.save_calls:
        # exact identifier membership, not substring: 'gen' must not count
        # as saved because a save call mentions 'subgen'
        saved_idents = set()
        for c in scan.save_calls:
            for node in ast.walk(c):
                if isinstance(node, ast.Name):
                    saved_idents.add(node.id)
        for var, line in sorted(scan.key_vars.items()):
            if var in scan.split_vars and var not in saved_idents:
                findings.append(Finding(
                    "CKPT103", "warning", path, line,
                    f"generator {var!r} is re-seeded or drawn from (line "
                    f"{scan.split_vars[var]}) but never appears in a "
                    "save() call — the random stream is not restart-safe",
                    {"key_var": var, "split_line": scan.split_vars[var]}))
    return findings


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint every ``.py`` file under the given files/directories."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files += [os.path.join(root, n) for n in sorted(names)
                          if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
        else:
            raise FileNotFoundError(f"lint: not a .py file or directory: {p}")
    findings: List[Finding] = []
    for f in files:
        findings += lint_file(f)
    return findings


def findings_json(findings: Sequence[Finding]) -> Dict[str, Any]:
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in SEVERITIES}
    return {"version": 1, "counts": counts,
            "findings": [f.to_json() for f in findings]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Checkpoint-safety linter (AST pass over manager call "
                    "sites; see repro_torch.analysis.lint_step for the "
                    "graph rules).")
    ap.add_argument("paths", nargs="+", help=".py files or directories")
    ap.add_argument("--json", default=None, help="write findings JSON here")
    ap.add_argument("--fail-on", default="error", choices=SEVERITIES,
                    help="exit non-zero when findings at/above this "
                         "severity exist (default: error)")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths)
    for f in findings:
        print(f)
    payload = findings_json(findings)
    print(f"lint: {payload['counts']} over {len(args.paths)} path(s)")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"lint: findings written to {args.json}")
    threshold = SEVERITIES.index(args.fail_on)
    failing = [f for f in findings
               if SEVERITIES.index(f.severity) <= threshold]
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
