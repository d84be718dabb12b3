"""Dry run: account every (arch × shape × mesh) cell of the production
meshes over fake tensors (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ARCH --shape CELL
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Each cell builds the spec bundle (``launch/specs.py``, meta tensors), fits
the partition specs of ``distributed/sharding.py`` to the mesh, runs the
step (``make_train_step``, ``prefill`` or ``decode_step``) once at the
cell's global batch under ``FakeTensorMode`` with the aten accountant of
``launch/graph_analysis.py``, and writes
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
roofline's inputs.  Nothing is allocated and no device is needed.

What each number is:

- ``flops``, ``bytes``: the whole step's (global) aten FLOPs and unfused
  HBM bytes, an upper bound on the traffic (the reference's come from the
  SPMD-partitioned HLO, per device, scaled by the chips);
- ``memory.argument_bytes_per_device``: the largest per-device sum of the
  arguments' shard bytes under the fitted specs, the counterpart of
  ``memory_analysis().argument_size_in_bytes``;
- ``memory.global_peak_bytes``: the fake run's peak of live tensor bytes
  (``torch.distributed._tools.mem_tracker.MemTracker``), for the whole
  global batch on one device: a global figure, not a per-device temp size;
- ``collective_bytes``: an estimate from the spec tables, since the port
  has no SPMD partitioner whose program could be parsed: each parameter's
  gradient all-reduce over the mesh axes that replicate it (reduce-scatter
  over an FSDP leaf's data axes) and an FSDP leaf's all-gathers, in the
  forward and, in training, the backward.  ``collective_scope`` names what
  is not counted: the tensor-parallel activation collectives and the MoE
  dispatch.
- ``moe_load``: the routing a MoE cell assumes.  An expert's ``nonzero``
  has a data-dependent size that fake tensors cannot give, so a dispatch
  mode local to the dry run answers it with the balanced load, B·T·K/E
  rows an expert (the training capacity C = int(S/E·1.25) keeps them all).

The reference's knobs (``dryrun.py:184-193``): ``--paper-baseline`` maps to
``set_remat_policy("full")`` and ``--seq-shard`` to ``batch_shardings(
seq_shard=True)``.  ``set_seq_shard_residual`` (``--sp-residual``),
``moe.set_dispatch("global")`` and ``set_full_attention_threshold`` have
no counterpart in the port (its MoE runs expert by expert,
``models/moe.py``; its attention always calls K6, ``models/attention.py``)
and are dropped.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import _tree
from repro_torch.configs import all_arch_names, get_config
from repro_torch.distributed.sharding import (_spec_leaves, batch_shardings,
                                              cache_shardings, data_axes,
                                              fit_spec, params_shardings)
from repro_torch.launch.graph_analysis import Accountant
from repro_torch.launch.mesh import (make_production_mesh, mesh_chips,
                                     mesh_name)
from repro_torch.launch.roofline import Roofline, model_flops
from repro_torch.launch.specs import (SHAPES, ShapeCell, input_specs,
                                      optimizer_kind)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "experiments", "dryrun_torch")

COLLECTIVE_SCOPE = (
    "estimated from the partition specs: parameter-gradient all-reduce over "
    "the axes that replicate a leaf, reduce-scatter over an FSDP leaf's "
    "data axes, FSDP all-gathers (forward; backward too in training). Not "
    "counted: the tensor-parallel activation collectives over 'model' and "
    "the MoE dispatch")


def opt_shardings(cfg, mesh: Dict[str, int], params, opt, kind: str):
    """Specs of the optimizer state: AdamW's moments as the parameters;
    Adafactor's ``vr`` drops the parameter spec's last dim, ``vc`` its
    second-to-last; the step replicated."""
    p_sh = params_shardings(cfg, mesh, params)
    if kind == "adamw":
        return {"mu": p_sh, "nu": p_sh, "step": ()}

    def slot_sh(spec, slot):
        out = {}
        for k, v in slot.items():
            nd = len(v.shape)
            if k == "vr":
                s = spec[:-1]
            elif k == "vc":
                s = spec[:-2] + spec[-1:]
            else:
                s = spec
            s = tuple(s)[:nd]
            s = s + (None,) * (nd - len(s))
            out[k] = fit_spec(mesh, s, tuple(v.shape))
        return out

    named, treedef = _tree.flatten_with_names(params)
    slots = []
    for (name, _), spec in zip(named, _spec_leaves(p_sh)):
        slot = opt["slots"]
        for key in name.split("/"):
            slot = slot[key]
        slots.append(slot_sh(spec, slot))
    return {"slots": _tree.unflatten(treedef, slots), "step": ()}


def _axes(spec) -> list:
    out = []
    for d in spec:
        if d is None:
            continue
        out.extend(d if isinstance(d, tuple) else (d,))
    return out


def _shards(mesh: Dict[str, int], spec) -> int:
    n = 1
    for a in _axes(spec):
        n *= mesh[a]
    return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def argument_bytes_per_device(mesh, trees_and_specs) -> int:
    """Sum over the arguments of each leaf's shard bytes.  The fitted specs
    divide every sharded dim evenly, so every device holds the same bytes
    and the largest per-device sum is this sum."""
    total = 0
    for tree, specs in trees_and_specs:
        leaves = _tree.leaves(tree)
        for leaf, spec in zip(leaves, _spec_leaves(specs)):
            total += _nbytes(leaf) // _shards(mesh, spec)
    return total


def collective_estimate(cfg, mesh, params, p_sh, train: bool
                        ) -> Dict[str, int]:
    """Global collective result bytes (per device × chips, as the
    reference scales its per-device HLO) from the parameter specs; see
    ``COLLECTIVE_SCOPE``."""
    chips = mesh_chips(mesh)
    dp = set(data_axes(mesh))
    out = {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0}
    for leaf, spec in zip(_tree.leaves(params), _spec_leaves(p_sh)):
        shard = _nbytes(leaf) // _shards(mesh, spec)
        axes = set(_axes(spec))
        fsdp = 1
        for a in axes & dp:
            fsdp *= mesh[a]
        if fsdp > 1:        # FSDP: gather the data shards before each use
            out["all-gather"] += shard * fsdp * (2 if train else 1)
        if not train:
            continue
        if fsdp > 1:
            out["reduce-scatter"] += shard
        if any(mesh[a] > 1 for a in mesh if a not in axes):
            out["all-reduce"] += shard
    return {k: v * chips for k, v in out.items() if v}


class BalancedRouting(TorchDispatchMode):
    """Answers ``aten.nonzero`` of an expert's slot mask with the balanced
    load: ``numel // num_experts`` rows (B·T·K/E), the routing a fake
    tensor cannot tell.  Entered above ``FakeTensorMode``."""

    def __init__(self, num_experts: int):
        super().__init__()
        self.num_experts = num_experts
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.nonzero.default:
            x = args[0]
            self.calls += 1
            return torch.empty((x.numel() // self.num_experts, x.dim()),
                               dtype=torch.int64, device=x.device)
        return func(*args, **(kwargs or {}))


class _StepTimesT(torch.autograd.Function):
    """One step of a ``time_loop`` run once and accounted T times, its
    backward too: the middle step of the loop, whose carry outputs receive
    gradients (zeros where the caller's have none)."""

    @staticmethod
    def forward(ctx, plan, *leaves):
        acct, step, consts_def, n_consts, n_carry, T = plan
        # the inner graph keeps its tensors itself: a remat layer's hooks
        # (torch.utils.checkpoint) would recompute them a second time
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            ins = [l.detach().requires_grad_(l.is_floating_point())
                   for l in leaves]
            consts = (None if consts_def is None else
                      _tree.unflatten(consts_def, ins[:n_consts]))
            carry = tuple(ins[n_consts:n_consts + n_carry])
            xs = ins[n_consts + n_carry:]
            with acct.repeat(T):
                carry, h = step(consts, carry, tuple(x[:, 0] for x in xs))
        ctx.plan, ctx.ins, ctx.outs = plan, ins, (*carry, h)
        return tuple(o.detach() for o in ctx.outs)

    @staticmethod
    def backward(ctx, *grads):
        acct, T = ctx.plan[0], ctx.plan[-1]
        n_xs = len(ctx.ins) - ctx.plan[3] - ctx.plan[4]
        need = [i for i in ctx.ins if i.requires_grad]
        gs = [g if g is not None else torch.zeros_like(o)
              for o, g in zip(ctx.outs, grads)]
        with torch.enable_grad(), acct.repeat(T):
            out = list(torch.autograd.grad(ctx.outs, need, gs,
                                           allow_unused=True))
        # the engine sums the T per-step gradients of each input sequence
        with acct.repeat(T - 1):
            for g in out[len(out) - n_xs:]:
                if g is not None:
                    g + g
        it = iter(out)
        return (None,) + tuple(next(it) if i.requires_grad else None
                               for i in ctx.ins)


@contextlib.contextmanager
def loops_counted_once(acct: Accountant):
    """``models.recurrent.time_loop`` (the mLSTM and sLSTM cells' loop
    over T) runs one step and has the accountant count it T times, forward
    and backward, as the reference's HLO analysis multiplies a while body
    by its trip count: T steps of xlstm-125m at T = 32768 are millions of
    ops, hours under fake tensors.  Each step's ops have the same shapes,
    so the FLOPs and bytes are the loop's; the per-step input gradients'
    T - 1 accumulations are counted as T - 1 adds of one input's size."""
    from repro_torch.models import recurrent as rec

    real = rec.time_loop

    def once(step, consts, carry, xs):
        T = xs[0].shape[1]
        named, consts_def = (([], None) if consts is None
                             else _tree.flatten_with_names(consts))
        leaves = [l for _, l in named] + list(carry) + list(xs)
        plan = (acct, step, consts_def, len(named), len(carry), T)
        *carry, h = _StepTimesT.apply(plan, *leaves)
        hs = h.unsqueeze(1).expand((h.shape[0], T) + tuple(h.shape[1:]))
        return tuple(carry), hs.contiguous()        # stack's 2× its result

    rec.time_loop = once
    try:
        yield
    finally:
        rec.time_loop = real


def _fake_like(tree, device):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [torch.empty(l.shape, dtype=l.dtype,
                                                 device=device)
                                     for _, l in named])


def _step_thunk(cfg, cell: ShapeCell, bundle) -> Any:
    """The cell's step over ``bundle``'s tensors, as a thunk."""
    from repro_torch.models import decode_step, prefill

    if cell.kind == "train":
        from repro_torch.train.optim import OptConfig
        from repro_torch.train.step import make_train_step
        step = make_train_step(cfg, OptConfig(kind=optimizer_kind(cfg)))
        return lambda: step(bundle["params"], bundle["opt"], bundle["batch"])
    if cell.kind == "prefill":
        def run():
            with torch.no_grad():
                return prefill(cfg, bundle["params"], bundle["batch"],
                               cell.seq_len)
        return run

    def run():
        with torch.no_grad():
            return decode_step(cfg, bundle["params"], bundle["cache"],
                               bundle["batch"]["tokens"], bundle["pos"])
    return run


def fake_account(cfg, cell: ShapeCell, *, device="cpu",
                 track_memory: bool = False) -> Dict[str, Any]:
    """Run ``cell``'s step once over fake tensors on ``device`` under the
    accountant → ``{"accounting", "moe_load", "global_peak_bytes",
    "seconds"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    meta = input_specs(cfg, cell)
    t0 = time.perf_counter()
    with FakeTensorMode() as fake:
        bundle = {k: (_fake_like(v, device) if k != "cell" else v)
                  for k, v in meta.items()}
        routing = BalancedRouting(cfg.moe.num_experts) if cfg.moe else None
        tracker = None
        with contextlib.ExitStack() as stack:
            if routing is not None:
                stack.enter_context(routing)
            if track_memory:
                from torch.distributed._tools.mem_tracker import MemTracker
                tracker = MemTracker()
                tracker.track_external(*[v for k, v in bundle.items()
                                         if k != "cell"])
                stack.enter_context(tracker)
            acct = stack.enter_context(Accountant())
            stack.enter_context(loops_counted_once(acct))
            _step_thunk(cfg, cell, bundle)()
    del fake
    peak = None
    if tracker is not None:
        peak = sum(int(d.get("Total", 0)) for d in
                   tracker.get_tracker_snapshot("peak").values())
    moe_load = None
    if routing is not None:
        m = cfg.moe
        B = cell.global_batch
        T = 1 if cell.kind == "decode" else cell.seq_len
        moe_load = (f"balanced: each expert's nonzero answered with "
                    f"B*T*K/E = {B}*{T}*{m.top_k}/{m.num_experts} = "
                    f"{B * T * m.top_k // m.num_experts} rows "
                    f"({routing.calls} calls); training capacity keeps all")
    return {"accounting": acct.result(), "moe_load": moe_load,
            "global_peak_bytes": peak,
            "seconds": time.perf_counter() - t0}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               seq_shard: bool = False, verbose: bool = True
               ) -> Dict[str, Any]:
    """Account one (arch × shape × mesh) cell over fake tensors → its
    JSON record."""
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    if shape_name in cfg.skip_shapes:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "full-attention arch skips long_500k (DESIGN.md)"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh)
    chips = mesh_chips(mesh)
    bundle = input_specs(cfg, cell)
    p_sh = params_shardings(cfg, mesh, bundle["params"])
    b_sh = batch_shardings(cfg, mesh, bundle["batch"], seq_shard=seq_shard)
    args = [(bundle["params"], p_sh), (bundle["batch"], b_sh)]
    if cell.kind == "train":
        args.append((bundle["opt"], opt_shardings(
            cfg, mesh, bundle["params"], bundle["opt"], optimizer_kind(cfg))))
    if cell.kind == "decode":
        args.append((bundle["cache"],
                     cache_shardings(cfg, mesh, bundle["cache"])))
        args.append((bundle["pos"], ()))

    run = fake_account(cfg, cell, track_memory=True)
    acc = run["accounting"]
    coll = collective_estimate(cfg, mesh, bundle["params"], p_sh,
                               cell.kind == "train")
    mem = {"argument_bytes_per_device": argument_bytes_per_device(mesh, args),
           "global_peak_bytes": run["global_peak_bytes"]}
    rl = Roofline(arch=arch, shape=shape_name, mesh=name, chips=chips,
                  hlo_flops=float(acc["flops"]),
                  hlo_bytes=float(acc["hbm_bytes"]), coll_bytes=coll,
                  model_flops=model_flops(cfg, cell),
                  bytes_per_device=mem["argument_bytes_per_device"])
    from repro_torch.models.model import _REMAT_POLICY
    result = {
        "arch": arch, "shape": shape_name, "mesh": name, "status": "ok",
        "chips": chips, "trace_s": round(run["seconds"], 1),
        "flops": rl.hlo_flops, "bytes": rl.hlo_bytes,
        "bytes_scope": "unfused aten reads and writes: an upper bound",
        "flops_by_op": acc["flops_by_op"],
        "collective_bytes": rl.coll_bytes,
        "collective_scope": COLLECTIVE_SCOPE,
        "memory": mem, "n_nodes": acc["n_nodes"],
        "moe_load": run["moe_load"],
        "remat": {"active": bool(cfg.remat) and cell.kind == "train",
                  "policy": _REMAT_POLICY},
        "seq_shard": seq_shard,
        "model_flops": rl.model_flops,
        "t_compute_ms": rl.t_compute * 1e3,
        "t_memory_ms": rl.t_memory * 1e3,
        "t_collective_ms": rl.t_collective * 1e3,
        "dominant": rl.dominant,
        "useful_fraction": rl.useful_fraction,
        "roofline_fraction": rl.roofline_fraction,
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {name}] OK "
              f"comp={rl.t_compute*1e3:.2f}ms mem={rl.t_memory*1e3:.2f}ms "
              f"coll={rl.t_collective*1e3:.2f}ms dom={rl.dominant} "
              f"useful={rl.useful_fraction*100:.0f}% "
              f"roofline={rl.roofline_fraction*100:.1f}% "
              f"(fake run {run['seconds']:.1f}s, {acc['n_nodes']} ops)",
              flush=True)
        print(f"    memory: {mem}", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seq-shard", action="store_true",
                    help="SP: shard the sequence dim over the model axis")
    ap.add_argument("--paper-baseline", action="store_true",
                    help="full remat (the reference's other knobs of this "
                         "flag have no counterpart in the port)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.paper_baseline:
        from repro_torch.models.model import set_remat_policy
        set_remat_policy("full")
    os.makedirs(args.out, exist_ok=True)
    archs = all_arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]

    failures = 0
    for arch, shape in cells:
        tag = (f"{arch}__{shape}__"
               f"{mesh_name(make_production_mesh(multi_pod=args.multi_pod))}")
        try:
            res = lower_cell(arch, shape, multi_pod=args.multi_pod,
                             seq_shard=args.seq_shard)
        except Exception as e:  # a cell failure is a bug in the system
            failures += 1
            res = {"arch": arch, "shape": shape, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[{arch} × {shape}] FAILED: {type(e).__name__}: {e}",
                  flush=True)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    print(f"\n{len(cells) - failures}/{len(cells)} cells OK")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
