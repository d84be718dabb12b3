"""A cell at a tiny size on the CPU: the port's smoke variant of the cell's
model (``ArchConfig.reduced``: float32 compute) and short traffic, through
the whole of ``run_cell``."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# float32 end to end: the served tokens agree with the reference to
# round-off, and a wrong token lies a whole logit gap (~1e-2) below
GAP_LIMIT = 1e-3


def limits(cell: str) -> dict:
    """The cell's limits at the tiny size: its exact numbers as they are,
    its gap numbers held at float32 round-off."""
    from portbench import bench
    out = {}
    for k, v in bench.limits(cell).items():
        if k == "logit_gap":
            out[k] = GAP_LIMIT
        elif k.startswith("gaps_over_"):
            out[f"gaps_over_{GAP_LIMIT}"] = 0
        else:
            out[k] = v
    return out


def arguments(cell: str) -> dict:
    """``run_cell``'s keyword arguments for ``cell`` at the tiny size."""
    from repro_torch import get_config
    cfg = get_config(cell.rsplit(".", 1)[0]).reduced()
    over = {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "vocab_size": cfg.vocab,
            "compute_dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
            "intermediate_size": cfg.d_ff}
    if cfg.moe is not None:
        over.update(num_experts=cfg.moe.num_experts,
                    num_experts_per_tok=cfg.moe.top_k,
                    intermediate_size=cfg.moe.d_expert)
    traffic = {"prompt_len": 32, "max_len": 96}
    if cell.endswith(".snapshot"):
        traffic["cover"] = 40
    arch, mix = cell.rsplit(".", 1)
    return {"device": "cpu", "port_cfg": cfg, "config_overrides": over,
            "workload": {"name": cell, "config": arch, "traffic": mix,
                         "chips": 1},
            "traffic_overrides": traffic,
            "limits": limits(cell)}


def run(cell: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5,
        traced: bool = False) -> dict:
    from portbench.run import run_cell
    return run_cell(cell, seed, seconds, traced, **arguments(cell))
