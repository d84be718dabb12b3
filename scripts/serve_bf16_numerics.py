"""How bf16 rounding shows in the serving path, on the CPU at reduced depth.

    PYTHONPATH=src python scripts/serve_bf16_numerics.py masks [--bf16-grad]
    PYTHONPATH=src python scripts/serve_bf16_numerics.py depth

``masks``: phi4-mini at full width and 8 layers (vocab cut to 4096), bf16
compute, B=2, a 512-token prompt, 4 decode steps, max_len 1024; scrutinize
``resume_fn(2)`` probed at pos + 2 with 2 probes and count the cache
elements whose mask differs from the analytic selector (slot < pos + 2).
``--bf16-grad`` scrutinizes a resume function that keeps the cache in bf16
(``Engine.resume_fn`` without its f32 cast), so the vjp sums a slot's
gradient terms in bf16.  About 4 GB of memory.

``depth``: phi4-mini shaped at width 768 (vocab 8192), bf16 compute, B=2,
T=256; the prefill logits of the plain attention against the same
attention summed in another order (``ref.flash_attention_tiled``: online
softmax over K6's 64-key tiles), at 4, 16 and 32 layers: how far one-ulp
differences grow with depth.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import Engine, ScrutinyConfig, get_config, scrutinize
from repro_torch.models import compute_params, decode_step, init_params
from repro_torch.models import attention as attn_mod
from repro_torch.models import prefill
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_tiled)


def _mask_mismatches(rep, pos):
    out = {}
    for name in sorted(rep.leaves):
        if name.startswith("cache"):
            leaf = rep.leaves[name]
            m = np.asarray(leaf.mask).reshape(leaf.shape)
            sel = (np.arange(leaf.shape[2]) < pos).reshape(1, 1, -1, 1, 1)
            out[name] = int((m != sel).sum())
    return out


def masks(bf16_grad: bool) -> None:
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=8,
                              vocab=4096)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab, (2, 512))
    eng = Engine(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                 1024, device="cpu")
    st = eng.start({"tokens": torch.from_numpy(prompt).to(torch.int32)})
    for _ in range(4):
        st, _ = eng.step(st)
    pos = int(st["pos"]) + 2
    fn = eng.resume_fn(2)
    if bf16_grad:
        def fn(state, n=2):
            s, out = dict(state), []
            for _ in range(n):
                logits, cache = decode_step(cfg, eng._compute, s["cache"],
                                            s["tokens"], s["pos"])
                s = {"cache": cache, "pos": s["pos"] + 1,
                     "tokens": logits.argmax(-1)[:, None].int()}
                out.append(logits)
            return torch.stack(out)
    rep = scrutinize(fn, dict(st, pos=torch.tensor(pos, dtype=torch.int32)),
                     config=ScrutinyConfig(probes=2), device="cpu")
    print(f"masks: {'bf16' if bf16_grad else 'f32'} gradient sums; "
          f"elements off the selector slot < {pos}: "
          f"{_mask_mismatches(rep, pos)}")


def depth() -> None:
    real = attn_mod.flash_attention
    for n_layers in (4, 16, 32):
        cfg = dataclasses.replace(get_config("phi4-mini-3.8b"),
                                  n_layers=n_layers, d_model=768, n_heads=6,
                                  n_kv_heads=2, d_ff=2048, vocab=8192)
        params = compute_params(cfg, init_params(
            cfg, torch.Generator().manual_seed(1)))
        toks = torch.randint(0, cfg.vocab, (2, 256), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(2))
        out = {}
        try:
            for tag, fa in (("plain", flash_attention_ref),
                            ("online", flash_attention_tiled)):
                attn_mod.flash_attention = fa
                with torch.no_grad():
                    out[tag] = prefill(cfg, params, {"tokens": toks},
                                       256)[0].float()
        finally:
            attn_mod.flash_attention = real
        d = out["online"] - out["plain"]
        print(f"depth: {n_layers} layers, max |logit| "
              f"{float(out['plain'].abs().max()):.4f}, max |Δ| "
              f"{float(d.abs().max()):.4f}, relative L2 "
              f"{float(d.norm() / out['plain'].norm()):.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["masks", "depth"])
    ap.add_argument("--bf16-grad", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    masks(args.bf16_grad) if args.what == "masks" else depth()
