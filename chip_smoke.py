"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` (one nvcc per source,
all started together) and checks each against its plain PyTorch version on
the card, then drives the port's paths: the paper's pipeline
(scrutinize → device-packed save → delta chain → device restore) at a
≈2.5 GiB state, with a manager that re-scrutinizes at every save (the
unchanged report keeps the chain) and a precision-tiered round trip; the
coordinated save of that state by four host threads (base, delta,
unchanged delta restored 4 → 1 through its chain, a degraded commit with one host killed after its partner
replica landed, restores from the partner with no store read, 4 → 1
through the scatter kernel and a single-process checkpoint 1 → 4, the
fused telemetry rendered by the report CLI), the launcher as a
coordinated job of two processes resumed by one, and a gloo group's
``TorchCollective``; the serving path (phi4-mini-3.8b at full width and depth: prefill through
flash attention, decode, KV scrutiny, base + delta snapshots, restore,
exact continuation); the rest of the model families served the same way
(olmoe-1b-7b at full width and depth, deepseek-v3-671b's MLA and MoE,
whisper-tiny's encoder-decoder, qwen2-vl-7b's M-RoPE, the last three cut
in depth; flash attention at each one's shape against its plain version,
and prefill + decode against each model's own full forward); the paper's
NPB evaluation (the eight class-S
programs: AD scrutiny in f64, participation over the traced aten graph
and its Table II, FT y included, the static analyzer's soundness check
and the pruned sweep, the §IV-C restart from both masks through the tiled
pack and one unpack launch a restart, scrutinized saves and restores that
verify, Table III); and the training path (recurrentgemma-2b at full
width, depth cut to fit: train steps through the RG-LRU scan and flash
attention forward and backward, AD scrutiny of the training state, the
scrutinized save and the save with no report (device clones), a
coordinated save by four host threads restored onto one, restores and
continuations, the launcher's own smoke run, its resume traced with
K6 and K7 as custom-op nodes, and one step's loss and gradients with
rematerialization off, "full" and "dots"); the serving sessions (four
phi4-mini-3.8b sessions on two host threads: scrutinized base and delta
snapshots, migration to a fresh manager, a host killed mid-snapshot and
its sessions adopted up to capacity); the compressed data-parallel step
(recurrentgemma-2b, 3 layers) and GPipe (phi4-mini's blocks, 2 stages),
each as two processes sharing the card in a gloo group; and the launch
tooling (the nvcc build cache cold, warm and off; the dry run's FLOP count
over fake tensors equal to the real step's for phi4-mini's prefill and
recurrentgemma-2b's train step, each timed against ``model_flops`` and the
roofline's bound; olmoe's balanced routing against its real routing; a
production cell's dry run).  It checks the
hardware-independent byte counts of the reference bench state and times
every kernel.  Any failed check raises and ends the run with a non-zero
exit; the second-to-last line is the kernels JSON, the last the device
JSON.  It needs one card and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import _tree  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref, flash_attention_tiled, tiled_attention)
from repro_torch.kernels.lru_scan import kernel as LK  # noqa: E402
from repro_torch.kernels.lru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.lru_scan.ref import (  # noqa: E402
    BWD_CHUNK, FWD_CHUNK, lru_scan_backward_chunked_ref, lru_scan_chunked_ref,
    lru_scan_ref)
from repro_torch.kernels.mask_pack import kernel as K  # noqa: E402
from repro_torch.kernels.mask_pack import ops, ref  # noqa: E402
from repro_torch.core.regions import mask_to_regions  # noqa: E402

DEV = "cuda"
DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
          torch.complex128, torch.int32, torch.bool)
DENSITIES = (0.0, 0.03, 0.5, 1.0)
SIZES = (1, 511, 513, (1 << 20) + 7)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def values(n: int, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.rand(n, generator=gen, device=DEV) < 0.5
    if dtype == torch.int32:
        return torch.randint(-2 ** 30, 2 ** 30, (n,), generator=gen,
                             device=DEV, dtype=torch.int32)
    if dtype.is_complex:
        return torch.randn(n, generator=gen, device=DEV, dtype=dtype)
    return torch.randn(n, generator=gen, device=DEV).to(dtype)


def selector(n: int, frac: float, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=DEV) < frac


def poison(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """±inf, NaN and -0.0 at the first uncritical and the first critical
    positions of a float or complex tensor."""
    x = x.clone()
    for side in (~mask, mask):
        idx = torch.nonzero(side).reshape(-1)[:4]
        for v, i in zip((float("inf"), float("-inf"), float("nan"), -0.0),
                        idx):
            x[i] = v
    return x


# ----------------------------------------------------------------------------
# phase 1: the card and the build
# ----------------------------------------------------------------------------

def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {line}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:     # one nvcc per source
        for fut in [pool.submit(m.load_library) for m in (K, FK, LK)]:
            fut.result()
    print(f"build: {time.perf_counter() - t0:.3f} s for the three libraries")
    for m in (K, FK, LK):
        info = m.BUILD_INFO
        print(f"build: {'compiled' if info['built'] else 'cached'} "
              f"{os.path.basename(str(info['so']))} in "
              f"{info['seconds']:.3f} s")
    fa_build_report()
    return line


def fa_build_report() -> None:
    """K6's kernels as built: registers and spills per instantiation
    (``-Xptxas -v``), and the tensor-core (HMMA) and f32 FMA (FFMA)
    instructions in each one's SASS (``cuobjdump -sass``).  Every bf16
    (``_tc_``) instantiation must run its products on the tensor cores."""
    info = FK.BUILD_INFO
    fn, regs = None, {}
    for ln in str(info["log"]).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            regs.setdefault(fn, {})["spill"] = [int(x) for x in m.groups()]
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            regs.setdefault(fn, {})["regs"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(info["so"])],
                          capture_output=True, text=True, check=True).stdout
    fn, ops = None, {}
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            ops[fn] = {"HMMA": 0, "FFMA": 0}
        elif fn:
            for op in ops[fn]:
                ops[fn][op] += bool(re.search(rf"\b{op}\b", ln))
    tc = [f for f in ops if "_tc_kernel" in f]
    check(len(tc) == 9 and all(ops[f]["HMMA"] > 0 for f in tc),
          f"K6's bf16 kernels without HMMA in their SASS: {ops}")
    for f in sorted(ops):
        name = re.sub(r"^.*?\d+(fa_\w+?_kernel)", r"\1", f)
        r = regs.get(f, {})
        print(f"build K6 {name}: registers {r.get('regs', 'cached')}, "
              f"spill stores/loads {r.get('spill', 'cached')} B, SASS "
              f"{json.dumps(ops[f])}")


# ----------------------------------------------------------------------------
# phase 2: every kernel against its plain version, bit for bit
# ----------------------------------------------------------------------------

def word_forms(sel: torch.Tensor) -> dict:
    """The mask ``sel`` as K2 and K4 read it, ``np.packbits`` words, in
    three forms that must give the same bytes: as packed, with the tail
    bits past N set, and at an odd address (copied by the wrapper)."""
    n = sel.numel()
    words = ops.mask_to_words(sel)
    tail = words.clone()
    if n % 8:
        tail[-1] |= (1 << (8 - n % 8)) - 1
    odd = torch.empty(words.numel() + 1, dtype=torch.uint8, device=DEV)[1:]
    odd.copy_(tail)
    return {"words": words, "tail bits set": tail, "odd address": odd}


def phase_kernels() -> int:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    cases = groups = 0
    for n in SIZES:
        for frac in DENSITIES:
            sel = selector(n, frac, gen)
            forms = word_forms(sel)
            check(same_bytes(forms["words"], ref.bitpack_ref(
                sel.to(torch.float32), 0.0)[0]),
                  f"mask_to_words n={n} frac={frac}")
            # K8: the words of the mask's region table (no run at frac 0)
            table = torch.from_numpy(
                mask_to_regions(sel.cpu().numpy())).to(DEV)
            w8 = ops.regions_words(table, n=n)
            check(same_bytes(w8, forms["words"])
                  and same_bytes(w8, ref.regions_words_ref(table, n)),
                  f"K8 n={n} frac={frac} ({table.shape[0]} runs)")
            cases += 1
            # the dense pack's leaves: a 3-element all-critical head puts
            # the later leaves at odd offsets of the payload
            head = min(3, n)
            head_w = ops.mask_to_words(torch.ones(head, dtype=torch.bool,
                                                  device=DEV))
            half = sel[: n // 2]
            half_w = ops.mask_to_words(half)
            # K1: f32 / f64 magnitudes, zero where not selected, plus NaN
            for dt in (torch.float32, torch.float64):
                mag = torch.rand(n, generator=gen, device=DEV,
                                 dtype=dt) + 0.5
                mag = torch.where(sel, mag, torch.zeros_like(mag))
                for m in (mag, poison(mag, sel)):
                    w, c = ops.threshold_bitpack(m, 0.0)
                    w_r, c_r = ref.bitpack_ref(m, 0.0)
                    check(same_bytes(w, w_r) and same_bytes(c, c_r),
                          f"K1 {dt} n={n} frac={frac}")
                    cases += 1
            group = []      # K5's leaves of every width, for one group
            for dt in DTYPES:
                x = values(n, dt, gen)
                inexact = dt.is_floating_point or dt.is_complex
                xs = [x] + ([poison(x, sel)] if inexact else [])
                for v in xs:
                    # K2 tiled form, from each form of the words
                    p_r, c_r = ref.pack_blocks_ref(v, sel)
                    for how, w in forms.items():
                        p, c = ops.pack(v, w)
                        check(same_bytes(p, p_r) and same_bytes(c, c_r),
                              f"K2 tiled {dt} n={n} frac={frac} {how}")
                    # K5 back from the tiles, from each form of the words
                    # (the odd-address words with the tiles at an odd
                    # element address too), fill 0 and a non-zero fill;
                    # the critical values come back as they went in
                    odd_p = torch.empty(p.numel() + 1, dtype=dt,
                                        device=DEV)[1:]
                    odd_p.copy_(p.reshape(-1))
                    for how, w in forms.items():
                        src = odd_p.view(p.shape) if how == "odd address" \
                            else p
                        for fill in (0, 1):
                            o = ops.unpack(src, w, n=n, fill=fill)
                            check(same_bytes(o, ref.unpack_blocks_ref(
                                p, sel, fill)) and same_bytes(o[sel], v[sel]),
                                  f"K5 {dt} n={n} frac={frac} fill={fill} "
                                  f"{how}")
                    group.append((p, v))
                    # K2 dense form (pack_group), K4 back from its payload
                    total = int(c_r.sum())
                    pay_w = ref.pack_payload_ref(v, sel, total)[0]
                    pay_r = torch.cat([v[:head], pay_w, v[: n // 2][half]])
                    for how, w in forms.items():
                        pay, cg = ops.pack_group(
                            [v[:head], v, v[: n // 2]], [head_w, w, half_w],
                            [head, total, int(half.sum())])
                        check(same_bytes(pay, pay_r),
                              f"K2 dense {dt} n={n} frac={frac} {how}")
                        for fill in (0, 1):
                            o = ops.mask_scatter(pay[head:head + total], w,
                                                 n=n, fill=fill)
                            o_r = ref.mask_scatter_ref(pay_w, sel, fill)
                            check(same_bytes(o, o_r),
                                  f"K4 {dt} n={n} frac={frac} fill={fill} "
                                  f"{how}")
                    cases += 1
                    if dt.is_complex:
                        continue     # delta saves write complex leaves whole
                    # K3 against a copy changed at the selected positions
                    b = v.clone()
                    b[sel] = values(int(sel.sum()), dt, gen) if dt != torch.bool \
                        else ~b[sel]
                    for base in (v, b):
                        c8, b8 = ops.as_bytes(v), ops.as_bytes(base)
                        f = K.delta_flags(c8, b8, ops.DELTA_CHUNK_BYTES)
                        f_r = ref.delta_flags_ref(c8, b8, ops.DELTA_CHUNK_BYTES)
                        check(same_bytes(f, f_r),
                              f"K3 {dt} n={n} frac={frac}")
                    # K3 on a misaligned slice (a leaf inside a group)
                    if n > 16:
                        c8 = ops.as_bytes(v)[3:]
                        b8 = ops.as_bytes(b)[3:]
                        check(same_bytes(K.delta_flags(c8, b8, 2048),
                                         ref.delta_flags_ref(c8, b8, 2048)),
                              f"K3 unaligned {dt} n={n} frac={frac}")
            groups += unpack_group_cases(group * 3, sel, forms)
    torch.cuda.synchronize()
    print(f"kernels: {cases} cases bit-identical to the plain versions, "
          f"K5 also in {groups} mixed-width groups; comparison launches "
          f"{json.dumps(K.LAUNCHES)}")
    return cases


def unpack_group_cases(leaves, sel, forms) -> int:
    """K5 over one list of leaves of mixed widths (each leaf's tiled pack
    and values, all under the mask ``sel``), from each form of the words,
    fill 0 and 1: each output bit for bit the plain version's and its
    leaf's own ``unpack``; a list longer than the launch's leaf table
    takes one launch per ``K.UNPACK_GROUP_LEAVES`` leaves."""
    n = sel.numel()
    launches = -(-len(leaves) // K.UNPACK_GROUP_LEAVES)
    for how, w in forms.items():
        for fill in (0, 1):
            before = K.LAUNCHES["unpack"]
            got = ops.unpack_group([p for p, _ in leaves],
                                   [w] * len(leaves), [n] * len(leaves),
                                   fill=fill)
            check(K.LAUNCHES["unpack"] == before + launches,
                  f"K5 group of {len(leaves)}: "
                  f"{K.LAUNCHES['unpack'] - before} launches")
            for (p, v), o in zip(leaves, got):
                check(same_bytes(o, ref.unpack_blocks_ref(p, sel, fill))
                      and same_bytes(o, ops.unpack(p, w, n=n, fill=fill))
                      and same_bytes(o[sel], v[sel]),
                      f"K5 group {p.dtype} n={n} fill={fill} {how}")
    return len(forms) * 2


# K1's edges: N % 4, N % 32 and N % 1024 non-zero, one short of and one
# past a 32-element word and a 1024-element tile, and a leaf of 2^20 + 5
K1_SIZES = (1, 3, 31, 33, 1023, 1025, 4097, (1 << 20) + 5)


def phase_bitpack_edges() -> int:
    """K1 bit for bit against ``bitpack_ref`` at ragged sizes, f32 and f64,
    with NaN and ±inf magnitudes, tol 0 and 0.5, on a fresh tensor and on
    a view one element (4 or 8 bytes) past a 16-byte boundary, which takes
    the kernel's unaligned variant."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1235)
    cases = 0
    for n in K1_SIZES:
        for dt in (torch.float32, torch.float64):
            mag = torch.rand(n + 1, generator=gen, device=DEV, dtype=dt)
            mag = torch.where(mag < 0.3, torch.zeros_like(mag), mag)
            for v, i in ((float("nan"), 5), (float("inf"), 7),
                         (float("-inf"), 11)):
                mag[i % (n + 1)::i] = v
            for skip in (0, 1):
                m = mag[skip:skip + n]
                check(m.data_ptr() % 16 == skip * m.element_size(),
                      f"K1 edge n={n} {dt}: view at {m.data_ptr() % 16}")
                for tol in (0.0, 0.5):
                    w, c = ops.threshold_bitpack(m, tol)
                    w_r, c_r = ref.bitpack_ref(m, tol)
                    check(same_bytes(w, w_r) and same_bytes(c, c_r),
                          f"K1 n={n} {dt} offset {skip} tol={tol}")
                    cases += 1
    torch.cuda.synchronize()
    print(f"K1 edges: {cases} cases bit-identical to bitpack_ref (n "
          f"{list(K1_SIZES)}, f32 and f64, NaN and ±inf, tol 0 and 0.5, "
          f"aligned and one element past a 16-byte boundary)")
    return cases


# K6 cases: (B, T, H, K, D, Dv, window, causal, cap, dtype), T an int or
# (Tq, Tk).  The first eight are tests/test_kernels.py:24-33; then ragged T
# (causal and not), Dv != D, D = 256, and window + softcap in bf16 and f16;
# then the bf16 tensor-core kernels' edges: D and Dv off the 16-column grid
# (72 and 40; 8; 17 and 9, which take plain loads), T = 1, T one past a
# 64-row and a 32-query tile, T = 1025, MHA and MQA at D = 256 with a
# window shorter than T, and Tq != Tk both ways.
FA_CASES = [
    (1, 128, 4, 4, 64, 64, None, True, None, torch.float32),
    (2, 256, 8, 2, 64, 64, None, True, None, torch.float32),
    (1, 256, 4, 1, 128, 128, None, True, None, torch.float32),
    (1, 256, 4, 4, 64, 64, 128, True, None, torch.float32),
    (1, 256, 4, 2, 64, 64, None, True, 50.0, torch.float32),
    (1, 256, 4, 2, 64, 64, 128, True, 50.0, torch.bfloat16),
    (2, 128, 2, 2, 256, 256, None, True, None, torch.float32),
    (1, 128, 4, 4, 64, 64, None, False, None, torch.float32),
] + [(2, t, 8, 2, 128, 128, None, causal, None, dt)
     for t in (1, 17, 200, 1000) for causal in (True, False)
     for dt in (torch.float32, torch.bfloat16)] + [
    (1, 300, 6, 3, 96, 32, None, True, None, torch.float16),
    (2, 333, 4, 2, 256, 256, None, True, None, torch.bfloat16),
    (2, 1000, 8, 4, 256, 256, 100, True, 50.0, torch.bfloat16),
    (2, 1000, 8, 4, 128, 128, 100, True, 50.0, torch.float16),
    (1, 777, 24, 8, 128, 128, 64, True, 30.0, torch.float32),
] + [
    (1, 77, 4, 2, 72, 40, 20, True, None, torch.bfloat16),
    (2, 50, 4, 4, 8, 8, None, False, None, torch.bfloat16),
    (1, 40, 2, 1, 17, 9, None, True, 20.0, torch.bfloat16),
    (2, 1, 8, 1, 256, 256, None, True, None, torch.bfloat16),
    (2, 65, 8, 2, 128, 128, None, True, None, torch.bfloat16),
    (2, 33, 8, 2, 128, 128, None, False, None, torch.bfloat16),
    (1, 1025, 4, 1, 128, 128, None, True, None, torch.bfloat16),
    (1, 300, 4, 4, 256, 256, 100, True, None, torch.bfloat16),
    (2, 300, 8, 1, 256, 256, 100, True, None, torch.bfloat16),
    (1, (100, 150), 4, 2, 64, 64, None, True, None, torch.bfloat16),
    (1, (150, 100), 4, 2, 64, 64, 60, False, 30.0, torch.bfloat16),
]


def fa_inputs(case, gen):
    """q, k, v, a cotangent do, and the keyword arguments of a K6 case."""
    B, T, H, Kh, D, Dv, window, causal, cap, dt = case
    Tq, Tk = T if isinstance(T, tuple) else (T, T)
    q, k, v, do = (torch.randn(s, generator=gen, device=DEV).to(dt) for s in
                   ((B, Tq, H, D), (B, Tk, Kh, D), (B, Tk, Kh, Dv),
                    (B, Tq, H, Dv)))
    return q, k, v, do, dict(window=window, causal=causal, scale=D ** -0.5,
                             attn_cap=cap)


def fa_tol(dtype: torch.dtype) -> float:
    """test_kernels.py:48: 2e-5 in f32 (sums in another order), 2e-2 in
    bf16/f16 (the output's one rounding), as atol and rtol."""
    return 2e-5 if dtype == torch.float32 else 2e-2


def fa_err(got: torch.Tensor, want: torch.Tensor, tol: float,
           what: str = "K6") -> float:
    """max |got - want|; raises where |Δ| > tol + tol·|want|."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    check(bool(torch.isfinite(g).all()) and bool((d <= tol + tol * w.abs())
                                                 .all()),
          f"{what} differs from its plain version by {float(d.max())}")
    return float(d.max())


def scaled_err(got: torch.Tensor, want: torch.Tensor, tol: float,
               what: str) -> tuple:
    """max |Δ| against ``tol`` times the largest |want| (as the port's
    gradient tests hold gradients): raises where it is more.  The
    gradients of a mean loss lie far below 1, where :func:`fa_err`'s
    absolute term alone would pass a kernel that returned zeros.
    → (max |Δ|, max |Δ| / max |want|)."""
    g, w = got.float(), want.float()
    top = float(w.abs().max()) if w.numel() else 0.0
    worst = float((g - w).abs().max()) if w.numel() else 0.0
    check(bool(torch.isfinite(g).all()) and worst <= tol * top,
          f"{what} differs from its plain version by {worst}, more than "
          f"{tol} x its largest |value| {top}")
    return worst, (worst / top if top else worst)


def lru_tol(dtype: torch.dtype) -> float:
    """K7: 1e-5 in f32 (one rounding a step, in another order), 2e-2 in
    bf16 (the output's one rounding), as atol and rtol."""
    return 1e-5 if dtype == torch.float32 else 2e-2


def lru_plain_grads(a, b, h0, dh):
    """The plain version's output and its gradient, by ``torch.func.vjp``,
    which also runs inside a custom op's implementation (below autograd,
    where KernelCheck holds the kernels)."""
    ins = [t.detach() for t in [a, b] + ([] if h0 is None else [h0])]
    with torch.enable_grad():
        h, vjp = torch.func.vjp(lru_scan_ref, *ins)
        return h.detach(), vjp(dh)


def fa_plain_grads(q, k, v, do, **kw):
    """flash_attention_ref's output and its gradient, as
    :func:`lru_plain_grads`."""
    def ref(q, k, v):
        return flash_attention_ref(q, k, v, **kw)

    with torch.enable_grad():
        o, vjp = torch.func.vjp(ref, *(t.detach() for t in (q, k, v)))
        return o.detach(), vjp(do)


# K7 cases: B, T, R, h0 and dtype.  B = 2 with T around the backward's
# 8-step chunks and 128-step segments (T = 1024, R = 2560: the training
# path's shape); then B = 1, T one short of and one past 32, and T = 4096.
LRU_CASES = [(2, t, r, h0, dt) for t in (1, 7, 31, 33, 256, 1000, 1024)
             for r in (100, 2560)
             for h0 in (True, False)
             for dt in (torch.float32, torch.bfloat16)] + [
    (1, t, r, h0, dt) for t, r in ((31, 100), (33, 2560), (4096, 2560))
    for h0 in (True, False) for dt in (torch.float32, torch.bfloat16)]


def phase_lru_scan() -> int:
    """K7 forward and backward against the plain version and autograd's
    gradient through it; each also against its CPU model's order
    (``lru_scan_chunked_ref`` and ``lru_scan_backward_chunked_ref`` at the
    kernels' chunk): the forward bit for bit, the backward within the
    tolerance; the forward's first chunk bit for bit the plain version's;
    two launches of each on the same inputs must give the same bytes."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(78)
    worst, model = {}, {}
    for B, T, R, with_h0, dt in LRU_CASES:
        a = torch.rand((B, T, R), generator=gen, device=DEV).to(dt)
        b = torch.randn((B, T, R), generator=gen, device=DEV).to(dt)
        h0 = (torch.randn((B, R), generator=gen, device=DEV).to(dt)
              if with_h0 else None)
        dh = torch.randn((B, T, R), generator=gen, device=DEV).to(dt)
        h = lru_ops.lru_scan(a, b, h0)
        grads = LK.lru_scan_backward(a, h, h0, dh)
        again = LK.lru_scan_backward(a, h, h0, dh)
        what = f"K7 B={B} T={T} R={R} h0={with_h0} {dt}"
        check(same_bytes(h, LK.lru_scan(a, b, h0)),
              f"{what}: two forward launches on the same inputs differ")
        check(all(x is None or same_bytes(x, y)
                  for x, y in zip(grads, again)),
              f"{what}: two backward launches on the same inputs differ")
        h_r, grads_r = lru_plain_grads(a, b, h0, dh)
        check(same_bytes(h[:, :FWD_CHUNK], h_r[:, :FWD_CHUNK]),
              f"{what}: the forward's first chunk differs from the plain "
              f"version's")
        check(same_bytes(h, lru_scan_chunked_ref(a, b, h0)),
              f"{what}: the forward differs from its chunked CPU model")
        chunked = lru_scan_backward_chunked_ref(a, h, h0, dh)
        tol = lru_tol(dt)
        for tag, got, want in zip(("fwd", "da", "db", "dh0"),
                                  (h,) + tuple(grads), (h_r,) + grads_r):
            if want is not None:
                worst[f"{dt} {tag}"] = max(worst.get(f"{dt} {tag}", 0.0),
                                           fa_err(got, want, tol,
                                                  f"{what} {tag}"))
        for tag, got, want in zip(("da", "db", "dh0"), grads, chunked):
            if want is not None:
                model[f"{dt} {tag}"] = max(model.get(f"{dt} {tag}", 0.0),
                                           fa_err(got, want, tol,
                                                  f"{what} {tag} model"))
    torch.cuda.synchronize()
    print(f"K7: {len(LRU_CASES)} cases, forward and backward within "
          f"tolerance of the plain version (f32 1e-5, bf16 2e-2), each "
          f"deterministic over two launches, the forward's first "
          f"{FWD_CHUNK} steps bit for bit the plain version's; max |err| "
          f"{json.dumps(worst)}; the forward bit for bit its chunked CPU "
          f"model (chunk {FWD_CHUNK}); the backward against its model "
          f"(chunk {BWD_CHUNK}) max |err| {json.dumps(model)}; comparison "
          f"launches "
          f"{json.dumps(LK.LAUNCHES)}")
    return len(LRU_CASES)


# K6 backward: the forward's cases, plus MQA at D = 256, Tq = 1024 and
# window 2048 (recurrentgemma's attention) in f32 and bf16
FA_BWD_CASES = FA_CASES + [(2, 1024, 10, 1, 256, 256, 2048, True, None, dt)
                           for dt in (torch.float32, torch.bfloat16)]


def phase_flash_attention_backward() -> int:
    """K6's backward (dq, dk, dv) against autograd through
    flash_attention_ref, at the forward's tolerances; a second launch on
    the same inputs must give the same bytes (no atomics: a restored
    training run continues bitwise)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(79)
    per_case = []
    for case in FA_BWD_CASES:
        q, k, v, do, kw = fa_inputs(case, gen)
        o, lse, o32 = FK.flash_attention(q, k, v, with_lse=True, **kw)
        o = o if o32 is None else o32
        got = FK.flash_attention_backward(q, k, v, o, lse, do, **kw)
        again = FK.flash_attention_backward(q, k, v, o, lse, do, **kw)
        check(all(same_bytes(a, b) for a, b in zip(got, again)),
              f"K6 backward {case}: two launches on the same inputs differ")
        _, want = fa_plain_grads(q, k, v, do, **kw)
        what = f"K6 backward {case}"
        per_case.append(max(fa_err(g, w, fa_tol(q.dtype), f"{what} {tag}")
                            for tag, g, w in zip(("dq", "dk", "dv"), got,
                                                 want)))
    torch.cuda.synchronize()
    print(f"K6 backward: {len(FA_BWD_CASES)} cases within tolerance of "
          f"autograd through the plain version (f32 2e-5, bf16/f16 2e-2), "
          f"each deterministic over two launches; max |err| per case "
          f"{json.dumps([round(e, 8) for e in per_case])}"
          f"; comparison launches {json.dumps(FK.LAUNCHES)}")
    return len(FA_BWD_CASES)


def phase_flash_attention() -> int:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(77)
    worst = {}
    for case in FA_CASES:
        q, k, v, _, kw = fa_inputs(case, gen)
        err = fa_err(fa_ops.flash_attention(q, k, v, **kw),
                     flash_attention_ref(q, k, v, **kw), fa_tol(q.dtype))
        worst[str(q.dtype)] = max(worst.get(str(q.dtype), 0.0), err)
    torch.cuda.synchronize()
    print(f"K6: {len(FA_CASES)} cases within tolerance of the plain version "
          f"(f32 2e-5, bf16/f16 2e-2); max |err| {json.dumps(worst)}; "
          f"comparison launches {json.dumps(FK.LAUNCHES)}")
    return len(FA_CASES)


# ----------------------------------------------------------------------------
# phase 3: the main path at a real size
# ----------------------------------------------------------------------------

N_W, N_B, N_H = 1 << 29, 1 << 26, 1 << 27
# the mask kernels of the checkpoint path (K5 runs on the NPB path only;
# K8 in a device restore of a leaf stored as a region table)
CKPT_KERNELS = ("threshold_bitpack", "pack", "delta_flags", "mask_scatter",
                "regions_words")
CRIT_W = 0.148               # the paper's BT(u) critical fraction
MUTATED = 1 << 18            # 1 MiB of w, changed right after save()


def make_state(gen: torch.Generator):
    state = {
        "w": torch.randn(N_W, generator=gen, device=DEV),
        "b": torch.rand(N_B, generator=gen, device=DEV) + 0.5,
        "h": torch.randn(N_H, generator=gen, device=DEV).to(torch.bfloat16),
        "step": torch.tensor(1, dtype=torch.int32, device=DEV),
    }
    sel_w = torch.rand(N_W, generator=gen, device=DEV) < CRIT_W
    sel_h = torch.zeros(N_H, dtype=torch.bool, device=DEV)
    sel_h[::4] = True
    return state, sel_w, sel_h


def make_resume(sel_w: torch.Tensor, sel_h: torch.Tensor):
    fw = sel_w.float()
    fh = sel_h.float()
    nb = N_B * 7 // 8

    def resume(s):
        return ((s["w"] * fw).sum() + (s["b"][:nb] ** 2).sum()
                + (s["h"].float() * fh).sum())
    return resume


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def restore_k8(mgr, like, what: str, tables: bool = True):
    """``mgr.restore(like)``, checked to launch K8 once for each leaf whose
    words it wrote from the stored region table (``mask_words``), and, with
    ``tables``, to have done so for one leaf at least."""
    before = K.LAUNCHES["regions_words"]
    out = mgr.restore(like)
    words = mgr.last_restore_stats["mask_words"]
    k8 = K.LAUNCHES["regions_words"] - before
    check(k8 == words["regions_on_card"] and (k8 > 0 or not tables),
          f"{what}: K8 launched {k8} times, mask words {words}")
    return out


def phase_setup() -> None:
    """The one-time set-up a process's first ``scrutinize`` pays, measured
    apart from the main path: first on a tiny CPU state (host-side set-up
    only), then on a tiny state on the card."""
    from repro_torch import scrutinize

    def fn(s):
        return (s["x"] ** 2).sum()

    t0 = time.perf_counter()
    scrutinize(fn, {"x": torch.ones(4)}, device="cpu")
    cpu_s = time.perf_counter() - t0
    _, card_s = synced(lambda: scrutinize(
        fn, {"x": torch.ones(4, device=DEV)}, device=DEV))
    print(f"scrutiny set-up: first call on a 4-element CPU state "
          f"{cpu_s:.4f} s, then on the card {card_s:.4f} s")


def phase_main_path(root: str):
    from repro_torch import CheckpointManager, Level, ScrutinyConfig, scrutinize
    from repro_torch.checkpoint import read_manifest

    gen = torch.Generator(device=DEV)
    gen.manual_seed(2026)
    state, sel_w, sel_h = make_state(gen)
    resume = make_resume(sel_w, sel_h)
    full = sum(v.nbytes for v in state.values())
    print(f"main path: state {full} B ({full / 2 ** 30:.3f} GiB)")
    want = {"w": sel_w, "b": torch.arange(N_B, device=DEV) < N_B * 7 // 8,
            "h": sel_h}

    K.reset_launches()
    rep, scrutiny_s = synced(lambda: scrutinize(
        resume, state, config=ScrutinyConfig(probes=4), device=DEV))
    # the same call again, to show what the first one still carries
    del rep
    rep, scrutiny_warm_s = synced(lambda: scrutinize(
        resume, state, config=ScrutinyConfig(probes=4), device=DEV))
    for name, sel in want.items():
        check(torch.equal(rep[name].device_words(), ops.mask_to_words(sel)),
              f"scrutiny mask of {name} differs from its selector")
    check(rep["step"].all_critical, "step must be critical by policy")

    mgr = CheckpointManager([Level(root, keep_n=3, max_chain=2)],
                            scrutiny_fn=lambda s: rep, save_mode="device",
                            restore_mode="device", device=DEV)
    head = state["w"][:MUTATED].clone()
    t0 = time.perf_counter()
    mgr.save(1, state, block=False)
    state["w"][:MUTATED] += 1.0            # in place, right after save()
    stats1 = mgr.wait()
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    like = {k: torch.empty_like(v) for k, v in state.items()}
    (step, r1), _ = synced(lambda: restore_k8(mgr, like, "main step 1"))
    m = sel_w[:MUTATED]
    check(step == 1 and torch.equal(r1["w"][:MUTATED][m], head[m]),
          "step 1 must restore the bytes as they were at save()")
    del r1, head

    mgr.save(2, state, block=True)
    st2 = mgr.last_save_stats
    mgr.save(3, state, block=True)
    st3 = mgr.last_save_stats
    lv2, lv3 = st2["levels"][root], st3["levels"][root]
    m2, m3 = read_manifest(root, 2), read_manifest(root, 3)
    changed2 = sum(e.get("num_chunks", 0) for e in m2["leaves"])
    changed3 = sum(e.get("num_chunks", 0) for e in m3["leaves"])
    check(lv2["kind"] == "delta" and changed2 > 0,
          f"step 2 must be a delta with changed chunks: {lv2}")
    check(lv3["kind"] == "delta" and changed3 == 0 and lv3["delta_bytes"] == 0,
          f"step 3 must be a delta with 0 changed chunks: {lv3}")

    like = {k: torch.empty_like(v) for k, v in state.items()}
    (step, r), restore_s = synced(lambda: restore_k8(mgr, like,
                                                      "main step 3"))
    rst = mgr.last_restore_stats
    check(step == 3, f"latest step is {step}")
    for name, v in state.items():
        mask = want.get(name)
        exp = v if mask is None else torch.where(mask, v, torch.zeros_like(v))
        check(same_bytes(r[name], exp),
              f"restored {name}: critical bytes must match, uncritical = 0")
    out, out_r = resume(state), resume(r)
    check(torch.equal(out, out_r), "resume(restored) != resume(state)")
    # corruption: garbage in every uncritical element changes nothing ...
    for name, mask in want.items():
        g = torch.randn(r[name].shape, generator=gen, device=DEV) * 1e3
        r[name][~mask] = g.to(r[name].dtype)[~mask]
    check(torch.equal(resume(r), out), "uncritical garbage changed the output")
    # ... and 8 corrupted critical elements of w do change it
    idx = torch.nonzero(sel_w)[:8].reshape(-1)
    r["w"][idx] += 1.0
    check(not torch.equal(resume(r), out), "critical corruption went unseen")
    mgr.close()
    del r
    rescrutiny = rescrutiny_chain(os.path.join(root, "rescrutiny"), state,
                                  resume)
    tiers = tiered_round_trip(os.path.join(root, "tiered"), state, sel_w,
                              sel_h)
    launches = {k: K.LAUNCHES[k] for k in CKPT_KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was never launched: {launches}")
    disk = sum(os.path.getsize(os.path.join(root, "step_1", f))
               for f in os.listdir(os.path.join(root, "step_1")))
    print(f"main path: scrutiny_s={scrutiny_s:.4f} "
          f"(again: {scrutiny_warm_s:.4f}) "
          f"blocked_s={stats1['blocked_s']:.4f} save_s={save_s:.4f} "
          f"restore_s={restore_s:.4f} disk_bytes(step 1)={disk} "
          f"d2h_bytes={stats1['d2h_bytes']} h2d_bytes={rst['h2d_bytes']} "
          f"full_bytes={full} delta chunks step2={changed2} step3={changed3}")
    print(f"main path: save stages {json.dumps(dict(stats1['stages']))}")
    print(f"main path: re-scrutiny every save (rescrutinize_every=1): "
          f"{json.dumps(rescrutiny)}")
    print(f"main path: tiered round trip (TIERED_BF16, {N_TIERED} elements "
          f"of w and h): {json.dumps(tiers)}")
    print(f"main path: launches {json.dumps(launches)}")
    return launches, {"state": state, "sel_w": sel_w, "sel_h": sel_h,
                      "rep": rep}


def rescrutiny_chain(root: str, state, resume) -> dict:
    """A manager that re-scrutinizes at every save: the second scrutiny
    finds the same masks, so ``DeviceReport.reuse_unchanged`` hands back
    the identical report object and the chain stays a delta."""
    from repro_torch import (CheckpointManager, Level, ScrutinyConfig,
                             scrutinize)

    def scrutiny_fn(s):
        return scrutinize(resume, s, config=ScrutinyConfig(probes=4),
                          device=DEV)

    with CheckpointManager([Level(root, keep_n=2, max_chain=2)],
                           scrutiny_fn=scrutiny_fn, rescrutinize_every=1,
                           device=DEV) as mgr:
        mgr.save(1, state, block=True)
        first = mgr._report
        mgr.save(2, state, block=True)
        st = mgr.last_save_stats
        kind = st["levels"][root]["kind"]
        sc = mgr.last_scrutiny_stats
        check(mgr._report is first and kind == "delta"
              and sc["reused_leaves"] == len(first.leaves)
              and sc["changed_leaves"] == 0,
              f"an unchanged re-scrutiny must keep the report and the "
              f"chain: same object {mgr._report is first}, kind {kind}, "
              f"reused {sc.get('reused_leaves')}")
    return {"kind": kind, "reused_leaves": sc["reused_leaves"],
            "changed_leaves": sc["changed_leaves"],
            "delta_bytes": st["levels"][root]["delta_bytes"],
            "blocked_s": st["blocked_s"]}


N_TIERED = 1 << 22           # the tiered save encodes on the host


def tiered_round_trip(root: str, state, sel_w, sel_h) -> dict:
    """A save with precision tiers (half the critical elements native, the
    rest bf16) takes the host engine on the card, by design, and restores
    through the host expand within the bf16 tier's error (1/64 relative,
    ``tests/test_checkpoint.py``'s bound); uncritical elements come back
    as the fill."""
    from repro_torch import CheckpointManager, Level, scrutinize
    from repro_torch.core import TIERED_BF16

    n = N_TIERED
    small = {"w": state["w"][:n].clone(), "h": state["h"][:n].clone(),
             "step": state["step"]}
    # graded weights: the elements' sensitivities spread over the tiers
    fw = sel_w[:n].float() * torch.linspace(0.5, 2.0, n, device=DEV)
    fh = sel_h[:n].float()

    def resume(s):
        return (s["w"] * fw).sum() + (s["h"].float() * fh).sum()

    rep = scrutinize(resume, small, device=DEV)
    with CheckpointManager([Level(root, keep_n=1)], precision=TIERED_BF16,
                           scrutiny_fn=lambda s: rep, device=DEV) as mgr:
        mgr.save(1, small, block=True)
        st = mgr.last_save_stats
        _, back = mgr.restore({k: torch.empty_like(v)
                               for k, v in small.items()})
    check(st["engine"] == "host" and st["host_reason"] == "tiered",
          f"a tiered save must take the host engine: {st['engine']}, "
          f"{st['host_reason']}")
    errs = {}
    for name, sel in (("w", sel_w[:n]), ("h", sel_h[:n])):
        want = small[name][sel].float()
        got = back[name][sel].float()
        errs[name] = float(((got - want).abs()
                            / want.abs().clamp_min(1e-6)).max())
        check(errs[name] < 1 / 64 and not bool(back[name][~sel].any()),
              f"tiered {name}: relative error {errs[name]} >= 1/64, or an "
              f"uncritical element is not the fill")
    # w's less sensitive half went to bf16 (h is bf16 already: exact)
    check(errs["w"] > 0 and errs["h"] == 0,
          f"tiered: w must carry a bf16 tier and h come back exact: {errs}")
    check(same_bytes(back["step"], small["step"]), "tiered step differs")
    disk = _dir_bytes(os.path.join(root, "step_1"))
    return {"engine": st["engine"], "host_reason": st["host_reason"],
            "blocked_s": st["blocked_s"], "max_rel_err": errs,
            "disk_bytes": disk,
            "state_bytes": sum(v.nbytes for v in small.values())}


# ----------------------------------------------------------------------------
# phase 4: the hardware-independent byte counts of the reference bench state
# ----------------------------------------------------------------------------

BENCH_DISK, BENCH_D2H, BENCH_H2D = 7_168_148, 5_594_532, 6_774_180


def phase_bench_bytes(root: str) -> None:
    from repro_torch import CheckpointManager, Level
    from repro_torch.convert import report_from_masks, state_from_numpy

    n = 1 << 23
    rng = np.random.RandomState(0)
    np_state = {"w": rng.randn(n).astype(np.float32),
                "b": rng.randn(n // 8).astype(np.float32),
                "step": np.asarray(7, np.int32)}
    masks = {"w": rng.rand(n) < CRIT_W, "b": rng.rand(n // 8) < CRIT_W}
    state = state_from_numpy(np_state, DEV)
    report = report_from_masks(masks, state)
    with CheckpointManager([Level(root, keep_n=1)],
                           scrutiny_fn=lambda s: report, save_mode="device",
                           restore_mode="device", device=DEV,
                           pipeline_engine="device") as mgr:
        mgr.save(1, state, block=True)
        d2h = mgr.last_save_stats["d2h_bytes"]
        mgr.restore({k: torch.zeros_like(v) for k, v in state.items()})
        h2d = mgr.last_restore_stats["h2d_bytes"]
    disk = sum(os.path.getsize(os.path.join(root, "step_1", f))
               for f in os.listdir(os.path.join(root, "step_1")))
    print(f"bench bytes: disk={disk} d2h={d2h} h2d={h2d} "
          f"(reference {BENCH_DISK} / {BENCH_D2H} / {BENCH_H2D})")
    check((disk, d2h, h2d) == (BENCH_DISK, BENCH_D2H, BENCH_H2D),
          "bench-state byte counts differ from the reference's")


# ----------------------------------------------------------------------------
# phase 10: coordinated checkpointing by four host threads at the main
# path's size
# ----------------------------------------------------------------------------

HOSTS = 4
# a leaf whose host segments start off a byte (rows 251/250/250/250 of 3:
# flat starts 753, 1503, 2253), so the report's words are shifted per host
ODD_SHAPE = (1001, 3)
COORD_TIMEOUT_S = 120.0
DEGRADED_TIMEOUT_S = 3.0     # the land barrier's wait for the dead host
VICTIM = 2


def host_threads(n, coord, fn, timeout=COORD_TIMEOUT_S):
    """``fn(index, collective)`` on ``n`` threads, one simulated host each,
    over one ``FileCollective`` dir → (results, errors)."""
    from repro_torch.distributed.collective import (FileCollective,
                                                    ProcessContext)
    results, errors = [None] * n, [None] * n

    def run(p):
        try:
            coll = FileCollective(coord, ctx=ProcessContext(p, n),
                                  timeout_s=timeout)
            results[p] = fn(p, coll)
        except BaseException as e:      # noqa: BLE001 - reported below
            errors[p] = e

    threads = [threading.Thread(target=run, args=(p,)) for p in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


def hosts_ok(results, errors, what):
    bad = [(p, repr(e)) for p, e in enumerate(errors) if e is not None]
    check(not bad, f"{what}: hosts failed {bad}")
    return results


def uncounted(fn):
    """Run an oracle (a single-process save or restore the path is held
    against) without adding its launches to the path's counts."""
    saved = dict(K.LAUNCHES)
    try:
        return fn()
    finally:
        K.LAUNCHES.update(saved)


def owned_rows_equal(got, want, count, index, what):
    from repro_torch.distributed.collective import process_segments
    for name, w in want.items():
        shape = tuple(w.shape)
        row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        g, w = got[name].reshape(-1), w.reshape(-1)
        for lo, hi, owner in process_segments(shape or (1,), count):
            if owner == index:
                check(same_bytes(g[lo * row:hi * row], w[lo * row:hi * row]),
                      f"{what}: host {index} rows [{lo}, {hi}) of {name}")


def phase_coordinated(root: str, main: dict, main_root: str):
    """Phase 10 → the path's mask-kernel launches.  Four host threads, each
    a ``CoordinatedCheckpointManager`` on the card over one
    ``FileCollective``, save phase 3's state (plus a leaf whose segments
    start off a byte) with one scrutiny report: a base, a delta after a
    1 MiB change, an unchanged delta; the unchanged delta restored 4 → 1
    through its chain and K4; a degraded save with host 2 killed after its
    L2 replica landed; restores from the partner (0 store bytes), 4 → 1
    through K4, and phase 3's single-process step 1 → 4."""
    import contextlib
    import io
    from repro_torch import ScrutinyConfig, obs, scrutinize
    from repro_torch.checkpoint import (CheckpointManager,
                                        CoordinatedCheckpointManager,
                                        GlobalManifest, Level,
                                        load_checkpoint_raw, read_manifest)
    from repro_torch.checkpoint.levels import L2_PARTNER, default_l2_root
    from repro_torch.obs import report as obs_report
    from repro_torch.testing.faults import FaultInjector, HostKilled

    t_phase = time.perf_counter()
    sel_w, sel_h = main["sel_w"], main["sel_h"]
    state = dict(main["state"])             # phase 3's tensors, shared
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2031)
    state["odd"] = torch.randn(ODD_SHAPE, generator=gen, device=DEV)
    sel_odd = torch.rand(ODD_SHAPE[0] * ODD_SHAPE[1], generator=gen,
                         device=DEV) < 0.5
    base_resume = make_resume(sel_w, sel_h)
    f_odd = sel_odd.float()

    def resume(s):
        return base_resume(s) + (s["odd"].reshape(-1) * f_odd).sum()

    want = {"w": sel_w, "b": torch.arange(N_B, device=DEV) < N_B * 7 // 8,
            "h": sel_h, "odd": sel_odd}
    lv_root = os.path.join(root, "coord")
    single_root = os.path.join(root, "single")
    full = sum(v.nbytes for v in state.values())
    print(f"coordinated: {HOSTS} host threads, state {full} B "
          f"({full / 2 ** 30:.3f} GiB), leaf odd {ODD_SHAPE}")

    K.reset_launches()
    # ---- the coordinated path: counts from 0 here, read at the end -------
    obs.reset()
    obs.enable()
    try:
        rep, scrutiny_s = synced(lambda: scrutinize(
            resume, state, config=ScrutinyConfig(probes=4), device=DEV))
        for name, sel in want.items():
            check(torch.equal(rep[name].device_words(),
                              ops.mask_to_words(sel.reshape(-1))),
                  f"coordinated: scrutiny mask of {name} differs from its "
                  f"selector")
        for leaf in rep.leaves.values():    # the host mask and runs, once,
            leaf.mask, leaf.table           # before four hosts read them

        single = CheckpointManager([Level(single_root, keep_n=2)],
                                   scrutiny_fn=lambda s: rep, device=DEV)
        uncounted(lambda: single.save(1, state, block=True))
        sync_saves = threading.Barrier(HOSTS)
        injector = FaultInjector().kill_at("after_replicate", match="q4.")
        mgrs = [None] * HOSTS

        def host(p, coll):
            mgr = CoordinatedCheckpointManager(
                [Level(lv_root, keep_n=4, max_chain=2)], collective=coll,
                scrutiny_fn=lambda s: rep, device=DEV,
                fault_injector=injector if p == VICTIM else None)
            mgrs[p] = mgr
            out = {}
            t0 = time.perf_counter()
            mgr.save(1, state, block=False)
            out["blocked_s"] = mgr.last_save_stats["blocked_s"]
            sync_saves.wait()
            if p == 0:      # in place, after every host's save() returned
                state["w"][:MUTATED] += 1.0
            sync_saves.wait()
            out["s1"] = dict(mgr.wait())
            torch.cuda.synchronize()
            out["save_s"] = time.perf_counter() - t0
            for step in (2, 3):
                mgr.save(step, state, block=True)
                out[f"s{step}"] = dict(mgr.wait())
            return out

        res = hosts_ok(*host_threads(HOSTS, os.path.join(root, "rdv1"),
                                     host), "coordinated: steps 1-3")
        uncounted(lambda: single.save(2, state, block=True))
        single.close()
        lv = [[r[f"s{t}"]["levels"][lv_root] for t in (1, 2, 3)]
              for r in res]
        check([x["kind"] for x in lv[0]] == ["base", "delta", "delta"],
              f"coordinated: step kinds {[x['kind'] for x in lv[0]]}")
        m2, m3 = read_manifest(lv_root, 2), read_manifest(lv_root, 3)
        changed = [sum(s.get("num_chunks", 0) for e in m["leaves"]
                       for s in e["segments"]) for m in (m2, m3)]
        check(changed[0] > 0 and changed[1] == 0,
              f"coordinated: changed delta chunks at steps 2, 3: {changed}")
        # the fused manifest covers each leaf exactly once
        for step in (1, 2, 3):
            gm = GlobalManifest.load(lv_root, step)
            check(gm.process_count == HOSTS, f"step {step}: process count")
            for name, leaf in state.items():
                segs = GlobalManifest.segments_of(gm.leaves()[name])
                n = leaf.numel()
                check(segs[0]["start"] == 0 and segs[-1]["stop"] == n
                      and all(a["stop"] == b["start"]
                              for a, b in zip(segs, segs[1:])),
                      f"coordinated: step {step} segments of {name} do not "
                      f"tile [0, {n})")
        # each step's payload bytes are the single-process manager's for
        # the same mask (delta steps through their chain)
        for step, ref_step in ((1, 1), (2, 2), (3, 2)):
            _, got_p, _ = load_checkpoint_raw(lv_root, step)
            _, ref_p, _ = load_checkpoint_raw(single_root, ref_step)
            for name in state:
                check(got_p[name].payload == ref_p[name].payload,
                      f"coordinated: step {step} payload of {name} differs "
                      f"from the single-process manager's")
            del got_p, ref_p
        odd_starts = [s["start"] for s in GlobalManifest.segments_of(
            GlobalManifest.load(lv_root, 1).leaves()["odd"])]
        check([s % 8 for s in odd_starts[1:]] != [0, 0, 0],
              f"coordinated: odd's segments start on bytes {odd_starts}")

        exp = {n: (torch.where(want[n].view(t.shape), t, torch.zeros_like(t))
                   if n in want else t) for n, t in state.items()}
        like = {k: torch.empty_like(v) for k, v in state.items()}
        # step 3, the unchanged delta, restored 4 → 1: the chain is rebuilt
        # on the host, and each masked leaf is expanded on the card by K4
        k4_chain = K.LAUNCHES["mask_scatter"]
        with CoordinatedCheckpointManager([Level(lv_root)],
                                          device=DEV) as mgr:
            (st, got), chain_s = synced(lambda: mgr.restore(like))
            chain_stats = dict(mgr.last_restore_stats)
        k4_chain = K.LAUNCHES["mask_scatter"] - k4_chain
        check(st == 3 and chain_stats["chain"] and k4_chain == len(want),
              f"coordinated: 4 → 1 restore of the chain gave step {st} "
              f"(chain {chain_stats['chain']}) with {k4_chain} K4")
        for name, t in exp.items():
            check(same_bytes(got[name], t), f"coordinated: 4 → 1 restore of "
                  f"step 3's {name} is not the state under its mask")
        del got

        # step 4: host 2 dies after its replicate; the survivors commit
        # degraded from its partner's replica
        def degraded(p, coll):
            mgr = mgrs[p]
            mgr.barrier_timeout_s = DEGRADED_TIMEOUT_S
            t0 = time.perf_counter()
            try:
                mgr.save(4, state, block=True)
                return dict(mgr.last_save_stats), time.perf_counter() - t0
            finally:
                try:
                    mgr.close()
                except HostKilled:
                    pass

        # (each manager keeps its collective; these are not used)
        deg, deg_err = host_threads(HOSTS, os.path.join(root, "rdv_unused"),
                                    degraded)
    finally:
        obs.disable()
    check(isinstance(deg_err[VICTIM], HostKilled)
          and all(deg_err[p] is None for p in range(HOSTS) if p != VICTIM),
          f"coordinated: degraded save errors {deg_err}")
    m4 = read_manifest(lv_root, 4)
    survivors = [p for p in range(HOSTS) if p != VICTIM]
    check(m4.get("degraded", {}).get("missing") == [VICTIM],
          f"coordinated: step 4 degraded section {m4.get('degraded')}")
    deg_lv = deg[survivors[0]][0]["levels"][lv_root]

    # the fused telemetry of step 1, rendered by the report CLI
    tel = os.path.join(lv_root, "step_1")
    trace_path = os.path.join(root, "trace.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_report.main([tel, "--trace-out", trace_path])
    rendered = buf.getvalue()
    with open(os.path.join(tel, "telemetry.json")) as f:
        doc = json.load(f)
    with open(trace_path) as f:
        pids = {e["pid"] for e in json.load(f)["traceEvents"]
                if e["ph"] != "M"}
    check(rc == 0 and sorted(doc["hosts"]) == [str(p) for p in range(HOSTS)]
          and pids == set(range(HOSTS))
          and all(frag.get("drift") for frag in doc["hosts"].values())
          and "criticality drift" in rendered,
          f"coordinated: telemetry of step 1: hosts {sorted(doc['hosts'])},"
          f" trace processes {sorted(pids)}")

    # step 5: fresh managers, host 2 replaced (its node-local replica
    # store is gone): the partner serves, no byte comes from the store
    shutil.rmtree(os.path.join(default_l2_root(lv_root), f"h{VICTIM}"))

    def partner_restore(p, coll):
        with CoordinatedCheckpointManager([Level(lv_root)], collective=coll,
                                          device=DEV) as mgr:
            (st, got), dt = synced(lambda: mgr.restore(like,
                                                       local_only=True))
            owned_rows_equal(got, exp, HOSTS, p, "partner restore")
            return st, dict(mgr.last_restore_stats), dt

    rest = hosts_ok(*host_threads(HOSTS, os.path.join(root, "rdv2"),
                                  partner_restore), "coordinated: step 5")
    check(all(st == 4 and s["bytes_read_store"] == 0
              and s["level_served"][L2_PARTNER] > 0 for st, s, _ in rest),
          f"coordinated: partner restore read the store: "
          f"{[(st, s['bytes_read_store']) for st, s, _ in rest]}")
    torch.cuda.empty_cache()
    # step 6: 4 → 1, every leaf whole, range reads expanded by K4
    k4 = K.LAUNCHES["mask_scatter"]
    with CoordinatedCheckpointManager([Level(lv_root)], device=DEV) as mgr:
        (st, got), one_s = synced(lambda: mgr.restore(like))
        one_stats = dict(mgr.last_restore_stats)
    k4 = K.LAUNCHES["mask_scatter"] - k4
    check(st == 4 and k4 >= len(want),
          f"coordinated: 4 → 1 restore gave step {st} with {k4} K4")
    for name, t in exp.items():
        check(same_bytes(got[name], t), f"coordinated: 4 → 1 restore of "
              f"{name} is not the state under its mask")
    del got
    # step 7: phase 3's single-process step 1 restored onto 4 hosts
    p3_root = os.path.join(root, "from_phase3")
    os.makedirs(os.path.join(p3_root, "step_1"))
    for f in os.listdir(os.path.join(main_root, "step_1")):
        os.link(os.path.join(main_root, "step_1", f),
                os.path.join(p3_root, "step_1", f))
    p3_like = {k: v for k, v in like.items() if k != "odd"}
    with CheckpointManager([Level(p3_root)], device=DEV) as mgr:
        _, p3_want = uncounted(lambda: mgr.restore(p3_like))
    p3_total = read_manifest(p3_root, 1)["payload_bytes"]

    def reshard(p, coll):
        with CoordinatedCheckpointManager([Level(p3_root)], collective=coll,
                                          device=DEV) as mgr:
            (st, got), dt = synced(lambda: mgr.restore(p3_like,
                                                       local_only=True))
            owned_rows_equal(got, p3_want, HOSTS, p, "1 → 4 restore")
            return st, dict(mgr.last_restore_stats), dt

    rs = hosts_ok(*host_threads(HOSTS, os.path.join(root, "rdv3"), reshard),
                  "coordinated: 1 → 4 restore")
    reads = [s["bytes_read"] for _, s, _ in rs]
    check(all(st == 1 for st, _, _ in rs)
          and all(0 < r < p3_total for r in reads),
          f"coordinated: 1 → 4 range reads {reads} of {p3_total}")
    launches = {k: K.LAUNCHES[k] for k in CKPT_KERNELS}
    # ---- end of the coordinated path --------------------------------------
    # K2 once a host a masked leaf a step (steps 1-4; host 2 packs step 4
    # before it dies)
    check(launches["threshold_bitpack"] > 0
          and launches["pack"] == HOSTS * len(want) * 4
          and launches["mask_scatter"] > 0 and launches["delta_flags"] == 0,
          f"coordinated: launches {launches} (K1; K2 {HOSTS * len(want) * 4}"
          f" times; K4; the delta is the host's)")
    del p3_want, exp, like
    torch.cuda.empty_cache()

    disk = [_dir_bytes(os.path.join(lv_root, f"step_{t}"))
            for t in (1, 2, 3, 4)]
    hosts = {p: {"blocked_s": round(r["blocked_s"], 4),
                 "save_s": round(r["save_s"], 4),
                 "land_barrier_s": [round(x["land_barrier_s"], 4)
                                    for x in lv[p]],
                 "commit_barrier_s": [round(x["commit_barrier_s"], 4)
                                      for x in lv[p]],
                 "d2h_bytes": r["s1"]["d2h_bytes"],
                 "written": [x["host_bytes_written"] for x in lv[p]]}
             for p, r in enumerate(res)}
    print(f"coordinated: scrutiny_s={scrutiny_s:.4f}; steps 1-3 per host "
          f"{json.dumps(hosts)}")
    print(f"coordinated: disk bytes of steps 1-4 {disk}; delta chunks "
          f"steps 2, 3 {changed}; payloads equal the single-process "
          f"manager's; odd's segments start at {odd_starts}")
    print(f"coordinated: step 4 with host {VICTIM} killed after its "
          f"replicate: degraded {json.dumps(m4['degraded'])}, survivors' "
          f"save_s {[round(d[1], 4) for d in deg if d]}, recovered "
          f"{deg_lv.get('l2_recovered_bytes')} B from the partner, land "
          f"barrier {deg_lv['land_barrier_s']:.4f} s (timeout "
          f"{DEGRADED_TIMEOUT_S} s)")
    print(f"coordinated: partner restore (host {VICTIM} replaced) restore_s "
          f"{[round(d, 4) for _, _, d in rest]}, store bytes "
          f"{[s['bytes_read_store'] for _, s, _ in rest]}, L2 bytes "
          f"{[s['bytes_read_l2'] for _, s, _ in rest]}, h2d "
          f"{[s['h2d_bytes'] for _, s, _ in rest]}")
    print(f"coordinated: step 3 (delta chain) 4 → 1 through K4 "
          f"({k4_chain} launches) restore_s={chain_s:.4f} "
          f"bytes_read={chain_stats['bytes_read']} "
          f"h2d={chain_stats['h2d_bytes']}; bit-identical to the state "
          f"under its masks")
    print(f"coordinated: 4 → 1 restore through K4 ({k4} launches) "
          f"restore_s={one_s:.4f} bytes_read={one_stats['bytes_read']} "
          f"h2d={one_stats['h2d_bytes']}; bit-identical to the state under "
          f"its masks")
    print(f"coordinated: phase 3's step 1 onto {HOSTS} hosts: restore_s "
          f"{[round(d, 4) for _, _, d in rs]}, range reads {reads} of "
          f"{p3_total} B")
    print("coordinated: telemetry of step 1 (python -m "
          "repro_torch.obs.report), its save timeline:")
    for line in rendered.split("== criticality drift")[0].splitlines()[1:]:
        if line.strip():
            print(f"coordinated:   {line}")
    print(f"coordinated: launches {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(root)        # the later phases' disk and page cache
    return launches


# the launcher as a coordinated job of two processes, resumed by one; and a
# two-process gloo group saving through TorchCollective
PROC_ARGS = ["--arch", "xlstm-125m", "--preset", "smoke", "--batch", "2",
             "--seq", "64", "--ckpt-every", "4", "--log-every", "1000"]

_LAUNCH_PROG = r"""
import json, sys
from repro_torch.launch import train
print("LOSSES", json.dumps(train.main(sys.argv[1:])))
"""

_GLOO_PROG = r"""
import os, sys
import numpy as np, torch
import torch.distributed as dist
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=2)
from repro_torch.checkpoint import CoordinatedCheckpointManager, Level
from repro_torch.convert import report_from_masks
from repro_torch.distributed.collective import (TorchCollective,
                                                get_collective,
                                                process_segments)
from repro_torch.kernels.mask_pack import kernel as K
coll = get_collective()
assert isinstance(coll, TorchCollective) and coll.ctx.count == 2
dev = os.environ["DEVICE"]
gen = torch.Generator(device=dev).manual_seed(7)
state = {"w": torch.randn(1 << 20, generator=gen, device=dev),
         "odd": torch.randn(1001, 3, generator=gen, device=dev),
         "step": torch.tensor(3, dtype=torch.int32, device=dev)}
rng = np.random.RandomState(1)
masks = {"w": rng.rand(1 << 20) < 0.3, "odd": rng.rand(3003) < 0.5}
rep = report_from_masks(masks, state)
with CoordinatedCheckpointManager([Level(os.environ["ROOT"])],
                                  collective=coll, scrutiny_fn=lambda s: rep,
                                  barrier_timeout_s=120, device=dev) as mgr:
    mgr.save(1, state, block=True)
    st, got = mgr.restore({k: torch.empty_like(v) for k, v in state.items()},
                          local_only=True)
    assert st == 1
    for name, m in masks.items():
        t = state[name]
        want = torch.where(torch.from_numpy(m).to(dev).view(t.shape), t, 0)
        for lo, hi, owner in process_segments(tuple(t.shape), 2):
            if owner == rank:
                assert torch.equal(got[name][lo:hi], want[lo:hi]), name
print("GLOO_OK", rank, K.LAUNCHES["pack"], K.LAUNCHES["mask_scatter"],
      flush=True)
dist.destroy_process_group()
"""


def _spawn(prog, args, env_extra):
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), **env_extra)
    for k in ("REPRO_PROCESS_INDEX", "REPRO_PROCESS_COUNT"):
        if k not in env_extra:
            env.pop(k, None)
    return subprocess.Popen([sys.executable, "-c", prog] + list(args),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs, what, timeout=300):
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        check(pr.returncode == 0, f"{what}: exit {pr.returncode}: "
              f"{err[-2000:]}")
        outs.append(out)
    return outs


def _losses(out):
    line = next(x for x in out.splitlines() if x.startswith("LOSSES "))
    return json.loads(line[len("LOSSES "):])


def phase_coordinated_processes(root: str) -> None:
    """Two real processes of the launcher with ``--coordinated`` (the
    ``REPRO_PROCESS_*`` simulation) train 12 steps and save at 4, 8 and
    12; the job is cut after step 8 (step 12 removed) and one process
    resumes it.  Meanwhile two processes in a gloo group save and restore
    through ``TorchCollective``."""
    import socket
    from repro_torch.checkpoint import is_step_committed
    t0 = time.perf_counter()
    ckpt = os.path.join(root, "launcher")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    gloo_root = os.path.join(root, "gloo")
    args = PROC_ARGS + ["--device", DEV]
    launchers = [_spawn(_LAUNCH_PROG, args + [
        "--steps", "12", "--ckpt-dir", ckpt, "--coordinated",
        "--coord-dir", os.path.join(root, "rdv")],
        {"REPRO_PROCESS_INDEX": str(p), "REPRO_PROCESS_COUNT": "2"})
        for p in range(2)]
    gloo = [_spawn(_GLOO_PROG, [], {"RANK": str(r), "ROOT": gloo_root,
                                    "INIT": f"tcp://localhost:{port}",
                                    "DEVICE": DEV})
            for r in range(2)]
    first = [_losses(o) for o in _finish(launchers, "coordinated launcher")]
    gloo_out = _finish(gloo, "gloo TorchCollective")
    check(first[0] == first[1], f"coordinated launcher: the processes' "
          f"losses differ: {first}")
    step = os.path.join(ckpt, "ram", "step_8")
    files = set(os.listdir(step))
    with open(os.path.join(step, "manifest.json")) as f:
        man = json.load(f)
    split = [e for e in man["leaves"] if len(e["segments"]) == 2]
    check({"commit.json", "manifest.host0.json", "manifest.host1.json"}
          <= files and man["coordinated"]["process_count"] == 2
          and all(e["encoding"] == "segmented" for e in man["leaves"])
          and split, f"coordinated launcher: step 8 holds {sorted(files)}")
    shutil.rmtree(os.path.join(ckpt, "ram", "step_12"))
    (out,) = _finish([_spawn(_LAUNCH_PROG, args + [
        "--steps", "12", "--ckpt-dir", ckpt, "--resume"], {})],
        "launcher resume")
    resumed = _losses(out)
    check("resumed from step 8" in out and len(resumed) == 4
          and np.allclose(resumed, first[0][8:], rtol=1e-5, atol=0),
          f"launcher resume: losses {resumed} vs the uninterrupted run's "
          f"{first[0][8:]}")
    gl = [o.split("GLOO_OK", 1)[1].split() for o in gloo_out]
    check(is_step_committed(gloo_root, 1), "gloo: step 1 not committed")
    print(f"coordinated: launcher as 2 processes (--coordinated) then 1 "
          f"(--resume from step 8): losses 9-12 {json.dumps(resumed)} "
          f"(bitwise equal to the uninterrupted run's: "
          f"{resumed == first[0][8:]}); {len(split)} of "
          f"{len(man['leaves'])} leaves split over both processes")
    print(f"coordinated: gloo group of 2 processes, TorchCollective: "
          f"saved and restored on the card (rank, K2, K4 launches) {gl}; "
          f"processes {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(root)




# ----------------------------------------------------------------------------
# phase 6: the serving path, phi4-mini-3.8b at full width and depth
# ----------------------------------------------------------------------------

SERVE_ARCH = "phi4-mini-3.8b"
SERVE_B, SERVE_T, SERVE_MAX_LEN = 4, 1024, 2048
PRE_STEPS = 4                # decode steps before the first snapshot
HORIZON, HEADROOM = 2, 2     # resume_fn(2), probed at pos + 2
CONTINUE = 8                 # tokens decoded from each restored snapshot
# Prefill logits, K6 against the plain attention, both bf16 on the card.
# Each layer's attention output is rounded to bf16 (8 significant bits), so
# where two correct f32 results straddle a rounding boundary they differ by
# one ulp, and a random-init 32-layer bf16 residual stream amplifies that:
# on the CPU, two plain attentions that differ only in summation order move
# phi4-shaped logits (width 768) by 0.05, 0.26 and 0.53 at 4, 16 and 32
# layers (``scripts/serve_bf16_numerics.py depth``).  So the bound is a
# control measured in the same run: the plain
# attention in K6's order (``ref.flash_attention_tiled``: f32, the bf16
# kernels' key tiles) against the plain version, and K6's distance may be
# at most CONTROL_FACTOR times it.
CONTROL_FACTOR = 3.0


def scale_first_control(q, k, v, *, scale=None, **kw):
    """The control as it was before the bf16 kernels: q scaled in f32
    before the product.  Printed beside the control, not a bound."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return flash_attention_tiled(q.float() * scale, k, v, scale=1.0,
                                 **kw).to(q.dtype)


def _leaves(tree):
    return dict(_tree.flatten_with_names(tree)[0])


def _empty_like(tree):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [torch.empty_like(t) for _, t in named])


def _continue(eng, state, n):
    """Greedy decode of ``n`` tokens → (tokens (n, B), logits (n, B, V))."""
    toks, logits = [], []
    for _ in range(n):
        lg, state = eng.decode(state)
        toks.append(state["tokens"][:, 0])
        logits.append(lg)
    return torch.stack(toks), torch.stack(logits)


def _changed_chunks(root: str, step: int):
    import base64
    from repro_torch.checkpoint import read_manifest
    out = {}
    for e in read_manifest(root, step)["leaves"]:
        check(e["encoding"] == "delta", f"step {step} leaf {e['name']} is "
              f"{e['encoding']}, not a delta")
        out[e["name"]] = np.frombuffer(base64.b64decode(e["aux"]), np.int32)
    return out


def phase_serving(root: str):
    from repro_torch import (CheckpointManager, Engine, Level, ScrutinyConfig,
                             get_config, scrutinize)
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import count_params, init_params

    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2027)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, gen)
    eng = Engine(cfg, params, SERVE_MAX_LEN, device=DEV)
    prompt = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_T), generator=gen,
                           device=DEV, dtype=torch.int32)
    batch = {"tokens": prompt}
    print(f"serving: {SERVE_ARCH} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab}; {count_params(params)} parameters "
          f"({cfg.param_dtype}, compute {cfg.dtype}); B={SERVE_B} "
          f"T={SERVE_T} max_len={SERVE_MAX_LEN}")

    real_fa = attn_mod.flash_attention
    K.reset_launches()
    FK.reset_launches()
    # ---- the serving path: counts from 0 here, read at the end ----------
    (logits, state), prefill_s = synced(lambda: eng.prefill(batch))
    check(FK.LAUNCHES["flash_attention"] == cfg.n_layers,
          f"prefill launched K6 {FK.LAUNCHES['flash_attention']} times, not "
          f"{cfg.n_layers}")
    decode_ms = []
    for _ in range(PRE_STEPS):
        (state, _), dt = synced(lambda: eng.step(state))
        decode_ms.append(dt * 1e3)
    state_bytes = sum(v.nbytes for v in _leaves(state).values())

    def scrutiny_fn(s):
        pos = min(int(s["pos"]) + HEADROOM, SERVE_MAX_LEN - HORIZON)
        probe = dict(s, pos=torch.tensor(pos, dtype=torch.int32, device=DEV))
        return scrutinize(eng.resume_fn(HORIZON), probe,
                          config=ScrutinyConfig(probes=2), device=DEV)

    rep, scrutiny_s = synced(lambda: scrutiny_fn(state))
    crit_slots = int(state["pos"]) + HEADROOM
    sel = (torch.arange(SERVE_MAX_LEN, device=DEV) < crit_slots).view(
        1, 1, -1, 1, 1)
    for name, leaf in _leaves(state).items():
        if name.startswith("cache/"):
            m = rep[name].device_mask().view(leaf.shape)
            bad = torch.nonzero(m != sel.expand(leaf.shape))
            check(bad.numel() == 0,
                  f"mask of {name} differs from slot < {crit_slots} at "
                  f"{bad.shape[0]} elements, first (layer, batch, slot, "
                  f"head, lane) {bad[:4].tolist()}")
        else:
            check(rep[name].all_critical, f"{name} must be all critical")
    cache_frac = (sum(rep[n].critical for n in rep.leaves
                      if n.startswith("cache/"))
                  / sum(rep[n].total for n in rep.leaves
                        if n.startswith("cache/")))

    mgr = CheckpointManager([Level(root, keep_n=3, max_chain=2)],
                            scrutiny_fn=lambda s: rep, save_mode="device",
                            restore_mode="device", device=DEV)
    saved = {}
    t0 = time.perf_counter()
    mgr.save(1, state, block=False)
    stats1 = mgr.wait()
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    saved[1] = state
    disk = sum(os.path.getsize(os.path.join(root, "step_1", f))
               for f in os.listdir(os.path.join(root, "step_1")))
    (step, restored1), restore_s = synced(
        lambda: restore_k8(mgr, _empty_like(state), "serving step 1"))
    check(step == 1, f"restored step {step}, not 1")
    h2d = mgr.last_restore_stats["h2d_bytes"]
    written = {}
    for step in (2, 3):
        written[step] = int(state["pos"])      # the slot this step writes
        state, _ = eng.step(state)
        saved[step] = state
        mgr.save(step, state, block=True)
        check(mgr.last_save_stats["levels"][root]["kind"] == "delta",
              f"step {step} must be a delta")
    step, restored3 = restore_k8(mgr, _empty_like(state), "serving step 3")
    check(step == 3, f"restored step {step}, not 3")
    mgr.close()

    # the deltas hold only the slots written since the step before: in a
    # cache leaf's payload, (layer, batch) row r keeps its slots < crit
    # in order, so slot t's K or V (row_bytes) starts at byte
    # (r * crit + t) * row_bytes
    rows = cfg.n_layers * SERVE_B
    row_bytes = cfg.n_kv_heads * cfg.resolved_head_dim * 2        # bf16
    chunk = ops.DELTA_CHUNK_BYTES
    for step in (2, 3):
        start = (np.arange(rows) * crit_slots + written[step]) * row_bytes
        want = np.unique(np.concatenate([
            np.arange(a // chunk, (a + row_bytes - 1) // chunk + 1)
            for a in start]))
        for name, idx in _changed_chunks(root, step).items():
            if name.startswith("cache/"):
                check(np.array_equal(np.sort(idx), want),
                      f"step {step} delta of {name}: {idx.size} chunks, "
                      f"not the {want.size} of slot {written[step]}")
            else:
                check(idx.size <= 1 and (name != "pos" or idx.size == 1),
                      f"step {step} delta of {name}: {idx.tolist()}")

    # restored snapshots continue exactly where the engine was
    for step, restored in ((1, restored1), (3, restored3)):
        toks, want = _continue(eng, saved[step], CONTINUE)
        r_toks, r_lg = _continue(eng, restored, CONTINUE)
        check(torch.equal(toks, r_toks) and torch.equal(want, r_lg),
              f"decoding from restored step {step} differs")
    del restored1, saved
    # garbage (finite, moderate) in every uncritical slot of step 3 changes
    # nothing ...
    for name, leaf in _leaves(restored3).items():
        if name.startswith("cache/"):
            tail = leaf[:, :, crit_slots:]
            tail.copy_(torch.randn(tail.shape, generator=gen, device=DEV))
    check(torch.equal(_continue(eng, restored3, CONTINUE)[1], want),
          "uncritical garbage changed the logits")
    # ... and 8 corrupted critical elements change them
    k0 = restored3["cache"]["seg0"]["u0"]["k"]
    k0[0, 0, :8, 0, 0] += 1.0
    check(not torch.equal(_continue(eng, restored3, CONTINUE)[1], want),
          "critical corruption went unseen")
    launches = {**{k: K.LAUNCHES[k] for k in CKPT_KERNELS},
                "flash_attention": FK.LAUNCHES["flash_attention"]}
    # ---- end of the serving path ---------------------------------------
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the serving path was never launched: {launches}")

    # every prefill layer's K6 output against the plain version on the same
    # inputs, then the logits of the plain attention and of the control
    layer_err, layer0 = [], {}

    def compare(q, k, v, **kw):
        out = real_fa(q, k, v, **kw)
        layer_err.append(fa_err(out, flash_attention_ref(q, k, v, **kw),
                                fa_tol(q.dtype)))
        layer0.setdefault("in", (q, k, v, kw))
        return out

    prefills = {}
    for tag, impl in (("k6", compare), ("plain", flash_attention_ref),
                      ("control", flash_attention_tiled),
                      ("scale_first", scale_first_control)):
        attn_mod.flash_attention = impl
        try:
            prefills[tag] = eng.prefill(batch)[0].float()
        finally:
            attn_mod.flash_attention = real_fa
    check(torch.equal(prefills["k6"], logits.float()),
          "two K6 prefills of the same batch differ")
    plain = prefills["plain"]

    def dist(x):
        d = x - plain
        return (float(d.abs().max()), float(d.norm() / plain.norm()),
                float((x.argmax(-1) == plain.argmax(-1)).float().mean()))

    k6_d, ctl_d = dist(prefills["k6"]), dist(prefills["control"])
    first_d = dist(prefills["scale_first"])
    check(k6_d[0] <= CONTROL_FACTOR * ctl_d[0],
          f"prefill logits, K6 against the plain attention: max |Δ| "
          f"{k6_d[0]} > {CONTROL_FACTOR} x the control's {ctl_d[0]}")
    del prefills, plain
    peak = torch.cuda.max_memory_allocated()

    print(f"serving: prefill_s={prefill_s:.4f} decode_step_ms(median of "
          f"{PRE_STEPS})={float(np.median(decode_ms)):.3f} "
          f"scrutiny_s={scrutiny_s:.4f} (reads pre-pass "
          f"{rep.stats['prepass_reads_s']:.4f}) "
          f"blocked_s={stats1['blocked_s']:.4f} "
          f"save_s={save_s:.4f} restore_s={restore_s:.4f}")
    print(f"serving: engine state {state_bytes} B; cache {cache_frac:.4%} "
          f"critical (slot < {crit_slots}); disk(step 1) {disk} B "
          f"({disk / state_bytes:.4%}), d2h {stats1['d2h_bytes']} B "
          f"({stats1['d2h_bytes'] / state_bytes:.4%}), h2d {h2d} B "
          f"({h2d / state_bytes:.4%}) of the state")
    print(f"serving: K6 against the plain version on each prefill "
          f"layer's inputs: max |Δ| layer 0 {layer_err[0]:.6f}, all "
          f"{len(layer_err)} layers {max(layer_err):.6f} (tolerance 2e-2)")
    print(f"serving: prefill logits against the plain attention (max |Δ|, "
          f"relative L2, argmax agreement): K6 {k6_d}, control "
          f"(flash_attention_tiled) {ctl_d}; bound {CONTROL_FACTOR} x the "
          f"control's max |Δ|; the control with q scaled before the "
          f"product {first_d}, K6 {k6_d[0] / first_d[0]:.4f} x its max |Δ|")
    print(f"serving: restored steps 1 and 3 continue {CONTINUE} tokens "
          f"bit-identically; uncritical garbage leaves the logits unchanged, "
          f"8 critical changes do not; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB")
    print(f"serving: launches {json.dumps(launches)}")
    q, k, v, kw = layer0["in"]
    return launches, {"q": q, "k": k, "v": v, "kw": kw}


# ----------------------------------------------------------------------------
# phase 9: the rest of the model families, served
# ----------------------------------------------------------------------------

# (arch, changes to its published config, the cuts of scale they make)
FAMILIES = (
    ("olmoe-1b-7b", {}, []),
    ("deepseek-v3-671b", {"n_layers": 4, "param_dtype": "bfloat16"},
     ["depth 61 -> 4 layers (3 dense, 1 MoE: 256 routed + 1 shared)",
      "bf16 parameters (f32 would take 60.5 GB)"]),
    ("whisper-tiny", {}, []),
    ("qwen2-vl-7b", {"n_layers": 8}, ["depth 28 -> 8 layers"]),
)
FAM_B, FAM_T, FAM_WHISPER_T = 4, 1024, 64
FAM_PATCHES = 256            # launch/specs.py:19, a 16 x 16 grid
FAM_STEPS = 4                # greedy steps before the base save
# Prefill + decode at text position T against the model's own full forward
# (``full_logits`` over T + 1 tokens), both in f32 compute on the same
# parameters: in bf16 a random-init stack amplifies one-ulp differences
# (phase 6), here only summation order differs.  Bound on max |Δ|, times
# the largest |logit| (floored at 1).  An MoE layer's routing is a step
# function of its input: where two paths' f32 round-off puts a token's
# top-k boundary on either side of a near-tie (olmoe: 16 layers x 4 x 1024
# decisions, and on an H100 the last position's alone differed in 3 of the
# 16 layers), that token's K/V and every later position differ by a
# whole expert's share.  So the prefill and the decode replay the full
# forward's routing (:class:`RoutingPin`); the gap without it is printed.
# f32 round-off still grows with depth through a random-init stack: on an
# H100, deepseek (4 layers) and qwen2-vl (8) read 1.8e-5 and 2.2e-5 of the
# largest |logit|, olmoe (16, pinned) 8.9e-4; a cache, position or mask
# fault moves logits by O(1) of it (the reference's VLM pos fault: 1.46 on
# logits under 0.90).
FAM_CONSISTENCY_TOL = 2e-3


class RoutingPin:
    """Records each MoE layer's top-k expert ids at every position of one
    forward (``moe.top_k`` wrapped), then replays them in later forwards
    of the same sequence from position ``offset`` on, the values gathered
    from their own probabilities: the same routing decisions, so that the
    rest of two forwards can be compared."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.log = moe, moe.top_k, []
        self.offset, self.layer = None, 0

    def replay(self, offset: int) -> "RoutingPin":
        self.offset, self.layer = offset, 0
        return self

    def __enter__(self):
        def top_k(probs, k):
            if self.offset is None:
                vals, idx = self.real(probs, k)
                self.log.append(idx)
                return vals, idx
            rec = self.log[self.layer % len(self.log)]
            self.layer += 1
            idx = rec[:, self.offset:self.offset + probs.shape[1]]
            return probs.gather(-1, idx), idx

        self.moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        self.moe.top_k = self.real


class LayerTap:
    """While active, keeps each decoder layer's residual stream around its
    FFN half (``models.model._ffn_half``: the input is the stream after the
    attention half, the output the layer's output) under the current
    ``mode``, so that the full forward, the prefill and the decode can be
    compared layer by layer."""

    def __init__(self):
        from repro_torch.models import model as model_mod
        self.model, self.real = model_mod, model_mod._ffn_half
        self.mode, self.kept = None, {}

    def __enter__(self):
        def ffn_half(cfg, p, x, train=False):
            out = self.real(cfg, p, x, train)
            if self.mode is not None:
                self.kept.setdefault(self.mode, []).append(
                    (x.detach().clone(), out[0].detach().clone()))
            return out

        self.model._ffn_half = ffn_half
        return self

    def __exit__(self, *exc):
        self.model._ffn_half = self.real

    def gaps(self, T):
        """Per layer, max |Δ| / max |x| of the pinned path against the full
        forward: the decode position T after the attention half and after
        the layer, and the prefill's positions < T after the layer."""
        out = {"decode_attn": [], "decode_out": [], "prefill_out": []}
        for (fi, fo), (_, po), (di, do) in zip(
                self.kept["full"], self.kept["prefill"],
                self.kept["decode"]):
            scale = max(float(fo.abs().max()), 1e-30)

            def rel(a, b):
                return float((a - b).abs().max()) / scale

            out["decode_attn"].append(rel(di[:, 0], fi[:, T]))
            out["decode_out"].append(rel(do[:, 0], fo[:, T]))
            out["prefill_out"].append(rel(po, fo[:, :T]))
        return {k: [float(f"{v:.3e}") for v in vs] for k, vs in out.items()}


def family_flops(q, k, v, causal) -> float:
    """K6's products (``csrc/flash_attention.cu`` bounds): S and P.V."""
    B, Tq, H, D = q.shape
    Tk, Dv = k.shape[1], v.shape[-1]
    pairs = Tq * (Tq + 1) / 2 if causal else Tq * Tk
    return 2.0 * B * H * pairs * (D + Dv)


def _family_batch(cfg, gen, T):
    """B prompts of T + 1 tokens (the last one for the consistency check),
    with frames (whisper) or patch embeddings and their M-RoPE positions
    (qwen2-vl: the temporal axis counts along the sequence, height and
    width run over the 16 x 16 patch grid, then follow the text)."""
    b = {"tokens": torch.randint(0, cfg.vocab, (FAM_B, T + 1), generator=gen,
                                 device=DEV, dtype=torch.int32)}
    if cfg.enc_dec:
        b["frames"] = torch.randn((FAM_B, cfg.encoder_len, cfg.d_model),
                                  generator=gen, device=DEV)
    if cfg.family == "vlm":
        P, side = FAM_PATCHES, int(FAM_PATCHES ** 0.5)
        b["patch_embeds"] = torch.randn((FAM_B, P, cfg.d_model),
                                        generator=gen, device=DEV)
        t = torch.arange(P + T + 1, device=DEV)
        grid = torch.arange(P, device=DEV)
        pos = torch.stack([t, torch.cat([grid // side, t[P:]]),
                           torch.cat([grid % side, t[P:]])], -1)
        b["positions"] = pos.expand(FAM_B, -1, -1).to(torch.int32)
    return b


def _family_head(batch, T):
    """The batch cut to its first T text tokens."""
    out = dict(batch, tokens=batch["tokens"][:, :T].contiguous())
    if "positions" in batch:
        out["positions"] = batch["positions"][:, :FAM_PATCHES + T]
    return out


def reckon_peak(cfg, params, B, max_len, T) -> dict:
    """The phase's peak device memory from the arithmetic, before it runs:
    the parameters, their compute-dtype copy (none when they are in it
    already), the engine states held (three caches: the prefill's, the
    running state and the saved one), the scrutiny (the cache in f32,
    once as the input and twice as the two decode steps' outputs that the
    vjp keeps, plus the f32 max-accumulators: four f32 caches), the f32
    full forward's logits (B, T + 1, V), and, for parameters that are not
    f32, the largest leaf in f32 (the initializer draws in f32 before the
    cast; the f32 forward casts each weight at use)."""
    from repro_torch.models import init_cache
    leaves = _tree.leaves(params)
    pbytes = sum(t.nbytes for t in leaves)
    compute = (0 if cfg.param_dtype == cfg.dtype else
               sum(t.numel() * 2 for t in leaves))
    cache = sum(t.nbytes for t in _tree.leaves(
        init_cache(cfg, B, max_len, device="meta")))
    terms = {"params": pbytes, "compute copy": compute,
             "states": 3 * cache, "scrutiny": 4 * 2 * cache,
             "f32 logits": B * (T + 1) * cfg.vocab * 4,
             "f32 casts": (0 if cfg.param_dtype == "float32" else
                           4 * max(t.numel() for t in leaves))}
    terms["total"] = sum(terms.values())
    return {k: round(v / 2 ** 30, 2) for k, v in terms.items()}


def serve_family(arch, changes, reduced, root, seed):
    """One model's serving path → (launches, (arch, q, k, v, kwargs) of
    its first K6 call at the phase's shape).  Launches are counted from 0
    just before the
    prefill and read after the continuation; the comparisons with the
    plain versions come after that."""
    from repro_torch import (CheckpointManager, Engine, Level, ScrutinyConfig,
                             get_config, scrutinize)
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import (count_params, decode_step, full_logits,
                                    init_params, prefill)

    cfg = dataclasses.replace(get_config(arch), **changes)
    T = FAM_WHISPER_T if cfg.enc_dec else FAM_T
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # earlier phases' tensors
    params = init_params(cfg, gen)
    predicted = reckon_peak(cfg, params, FAM_B, SERVE_MAX_LEN, T)
    eng = Engine(cfg, params, SERVE_MAX_LEN, device=DEV)
    full = _family_batch(cfg, gen, T)
    batch = _family_head(full, T)
    print(f"families: {arch}: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} vocab {cfg.vocab}; "
          f"{count_params(params)} parameters ({cfg.param_dtype}, compute "
          f"{cfg.dtype}); B={FAM_B} T={T} max_len={SERVE_MAX_LEN}; "
          f"reduced {json.dumps(reduced)}; peak reckoned "
          f"{json.dumps(predicted)} GiB")

    real_fa = attn_mod.flash_attention
    k6_in = {}

    def capture(q, k, v, **kw):
        # the phase's K6 shape: whisper's encoder (non-causal), the first
        # causal call elsewhere
        if not k6_in and (kw["causal"] is False or not cfg.enc_dec):
            k6_in.update(q=q, k=k, v=v, kw=kw)
        return real_fa(q, k, v, **kw)

    K.reset_launches()
    FK.reset_launches()
    # ---- the serving path: counts from 0 here, read at the end ----------
    attn_mod.flash_attention = capture
    try:
        (logits, state), prefill_s = synced(lambda: eng.prefill(batch))
    finally:
        attn_mod.flash_attention = real_fa
    want_pos = T + (FAM_PATCHES if cfg.family == "vlm" else 0)
    check(int(state["pos"]) == want_pos,
          f"{arch}: pos {int(state['pos'])} after the prefill, not "
          f"{want_pos}")
    decode_ms = []
    for _ in range(FAM_STEPS):
        (state, _), dt = synced(lambda: eng.step(state))
        decode_ms.append(dt * 1e3)
    state_bytes = sum(v.nbytes for v in _leaves(state).values())
    pos = int(state["pos"])
    probe = dict(state, pos=torch.tensor(pos + HEADROOM, dtype=torch.int32,
                                         device=DEV))
    rep, scrutiny_s = synced(lambda: scrutinize(
        eng.resume_fn(HORIZON), probe, config=ScrutinyConfig(probes=2),
        device=DEV))
    crit = pos + HEADROOM
    for name, leaf in _leaves(state).items():
        if name.endswith(("/xk", "/xv")) or not name.startswith("cache/"):
            check(rep[name].all_critical, f"{arch}: {name} must be all "
                  f"critical")
            continue
        sel = (torch.arange(leaf.shape[2], device=DEV) < crit).view(
            (1, 1, -1) + (1,) * (leaf.dim() - 3))
        bad = torch.nonzero(rep[name].device_mask().view(leaf.shape)
                            != sel.expand(leaf.shape))
        check(bad.numel() == 0, f"{arch}: mask of {name} differs from slot "
              f"< {crit} at {bad.shape[0]} elements, first {bad[:4].tolist()}")
    crit_bytes = sum(rep[n].critical * _leaves(state)[n].element_size()
                     for n in rep.leaves)
    rep_reads_s = rep.stats["prepass_reads_s"]

    mgr = CheckpointManager([Level(root, keep_n=2, max_chain=1)],
                            scrutiny_fn=lambda s: rep, save_mode="device",
                            restore_mode="device", device=DEV)
    t0 = time.perf_counter()
    mgr.save(1, state, block=False)
    stats1 = mgr.wait()
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(root, "step_1", f))
               for f in os.listdir(os.path.join(root, "step_1")))
    written = pos                            # the slot the next step writes
    state, _ = eng.step(state)
    mgr.save(2, state, block=True)
    check(mgr.last_save_stats["levels"][root]["kind"] == "delta",
          f"{arch}: step 2 must be a delta")
    (step, restored), restore_s = synced(
        lambda: restore_k8(mgr, _empty_like(state), arch, tables=False))
    h2d = mgr.last_restore_stats["h2d_bytes"]
    mgr.close()
    check(step == 2, f"{arch}: restored step {step}, not 2")
    toks, want = _continue(eng, state, CONTINUE)
    r_toks, r_lg = _continue(eng, restored, CONTINUE)
    check(torch.equal(toks, r_toks) and torch.equal(want, r_lg),
          f"{arch}: decoding from the restored step 2 differs")
    launches = {**{k: K.LAUNCHES[k] for k in CKPT_KERNELS},
                "flash_attention": FK.LAUNCHES["flash_attention"]}
    # ---- end of the serving path ---------------------------------------
    # (K8 is held to the restore's region tables by restore_k8)
    check(all(v > 0 for k, v in launches.items() if k != "regions_words"),
          f"{arch}: a kernel of its serving path was never launched: "
          f"{launches}")
    # the save moved the critical payload and the restore brought it back
    check(crit_bytes <= stats1["d2h_bytes"] <= crit_bytes + state_bytes // 8
          and crit_bytes <= h2d <= crit_bytes + state_bytes // 8,
          f"{arch}: d2h {stats1['d2h_bytes']} / h2d {h2d} B against "
          f"{crit_bytes} B critical (at most one mask bit an element more)")
    # the delta holds the one slot the step wrote, in each slot leaf
    chunk = ops.DELTA_CHUNK_BYTES
    for name, idx in _changed_chunks(root, 2).items():
        leaf = _leaves(state).get(name)
        if name.startswith("cache/") and not name.endswith(("/xk", "/xv")):
            row = int(np.prod(leaf.shape[3:])) * leaf.element_size()
            rows = leaf.shape[0] * leaf.shape[1]
            start = (np.arange(rows) * crit + written) * row
            want_idx = np.unique(np.concatenate([
                np.arange(a // chunk, (a + row - 1) // chunk + 1)
                for a in start]))
            check(np.array_equal(np.sort(idx), want_idx),
                  f"{arch}: delta of {name}: {idx.size} chunks, not the "
                  f"{want_idx.size} of slot {written}")
        else:
            check(idx.size <= 1 and (name != "pos" or idx.size == 1),
                  f"{arch}: delta of {name}: {idx.tolist()}")
    del restored, rep
    # K6 against its plain version at the phase's shape
    q, k, v, kw = (k6_in[n] for n in ("q", "k", "v", "kw"))
    k6_err = fa_err(real_fa(q, k, v, **kw),
                    flash_attention_ref(q, k, v, **kw), fa_tol(q.dtype),
                    f"{arch}: K6 at {tuple(q.shape)}/{tuple(v.shape)}")
    # prefill + decode against the full forward at position T, in f32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    del eng, state, toks, want, r_toks, r_lg, logits
    torch.cuda.empty_cache()
    pos_t = torch.tensor(want_pos, dtype=torch.int32, device=DEV)

    def prefill_decode():
        _, cache = prefill(cfg32, params, batch, SERVE_MAX_LEN)
        return decode_step(cfg32, params, cache, full["tokens"][:, T:],
                           pos_t)[0]

    layer_gaps = None
    with torch.no_grad(), LayerTap() as tap:
        # the MoE models' residual streams, layer by layer (ROADMAP Queue 3
        # item 2: where the pinned path leaves the full forward)
        tap.mode = "full" if cfg.moe is not None else None
        with RoutingPin() as pin:                  # records the routing
            full_lg = full_logits(cfg32, params, full)[:, -1]
        tap.mode = None
        free = prefill_decode() if pin.log else None
        if pin.log:
            tap.mode = "prefill" if cfg.moe is not None else None
            with pin.replay(0):
                _, cache = prefill(cfg32, params, batch, SERVE_MAX_LEN)
            tap.mode = "decode" if cfg.moe is not None else None
            with pin.replay(T):
                got = decode_step(cfg32, params, cache,
                                  full["tokens"][:, T:], pos_t)[0]
            tap.mode = None
            del cache
        else:
            got = prefill_decode()
        if tap.kept:
            layer_gaps = tap.gaps(T)
            tap.kept.clear()
    gap = float((got - full_lg).abs().max())
    top = max(float(full_lg.abs().max()), 1.0)
    check(gap <= FAM_CONSISTENCY_TOL * top,
          f"{arch}: prefill + decode differs from the full forward at "
          f"position T by {gap} (largest |logit| {top})")
    free_gap = (f"; {float((free - full_lg).abs().max()):.3e} without the "
                f"pinned routing" if free is not None else "")
    del got, full_lg, free, params
    peak = torch.cuda.max_memory_allocated()
    fig = {"prefill_s": round(prefill_s, 4),
           "decode_ms": round(float(np.median(decode_ms)), 3),
           "scrutiny_s": round(scrutiny_s, 4),
           "prepass_reads_s": round(rep_reads_s, 4),
           "save_s": round(save_s, 4),
           "restore_s": round(restore_s, 4),
           "disk_frac": round(disk / state_bytes, 6),
           "d2h_frac": round(stats1["d2h_bytes"] / state_bytes, 6),
           "h2d_frac": round(h2d / state_bytes, 6),
           "state_bytes": state_bytes,
           "peak_gib": round((peak - held) / 2 ** 30, 2),
           "held_before_gib": round(held / 2 ** 30, 2),
           "peak_reckoned_gib": predicted["total"]}
    print(f"families: {arch}: {json.dumps(fig)}")
    if layer_gaps is not None:
        print(f"families: {arch}: pinned prefill + decode against the full "
              f"forward, per layer, max |Δ| / max |layer output|: "
              f"{json.dumps(layer_gaps)}")
    print(f"families: {arch}: K6 at q {tuple(q.shape)} v {tuple(v.shape)} "
          f"causal={kw['causal']} within {fa_tol(q.dtype)} of the plain "
          f"version (max |Δ| {k6_err:.6f}); f32 prefill + decode against "
          f"the full forward at T: max |Δ| {gap:.3e} (bound "
          f"{FAM_CONSISTENCY_TOL} x {top:.3f}){free_gap}; restored step 2 "
          f"continues "
          f"{CONTINUE} tokens bit-identically; launches "
          f"{json.dumps(launches)}")
    torch.cuda.empty_cache()
    return launches, (arch, q, k, v, kw)


def phase_families(root: str):
    """Phase 9 → (launches summed over its models, K6's inputs a model)."""
    t0 = time.perf_counter()
    total, k6 = {}, []
    for i, (arch, changes, reduced) in enumerate(FAMILIES):
        launches, inputs = serve_family(arch, changes, reduced,
                                        os.path.join(root, arch), 2029 + i)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        k6.append(inputs)
    print(f"families: launches {json.dumps(total)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return total, k6


# ----------------------------------------------------------------------------
# phase 7: training recurrentgemma-2b at full width
# ----------------------------------------------------------------------------

TRAIN_ARCH = "recurrentgemma-2b"
# Every published width (d_model 2560, lru_dim 2560, 10 heads, MQA, head_dim
# 256, window 2048, vocab 256,000); depth cut to whole rrl cycles so that
# the scrutiny of the training state fits 80 GB (PERF.md, section 4).
TRAIN_LAYERS = 12
TRAIN_B, TRAIN_T = 2, 1024
TRAIN_STEPS = 5              # the straight run
SAVE_STEP = 2                # scrutinized and full saves after this step
# the launcher's smoke run: (arch, --seq).  xlstm-125m's participation
# traces its sLSTM/mLSTM step by step (about 1.5 ms a node on the card's
# host): 32 tokens, cut from 64 for the script's time
SMOKE_ARCHS = (("xlstm-125m", 32), (TRAIN_ARCH, 64))


class KernelCheck:
    """While active, every K7 and K6 launch (forward and backward) is held
    against its plain version on the same inputs with :func:`scaled_err`;
    the kernels' outputs go on, so the run is the kernels' run.  The first
    call of each kind keeps its inputs for phase 5."""

    def __init__(self):
        self.err = {"lru_scan": 0.0, "lru_scan_backward": 0.0,
                    "flash_attention": 0.0, "flash_attention_backward": 0.0}
        self.rel = dict(self.err)
        self.calls = dict.fromkeys(self.err, 0)
        self.inputs = {}
        self._b = {}
        self._real = {}

    def _note(self, name, pairs, tol, inputs):
        for got, want in pairs:
            if want is not None:
                err, rel = scaled_err(got, want, tol, f"{name} in training")
                self.err[name] = max(self.err[name], err)
                self.rel[name] = max(self.rel[name], rel)
        self.calls[name] += 1
        if name not in self.inputs and inputs is not None:
            # detached: the step's autograd graph must not outlive it
            self.inputs[name] = tuple(
                t.detach() if isinstance(t, torch.Tensor) else t
                for t in inputs)

    def lru_scan(self, a, b, h0=None):
        h = self._real["lru_scan"](a, b, h0)
        self._b[h.data_ptr()] = b
        self._note("lru_scan", [(h, lru_scan_ref(a, b, h0))],
                   lru_tol(a.dtype), (a, b, h0))
        return h

    def lru_scan_backward(self, a, h, h0, dh):
        got = self._real["lru_scan_backward"](a, h, h0, dh)
        b = self._b.pop(h.data_ptr())
        _, want = lru_plain_grads(a, b, h0, dh)
        self._note("lru_scan_backward", zip(got, want), lru_tol(a.dtype),
                   (a, b, h, h0, dh))
        return got

    def flash_attention(self, q, k, v, *, with_lse=False, **kw):
        out = self._real["flash_attention"](q, k, v, with_lse=with_lse, **kw)
        o = out[0] if with_lse else out
        self._note("flash_attention",
                   [(o, flash_attention_ref(q, k, v, **kw))],
                   fa_tol(q.dtype), None)
        return out

    def flash_attention_backward(self, q, k, v, o, lse, do, **kw):
        got = self._real["flash_attention_backward"](q, k, v, o, lse, do,
                                                     **kw)
        _, want = fa_plain_grads(q, k, v, do, **kw)
        self._note("flash_attention_backward", zip(got, want),
                   fa_tol(q.dtype), (q, k, v, o, lse, do, kw))
        return got

    _WRAPPED = ((LK, "lru_scan"), (LK, "lru_scan_backward"),
                (FK, "flash_attention"), (FK, "flash_attention_backward"))

    def __enter__(self):
        for mod, name in self._WRAPPED:
            self._real[name] = getattr(mod, name)
            setattr(mod, name, getattr(self, name))
        return self

    def __exit__(self, *exc):
        for mod, name in self._WRAPPED:
            setattr(mod, name, self._real[name])


def traced_custom_ops() -> dict:
    """The launcher's resume (``make_resume_fn``) traced on the card at the
    smoke preset: K6 and K7 are one custom-op node a call, which the
    participation walk gives the any→all rule, never a tensor it cannot
    attribute; participation then keeps every parameter."""
    from repro_torch import get_config
    from repro_torch.core import participation, traced_step
    from repro_torch.launch import train as launch
    from repro_torch.train.optim import OptConfig

    cfg = get_config(TRAIN_ARCH).reduced()
    state = launch.build_state(cfg, OptConfig(kind="adamw"), 2, 64,
                               device=DEV)
    resume = launch.make_resume_fn(cfg)
    ts = traced_step(resume, state, device=DEV)
    nodes = {}
    for n in ts.gm.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and name.startswith("repro_torch."):
            nodes[name] = nodes.get(name, 0) + 1
    check(nodes.get("repro_torch.flash_attention.default", 0) > 0
          and nodes.get("repro_torch.lru_scan.default", 0) > 0,
          f"the traced resume holds no K6/K7 custom-op node: {nodes}")
    rep = participation(resume, state, device=DEV)
    for name, leaf in rep.leaves.items():
        if name.startswith("params/"):
            check(leaf.all_critical, f"participation: {name} not all "
                  "critical")
    return nodes


def _zeroed(fn, index):
    """``fn`` with output ``index`` replaced by zeros: a planted fault of a
    backward kernel, to show that the gradient bound sees it."""
    def faulty(*args, **kw):
        out = list(fn(*args, **kw))
        out[index] = torch.zeros_like(out[index])
        return tuple(out)
    return faulty


# planted faults: (what, module, wrapper, output zeroed)
PLANTED = (("K6 backward with dV zeroed", FK, "flash_attention_backward", 2),
           ("K7 backward with da zeroed", LK, "lru_scan_backward", 0))


def _grad_distances(cfg, params, batch):
    """Relative L2 distances of the gradient from the plain path's
    (flash_attention_ref, lru_scan_ref), of the whole tree and of its
    farthest leaf: for the kernels; for the control, the plain path in the
    kernels' summation order (``ref.TiledAttention``; the plain scan is
    already in K7's order); and for the kernels with each of ``PLANTED``.
    → {run: (whole, farthest leaf, its name)}, losses."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import recurrent as rec_mod
    from repro_torch.train.step import loss_and_grads

    real = (attn_mod.flash_attention, rec_mod.lru_scan)

    def grads(attn_impl, scan_impl):
        attn_mod.flash_attention, rec_mod.lru_scan = attn_impl, scan_impl
        try:
            return loss_and_grads(cfg, params, batch)
        finally:
            attn_mod.flash_attention, rec_mod.lru_scan = real

    def dist(g, ref):
        num = den = 0.0
        far = (0.0, "")
        for (name, x), y in zip(_tree.flatten_with_names(g)[0],
                                _tree.leaves(ref)):
            n_ = float(((x.double() - y.double()) ** 2).sum())
            d_ = float((y.double() ** 2).sum())
            num, den = num + n_, den + d_
            far = max(far, ((n_ / d_) ** 0.5 if d_ else
                            (0.0 if n_ == 0 else float("inf")), name))
        return ((num / den) ** 0.5,) + far

    out, losses = {}, {}
    losses["plain"], g_plain = grads(flash_attention_ref, lru_scan_ref)
    runs = [("kernels", None), ("control", None)] + [
        (what, (mod, name, index)) for what, mod, name, index in PLANTED]
    for what, fault in runs:
        if fault is not None:
            mod, name, index = fault
            kernel = getattr(mod, name)
            setattr(mod, name, _zeroed(kernel, index))
        try:
            losses[what], g = grads(
                *((tiled_attention, lru_scan_ref)
                  if what == "control" else real))
        finally:
            if fault is not None:
                setattr(mod, name, kernel)
        out[what] = dist(g, g_plain)
        del g
    del g_plain
    torch.cuda.empty_cache()
    return out, {k: float(v) for k, v in losses.items()}


def _state_bytes(tree) -> int:
    return sum(t.nbytes for t in _tree.leaves(tree))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(dp_, f))
               for dp_, _, files in os.walk(path) for f in files)


def _train(step_fn, cfg, state, steps, ms=None):
    """Train ``steps`` steps in place → losses (float, bit-exact)."""
    from repro_torch.data import pipeline as dp
    losses = []
    for _ in range(steps):
        def one():
            batch, state["data"] = dp.next_batch(cfg, state["data"])
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], batch)
            state["step"] = state["step"] + 1
            return metrics["loss"]
        loss, dt = synced(one)
        losses.append(float(loss))
        if ms is not None:
            ms.append(dt * 1e3)
    return losses


# the gradients with remat on against remat off: every recomputed value
# is the same kernel or op on the same inputs, so equal is expected; the
# bound, times each leaf's largest |gradient|, allows another summation
# order in K6's backward
REMAT_TOL = 1e-6


def remat_modes(cfg, params, batch) -> dict:
    """One training step's loss and gradients (``loss_and_grads``) with
    remat off, "full" and "dots": ms (the first call of each apart) and
    peak memory of each, nothing of another mode held; then the loss equal
    across the three and the gradients within REMAT_TOL of off's."""
    from repro_torch.models import model as model_mod
    from repro_torch.train.step import loss_and_grads

    def run(mode):
        model_mod.set_remat_policy("dots" if mode == "off" else mode)
        return loss_and_grads(dataclasses.replace(cfg, remat=mode != "off"),
                              params, batch)

    out, modes = {}, ("off", "full", "dots")
    try:
        for mode in modes:
            # the first call of a mode apart: the first checkpointed call
            # of a process imports torch._dynamo
            _, first = synced(lambda: run(mode)[0])
            torch.cuda.reset_peak_memory_stats()
            _, dt = synced(lambda: run(mode)[0])
            out[mode] = {"first_ms": round(first * 1e3, 3),
                         "ms": round(dt * 1e3, 3), "peak_gib": round(
                             torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
        base_loss, base = run("off")
        for mode in modes[1:]:
            loss, grads = run(mode)
            check(float(loss) == float(base_loss), f"remat {mode}: loss "
                  f"{float(loss)!r} is not remat off's {float(base_loss)!r}")
            out[mode]["grad_rel"] = max(
                float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(_tree.leaves(grads), _tree.leaves(base)))
            check(out[mode]["grad_rel"] <= REMAT_TOL, f"remat {mode}: "
                  f"gradients {out[mode]['grad_rel']} > {REMAT_TOL} of off's")
            del grads
    finally:
        model_mod.set_remat_policy("dots")
    return out


def phase_training(root: str):
    from repro_torch import CheckpointManager, Level, get_config, scrutinize
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import train as launch
    from repro_torch.models import count_params
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    # remat off on the training path: at B=2, T=1024 no policy lowers the
    # step's peak, and each costs time (remat_modes; PERF.md §5)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS,
                              remat=False)
    # the launcher's --preset full settings (launch/train.py)
    oc = OptConfig(kind="adamw", lr=3e-4, warmup=100, clip_norm=1.0,
                   decay_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = launch.build_state(cfg, oc, TRAIN_B, TRAIN_T, seed=2028,
                               device=DEV)
    step_fn = make_train_step(cfg, oc)
    state_bytes = _state_bytes(state)
    print(f"training: {TRAIN_ARCH} {cfg.n_layers} layers (pattern "
          f"{cfg.layer_pattern}) d_model {cfg.d_model} lru_dim "
          f"{cfg.lru_dim} heads {cfg.n_heads}/{cfg.n_kv_heads} head_dim "
          f"{cfg.resolved_head_dim} window {cfg.window} d_ff {cfg.d_ff} "
          f"vocab {cfg.vocab}; {count_params(state['params'])} parameters "
          f"(f32, compute {cfg.dtype}); AdamW; B={TRAIN_B} T={TRAIN_T}; "
          f"state {state_bytes} B")

    # the whole gradient against the plain path and a control (before the
    # path's counts start: these launches compare, they are not the path)
    batch1, data1 = dp.next_batch(cfg, state["data"])
    dists, grad_losses = _grad_distances(cfg, state["params"], batch1)
    bound = tuple(CONTROL_FACTOR * x for x in dists["control"][:2])
    check(all(x <= b for x, b in zip(dists["kernels"][:2], bound)),
          f"gradient: relative L2 distances from the plain path (whole, "
          f"farthest leaf) {dists['kernels']} > {CONTROL_FACTOR} x the "
          f"control's {dists['control']}")
    for what, *_ in PLANTED:
        check(any(x > b for x, b in zip(dists[what][:2], bound)),
              f"gradient: the bound {bound} passes a planted fault, {what}: "
              f"{dists[what]}")
    remat = remat_modes(cfg, state["params"], batch1)
    del batch1, data1

    K.reset_launches()
    FK.reset_launches()
    LK.reset_launches()
    # ---- the training path: counts from 0 here, read at the end ----------
    straight, step_ms = {}, []
    with KernelCheck() as kc:                   # step 1, every launch held
        straight[1] = _train(step_fn, cfg, state, 1)[0]
    per_step = dict(LK.LAUNCHES, **FK.LAUNCHES)
    # one forward and one backward a layer: two RG-LRU layers and one
    # local-attention layer a unit, remat off
    units = TRAIN_LAYERS // 3
    want = {"lru_scan": 2 * units, "lru_scan_backward": 2 * units,
            "flash_attention": units, "flash_attention_backward": units}
    check(kc.calls == per_step and per_step == want,
          f"one train step launched {per_step}, checked {kc.calls}, not "
          f"{want}")
    straight[2] = _train(step_fn, cfg, state, 1, step_ms)[0]

    def save(tag, scrutiny_fn):
        with CheckpointManager([Level(os.path.join(root, tag), keep_n=1)],
                               scrutiny_fn=scrutiny_fn, device=DEV) as mgr:
            t0 = time.perf_counter()
            mgr.save(SAVE_STEP, state, block=False)
            first = mgr.last_save_stats
            stats = mgr.wait()
            torch.cuda.synchronize()
            saves[tag] = {"blocked_s": first["blocked_s"],
                          "save_s": time.perf_counter() - t0,
                          "engine": first["engine"],
                          "host_reason": first["host_reason"],
                          "d2h": stats["d2h_bytes"],
                          "disk": _dir_bytes(os.path.join(
                              root, tag, f"step_{SAVE_STEP}"))}

    saves = {}
    torch.cuda.reset_peak_memory_stats()
    save("full", None)          # first: its clone of the whole state and
    full_save_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()    # the scrutiny never hold memory together
    check(saves["full"]["engine"] == "device"
          and saves["full"]["host_reason"] is None,
          f"the save with no report must take dev_raw on the card, not a "
          f"host snapshot: {saves['full']}")
    resume = launch.make_resume_fn(cfg)
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rep, scrutiny_s = synced(lambda: scrutinize(resume, state, device=DEV))
    scrutiny_peak = torch.cuda.max_memory_allocated()
    reads_s = rep.stats["prepass_reads_s"]
    crit = {"params": 0, "moments": 0, "other": 0}
    for name, leaf in rep.leaves.items():
        if name.startswith(("opt/mu/", "opt/nu/")):
            check(leaf.critical == 0, f"{name}: {leaf.critical} critical, "
                  "not 0 (a one-step horizon never reads the moments)")
            crit["moments"] += leaf.total
        else:
            check(leaf.all_critical, f"{name} must be all critical: "
                  f"{leaf.critical} of {leaf.total}")
            crit["params" if name.startswith("params/") else "other"] += \
                leaf.total
    torch.cuda.reset_peak_memory_stats()
    save("scrutinized", lambda s: rep)
    save_peak = torch.cuda.max_memory_allocated()
    save_held = torch.cuda.memory_allocated()    # the report still alive
    # the same state and report saved by four host threads: each clones
    # its owned quarter of every all-critical leaf at save() (the
    # optimizer updates the state in place), the moments cost nothing
    coord_root = os.path.join(root, "coordinated")
    kept_bytes = sum(t.nbytes for n, t in _tree.flatten_with_names(state)[0]
                     if not n.startswith(("opt/mu/", "opt/nu/")))
    coord_reckoned = save_held + kept_bytes

    def coord_save(p, coll):
        from repro_torch.checkpoint import CoordinatedCheckpointManager
        with CoordinatedCheckpointManager(
                [Level(coord_root, keep_n=1)], collective=coll,
                scrutiny_fn=lambda s: rep, partner_replication=False,
                device=DEV) as mgr:
            t0 = time.perf_counter()
            mgr.save(SAVE_STEP, state, block=False)
            blocked = mgr.last_save_stats["blocked_s"]
            stats = mgr.wait()
            torch.cuda.synchronize()
            return {"blocked_s": round(blocked, 4),
                    "save_s": round(time.perf_counter() - t0, 4),
                    "d2h": stats["d2h_bytes"],
                    "written": stats["host_bytes_written"]}

    torch.cuda.reset_peak_memory_stats()
    coord = hosts_ok(*host_threads(HOSTS, os.path.join(root, "rdv"),
                                   coord_save), "training: coordinated save")
    coord_peak = torch.cuda.max_memory_allocated()
    check(sum(c["written"] for c in coord) == kept_bytes,
          f"training: the hosts wrote {[c['written'] for c in coord]} B, "
          f"not the kept leaves' {kept_bytes} B")
    del rep
    torch.cuda.empty_cache()
    # what both restores must give back exactly: all but the moments
    keep = {n: t.clone() for n, t in _tree.flatten_with_names(state)[0]
            if not n.startswith(("opt/mu/", "opt/nu/"))}
    for step in range(SAVE_STEP + 1, TRAIN_STEPS + 1):
        straight[step] = _train(step_fn, cfg, state, 1, step_ms)[0]
    launches = dict(LK.LAUNCHES, **FK.LAUNCHES)
    mask_launches = dict(K.LAUNCHES)
    # ---- end of the training path ----------------------------------------
    named, treedef = _tree.flatten_with_names(state)
    like = _tree.unflatten(treedef, [torch.empty_like(t, device="meta")
                                     for _, t in named])
    del state, named
    torch.cuda.empty_cache()

    def restore(tag):
        k4_before = K.LAUNCHES["mask_scatter"]
        with CheckpointManager([Level(os.path.join(root, tag), keep_n=1)],
                               device=DEV) as mgr:
            (step, st), restore_s = synced(lambda: mgr.restore(like))
            saves[tag]["restore_s"] = restore_s
            saves[tag]["h2d"] = mgr.last_restore_stats["h2d_bytes"]
            saves[tag]["k4"] = K.LAUNCHES["mask_scatter"] - k4_before
        check(step == SAVE_STEP, f"{tag} restore gave step {step}")
        for n, t in _tree.flatten_with_names(st)[0]:
            if n in keep:
                check(same_bytes(t, keep[n]), f"{tag} restore: {n} differs")
            elif tag == "scrutinized":
                check(not bool(t.any()), f"{tag} restore: {n} is not the "
                      "fill")
        return st

    # full restore: the straight run's losses again
    st = restore("full")
    again = _train(step_fn, cfg, st, TRAIN_STEPS - SAVE_STEP)
    want = [straight[s] for s in range(SAVE_STEP + 1, TRAIN_STEPS + 1)]
    check(np.allclose(again, want, rtol=1e-5, atol=0),
          f"full restore: losses {again} vs the straight run's {want}")
    full_bitwise = again == want
    del st
    torch.cuda.empty_cache()
    # scrutinized restore: parameters and integer leaves exact, the moments
    # the fill; the next loss bitwise, the later ones as they come.  The
    # moments (no critical element) send no mask bits and launch no K4:
    # H2D is exactly the kept leaves' bytes
    st = restore("scrutinized")
    check(saves["scrutinized"]["h2d"] == kept_bytes
          and saves["scrutinized"]["k4"] == 0,
          f"scrutinized restore: h2d {saves['scrutinized']['h2d']} B, not "
          f"the kept leaves' {kept_bytes} B, or {saves['scrutinized']['k4']}"
          f" K4 launches for leaves with no critical element")
    scr = _train(step_fn, cfg, st, TRAIN_STEPS - SAVE_STEP)
    check(scr[0] == want[0], f"scrutinized restore: step {SAVE_STEP + 1} "
          f"loss {scr[0]!r} is not the straight run's {want[0]!r}")
    gap = [s_ - w for s_, w in zip(scr, want)]
    del st
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(root, "full"))   # 20 GB of disk, restored
    # the coordinated checkpoint onto one host, and its continuation
    K.reset_launches()
    FK.reset_launches()
    LK.reset_launches()
    # ---- the coordinated training path: counts from 0 here ---------------
    from repro_torch.checkpoint import CoordinatedCheckpointManager
    with CoordinatedCheckpointManager([Level(coord_root)], device=DEV) as mgr:
        (step, st), coord_restore_s = synced(lambda: mgr.restore(like))
        coord_rst = dict(mgr.last_restore_stats)
    check(step == SAVE_STEP, f"coordinated restore gave step {step}")
    for n, t in _tree.flatten_with_names(st)[0]:
        check(same_bytes(t, keep[n]) if n in keep else not bool(t.any()),
              f"coordinated restore: {n} differs")
    coord_cont = _train(step_fn, cfg, st, TRAIN_STEPS - SAVE_STEP)
    coord_launches = {**{k: K.LAUNCHES[k] for k in CKPT_KERNELS},
                      **LK.LAUNCHES, **FK.LAUNCHES}
    # ---- end of the coordinated training path ----------------------------
    shutil.rmtree(coord_root)
    check(coord_cont == scr, f"coordinated restore: losses {coord_cont} "
          f"are not the scrutinized single-process restore's {scr}")
    check(coord_rst["h2d_bytes"] == kept_bytes,
          f"coordinated restore: h2d {coord_rst['h2d_bytes']} B, not the "
          f"kept leaves' {kept_bytes} B")
    del st, keep, like
    torch.cuda.empty_cache()
    peak = max(peak_before, full_save_peak, scrutiny_peak, save_peak,
               coord_peak, torch.cuda.max_memory_allocated())
    custom_ops = traced_custom_ops()
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the training path was never launched: {launches}")

    # the launcher, as a user runs it, then resumed
    smoke = {}
    for arch, seq in SMOKE_ARCHS:
        d = os.path.join(root, "launcher", arch)
        args = ["--arch", arch, "--preset", "smoke", "--batch", "2",
                "--seq", str(seq), "--ckpt-every", "10", "--scrutinize",
                "--ckpt-dir", d, "--log-every", "1000", "--device", DEV]
        first, first_s = synced(lambda: launch.main(args + ["--steps",
                                                             "30"]))
        resumed = launch.main(args + ["--steps", "40", "--resume"])
        check(len(first) == 30 and len(resumed) == 10
              and bool(np.isfinite(first + resumed).all()),
              f"launcher smoke {arch}: {len(first)} + {len(resumed)} steps")
        smoke[arch] = (first[0], first[-1], resumed[-1], first_s)

    print(f"training: train_step_ms(median of steps 2-{TRAIN_STEPS})="
          f"{float(np.median(step_ms)):.3f} losses "
          f"{json.dumps([straight[s] for s in sorted(straight)])}")
    print(f"training: one checked step: every K7 and K6 launch within "
          f"its tolerance times the largest |value| of its plain version "
          f"{json.dumps(kc.calls)}; max |err| "
          f"{json.dumps(kc.err)}; max |err| / max |value| "
          f"{json.dumps(kc.rel)}")
    print(f"training: gradient relative L2 distance from the plain path "
          f"(whole tree, farthest leaf, its name), bound {CONTROL_FACTOR} x "
          f"the control's (TiledAttention) on either: "
          f"{json.dumps(dists)}; each planted fault breaks the bound; "
          f"losses {json.dumps(grad_losses)}")
    print(f"training: scrutiny of the state after step {SAVE_STEP}: "
          f"scrutiny_s={scrutiny_s:.4f} (reads pre-pass "
          f"{reads_s:.4f}); parameters {crit['params']} "
          f"elements all critical, moments {crit['moments']} elements 0 "
          f"critical, integer leaves {crit['other']} elements critical")
    for tag, sv in saves.items():
        print(f"training: {tag} save: engine {sv['engine']} (host reason "
              f"{sv['host_reason']}) blocked_s={sv['blocked_s']:.4f} "
              f"save_s={sv['save_s']:.4f} restore_s={sv['restore_s']:.4f} "
              f"(K4 launches {sv['k4']}); "
              f"disk {sv['disk']} B ({sv['disk'] / state_bytes:.4%}), d2h "
              f"{sv['d2h']} B ({sv['d2h'] / state_bytes:.4%}), h2d "
              f"{sv['h2d']} B ({sv['h2d'] / state_bytes:.4%}) of the state")
    print(f"training: full restore continues steps {SAVE_STEP + 1}-"
          f"{TRAIN_STEPS} within rtol 1e-5 (bitwise: {full_bitwise}); "
          f"scrutinized restore: step {SAVE_STEP + 1} loss bitwise equal, "
          f"loss gap at steps {SAVE_STEP + 1}-{TRAIN_STEPS} "
          f"{json.dumps(gap)} (the moments were dropped)")
    print(f"training: coordinated save by {HOSTS} host threads (the "
          f"scrutinized save's report; no L2 replicas): per host "
          f"{json.dumps(coord)}; restored onto one host (4 → 1, range "
          f"reads) restore_s={coord_restore_s:.4f} h2d "
          f"{coord_rst['h2d_bytes']} B; steps {SAVE_STEP + 1}-{TRAIN_STEPS}"
          f" losses {json.dumps(coord_cont)} bit-identical to the "
          f"scrutinized single-process restore's; peak device memory "
          f"during the save {coord_peak / 2 ** 30:.2f} GiB (reckoned "
          f"{coord_reckoned / 2 ** 30:.2f} GiB: held + the clones of the "
          f"kept leaves); launches {json.dumps(coord_launches)}")
    print(f"training: launcher smoke (first loss, loss at 30, loss at 40 "
          f"after --resume, seconds of the first run) {json.dumps(smoke)}")
    print(f"training: the launcher's resume traced on the card (smoke "
          f"{TRAIN_ARCH}): custom-op nodes {json.dumps(custom_ops)}")
    print(f"training: peak device memory {peak / 2 ** 30:.2f} GiB (during "
          f"the full save, dev_raw clones of every leaf, "
          f"{full_save_peak / 2 ** 30:.2f} GiB; during "
          f"the scrutiny {scrutiny_peak / 2 ** 30:.2f} GiB, during the "
          f"scrutinized save {save_peak / 2 ** 30:.2f} GiB, held after it "
          f"with the report alive {save_held / 2 ** 30:.2f} GiB: the save "
          f"reads the report's words, no byte mask is cached); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    print(f"training: one step's loss and gradients with remat off, "
          f"\"full\" and \"dots\" (ms, peak GiB, max |Δg| / max |g| "
          f"against off, bound {REMAT_TOL}): {json.dumps(remat)}; the "
          f"losses equal")
    print(f"training: launches {json.dumps(launches)}; per train step "
          f"{json.dumps(per_step)}; mask kernels {json.dumps(mask_launches)}"
          f" (the saved leaves are all or none critical)")
    return launches, per_step, kc.inputs, mask_launches, coord_launches


# ----------------------------------------------------------------------------
# phase 8: the paper's NPB evaluation, the eight class-S programs
# ----------------------------------------------------------------------------

# Table II (tests/test_npb_paper.py:16-31, the rho_i/rsd swap corrected);
# FT(y) is round-off off its lattice and is checked by structure instead
NPB_TABLE2 = {
    "bt": {"u": (1500, 10140)},
    "sp": {"u": (1500, 10140)},
    "cg": {"x": (2, 1402)},
    "lu": {"u": (1628, 10140), "rho_i": (300, 2028), "qs": (300, 2028),
           "rsd": (1500, 10140)},
    "mg": {"u": (7176, 46480), "r": (10543, 46480)},
    "ft": {"sums": (3, 6)},
    "ep": {"q": (0, 10), "sx": (0, 1), "sy": (0, 1)},
    "is": {"key_array": (0, 65536), "bucket_ptrs": (0, 512)},
}
# participation (structural reads) gives Table II exactly, FT(y) included:
# 4,096 of 266,240 (the kx = 64 plane), independent of the FFT's round-off
NPB_PART_TABLE2 = dict(NPB_TABLE2, ft={"y": (4096, 266240), "sums": (3, 6)})
# Table III, paper_storage_saved in %: the paper's numbers, within 0.5
NPB_TABLE3 = {"bt": 14.8, "sp": 14.8, "mg": 19.1, "cg": 0.1, "lu": 15.7}
REF_FT_Y_CRITICAL = 56176    # the reference's AD count on the CPU


def phase_npb(root: str):
    """Each program on the card: its checkpoint state, AD scrutiny (K1 on
    the f64 accumulators of the float64 and complex128 leaves), Table II,
    the §IV-C restart (K2 tiled, a launch a leaf, + one K5 launch a
    program) and both corruptions, a scrutinized save and a restore into
    fresh tensors (K2 dense, K4) that resumes and verifies, and Table III.
    → (launches over the phase, K5's groups in the restart: (program,
    leaf names, tiled packs, words, ns) for each program, timed in phase
    5)."""
    from repro_torch import CheckpointManager, Level
    from repro_torch.core.report import storage_table, summary_table
    from repro_torch.npb import ALL_BENCHMARKS, get_benchmark
    from repro_torch.npb.common import verify_restart
    from repro_torch.npb.ft import lattice_mask

    K.reset_launches()
    t0 = time.perf_counter()
    k5_inputs = []
    for name in ALL_BENCHMARKS:
        bench = get_benchmark(name)          # the card, by default
        check(bench.device.type == "cuda", f"npb {name} is not on the card")
        state = bench.checkpoint_state()
        rep, scrutiny_s = synced(bench.scrutinize)
        for var, want in NPB_TABLE2[name].items():
            got = (rep[var].uncritical, rep[var].total)
            check(got == want, f"npb {name}({var}): {got}, Table II {want}")
        if name == "ft":
            m = rep["y"].device_mask()
            lattice = torch.from_numpy(lattice_mask()).to(DEV)
            pad = torch.arange(m.numel(), device=DEV) % 65 == 64
            check(bool(m[lattice].all()) and not bool(m[pad].any()),
                  "npb ft(y): the lattice must be critical, kx = 64 not")
            print(f"npb ft(y): {rep['y'].critical} of {rep['y'].total} "
                  f"critical (the reference on the CPU: "
                  f"{REF_FT_Y_CRITICAL}); the 4096 lattice elements "
                  f"critical, the kx = 64 plane uncritical")
        # K5's group in the restart: every leaf's tiled pack (by the plain
        # version: no launch counted here), its words, its n
        named = _tree.flatten_with_names(state)[0]
        k5_inputs.append((name, [leaf for leaf, _ in named],
                          [ref.pack_blocks_ref(v.reshape(-1),
                                               rep[leaf].device_mask())[0]
                           for leaf, v in named],
                          [rep[leaf].device_words() for leaf, _ in named],
                          [v.numel() for _, v in named]))
        ok, restart_s = synced(lambda: verify_restart(bench, rep))
        check(ok, f"npb {name}: the restart from critical elements failed")
        check(verify_restart(bench, rep, corrupt="uncritical"),
              f"npb {name}: uncritical garbage broke verification")
        if name != "is":         # IS holds no float element to corrupt
            check(not verify_restart(bench, rep, corrupt="critical"),
                  f"npb {name}: corrupted critical elements verified")
        analysis = npb_static(bench, state, rep)
        with CheckpointManager([Level(os.path.join(root, name), keep_n=1)],
                               scrutiny_fn=lambda s: rep, save_mode="device",
                               restore_mode="device", device=DEV) as mgr:
            _, save_s = synced(lambda: mgr.save(1, state, block=True))
            saved = mgr.last_save_stats
            (step, got), restore_s = synced(lambda: mgr.restore(
                {k: torch.empty_like(v) for k, v in state.items()}))
            h2d = mgr.last_restore_stats["h2d_bytes"]
        check(step == 1, f"npb {name}: restored step {step}")
        for leaf, v in state.items():
            mask = rep[leaf].device_mask().view(v.shape)
            check(same_bytes(got[leaf], torch.where(mask, v,
                                                    torch.zeros_like(v))),
                  f"npb {name}({leaf}): restored bytes differ")
        check(bench.verify(bench.resume(got), bench.reference()),
              f"npb {name}: the run resumed from disk does not verify")
        paper = 100 * rep.paper_storage_saved
        if name in NPB_TABLE3:
            check(abs(paper - NPB_TABLE3[name]) < 0.5,
                  f"npb {name}: saved {paper:.2f} %, Table III "
                  f"{NPB_TABLE3[name]} %")
        print(summary_table(rep, f"{name} (Table II)"))
        print(storage_table(rep, f"{name} (Table III)"))
        full = sum(v.nbytes for v in state.values())
        print(summary_table(analysis.pop("report"),
                            f"{name} (Table II, participation)"))
        print(f"npb {name}: participation, static analysis and the pruned "
              f"sweep {json.dumps(analysis)}")
        print(f"npb {name}: scrutiny_s={scrutiny_s:.4f} (reads pre-pass "
              f"{rep.stats['prepass_reads_s']:.4f}) "
              f"restart_s={restart_s:.4f} save_s={save_s:.4f} "
              f"restore_s={restore_s:.4f} full_bytes={full} "
              f"d2h_bytes={saved['d2h_bytes']} h2d_bytes={h2d} "
              f"disk_bytes={_dir_bytes(os.path.join(root, name))} "
              f"paper_storage_saved={paper:.2f} % "
              f"storage_saved={100 * rep.storage_saved:.2f} %")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for k in ("threshold_bitpack", "pack", "mask_scatter", "unpack"):
        check(launches[k] > 0, f"npb: {k} was never launched: {launches}")
    check(launches["unpack"] == 2 * len(k5_inputs),
          f"npb: {launches['unpack']} K5 launches for {len(k5_inputs)} "
          f"programs, not one a program for each of the AD and the "
          f"participation restarts")
    print(f"npb: eight programs in {seconds:.1f} s; launches "
          f"{json.dumps(launches)}")
    return launches, k5_inputs


def npb_static(bench, state, ad) -> dict:
    """Participation on the card: Table II exactly (FT y included), AD ⊆
    participation on every leaf, and the §IV-C matrix from its masks; the
    static analyzer holds the AD report (AD ⊆ static); the sweep pruned by
    it gives the AD masks bit for bit."""
    from repro_torch import ScrutinyConfig, scrutinize
    from repro_torch.analysis import analyze_static, verify_soundness
    from repro_torch.npb.common import verify_restart

    name = bench.name
    part, part_s = synced(bench.participation)
    for var, want in NPB_PART_TABLE2[name].items():
        got = (part[var].uncritical, part[var].total)
        check(got == want, f"npb {name}({var}): participation {got}, Table "
              f"II {want}")
    for var, leaf in part.leaves.items():
        check(not bool((ad[var].device_mask().cpu().numpy()
                        & ~leaf.mask).any()),
              f"npb {name}({var}): AD-critical outside participation")
    check(verify_restart(bench, part)
          and verify_restart(bench, part, corrupt="uncritical"),
          f"npb {name}: the restart from participation masks failed")
    if name != "is":
        check(not verify_restart(bench, part, corrupt="critical"),
              f"npb {name}: corrupted critical elements verified "
              f"(participation)")
    static, static_s = synced(lambda: analyze_static(bench.resume, state,
                                                     device=DEV))
    sound = verify_soundness(ad, static)
    check(sound.ok, f"npb {name}: soundness {sound}")
    pruned, pruned_s = synced(lambda: scrutinize(
        bench.resume, state, config=ScrutinyConfig(static_prune=True),
        device=DEV))
    for var, leaf in ad.leaves.items():
        check(torch.equal(pruned[var].device_words(), leaf.device_words()),
              f"npb {name}({var}): the pruned sweep's mask differs")
    return {"report": part, "participation_s": round(part_s, 4),
            "static_s": round(static_s, 4),
            "pruned_scrutiny_s": round(pruned_s, 4),
            "soundness_checked_leaves": sound.checked_leaves,
            "static_pruned_elements":
                pruned.stats.get("static_pruned_elements", 0),
            "participation_uncritical": {
                var: [leaf.uncritical, leaf.total]
                for var, leaf in part.leaves.items()}}


# ----------------------------------------------------------------------------
# phase 11: serving sessions, phi4-mini-3.8b at full width and depth
# ----------------------------------------------------------------------------

SESS_N, SESS_T = 4, 1024     # sessions of B = 1, prompt tokens
SESS_PRE_STEPS = 4           # decode steps before the base snapshot
SESS_CAP = 3                 # the adopter's max_sessions: adopts one, sheds one


def _same_state(a, b) -> bool:
    na, nb = _leaves(a), _leaves(b)
    return na.keys() == nb.keys() and all(same_bytes(na[k], nb[k])
                                          for k in na)


def _decode_tokens(eng, state, n):
    toks = []
    for _ in range(n):
        state, tok = eng.step(state)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def phase_sessions(root: str):
    """Four sessions of phase 6's model (phi4-mini-3.8b, seed 2027, bf16
    compute and cache, the scrutiny reading the cache in f32) on two host
    threads, two each, with a ``FileCollective`` and the levels' L2
    partner: a base snapshot after 4 decode steps (fresh scrutiny), one
    step, a delta snapshot.  A fresh
    manager restores them (migration) and each continues 8 tokens bit for
    bit as the uninterrupted decode.  Then new managers on both hosts take
    one step more and snapshot with host 0 killed after its L2 replicate:
    host 1 commits it degraded and, with ``max_sessions=3``, adopts one of
    host 0's sessions from the partner replica, sheds the other, and
    continues bit for bit."""
    from repro_torch import Engine, Level, get_config
    from repro_torch.checkpoint import read_manifest
    from repro_torch.models import init_params
    from repro_torch.serve import SessionManager, migrate
    from repro_torch.testing.faults import FaultInjector

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2027)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, init_params(cfg, gen), SERVE_MAX_LEN, device=DEV)
    prompts = {f"s{i}": torch.randint(0, cfg.vocab, (1, SESS_T),
                                      generator=gen, device=DEV,
                                      dtype=torch.int32)
               for i in range(SESS_N)}
    by_host = {0: ["s0", "s1"], 1: ["s2", "s3"]}
    store = os.path.join(root, "store")

    def manager(coll=None, **kw):
        return SessionManager(eng, [Level(store, keep_n=4, max_chain=8)],
                              collective=coll, horizon=HORIZON,
                              rescrutinize_every=2, **kw)

    K.reset_launches()
    FK.reset_launches()
    # ---- the sessions path: counts from 0 here, read at the end ----------
    def serve(p, coll):
        with manager(coll, save_mode="device") as sm:
            for sid in by_host[p]:
                sm.open(sid, {"tokens": prompts[sid]})
                sm.decode(sid, SESS_PRE_STEPS)
            live = sum(v.nbytes for s in sm.sessions.values()
                       for v in _leaves(s).values())
            _, base_s = synced(lambda: sm.snapshot(0, block=True))
            stats = sm.last_session_stats["sessions"]
            for sid in by_host[p]:
                sm.step(sid)
            _, delta_s = synced(lambda: sm.snapshot(1, block=True))
            return {"sessions": dict(sm.sessions), "live": live,
                    "stats": dict(stats), "base_s": base_s,
                    "delta_s": delta_s}

    hosts = hosts_ok(*host_threads(2, os.path.join(root, "rdv1"), serve),
                     "sessions: serve")
    live = {sid: s for h in hosts for sid, s in h["sessions"].items()}
    live_bytes = sum(h["live"] for h in hosts)
    st = [v for h in hosts for v in h["stats"].values()]
    unc_rate = sum(s["uncritical"] for s in st) / sum(s["total"] for s in st)
    man0, man1 = read_manifest(store, 0), read_manifest(store, 1)
    check(not man0.get("chain") and man1.get("chain"),
          f"sessions: step 0 must be a base, step 1 a delta: chains "
          f"{man0.get('chain')} {man1.get('chain')}")
    snap_bytes, delta_bytes = man0["payload_bytes"], man1["payload_bytes"]

    # migration: a fresh manager restores every session and serves a token
    def migrate_all():
        sm = manager()
        step = sm.restore()
        first = {sid: sm.step(sid) for sid in sorted(sm.sessions)}
        return sm, step, first

    (sm, step, first), downtime_s = synced(migrate_all)
    check(step == 1 and sorted(sm.sessions) == sorted(live),
          f"sessions: migration restored step {step}, {sorted(sm.sessions)}")
    for sid, state in live.items():
        want = _decode_tokens(eng, state, CONTINUE)
        got = torch.cat([first[sid][:, None],
                         sm.decode(sid, CONTINUE - 1)], dim=1)
        check(torch.equal(got, want), f"sessions: {sid} after migration "
              f"decodes {got.tolist()}, not {want.tolist()}")
    migrate_stats = dict(sm.ckpt.last_restore_stats)
    sm.close()

    # a host killed mid-decode: degraded commit, adoption, load shedding
    after = {sid: eng.step(s)[0] for sid, s in live.items()}

    def degraded(p, coll):
        inj = (FaultInjector().kill_at("after_replicate", match="q1")
               if p == 0 else None)
        sm = manager(coll, save_mode="device",
                     barrier_timeout_s=DEGRADED_TIMEOUT_S,
                     fault_injector=inj,
                     max_sessions=SESS_CAP if p == 1 else None)
        sm.sessions.update({sid: live[sid] for sid in by_host[p]})
        for sid in by_host[p]:
            sm.step(sid)
        sm.snapshot(2, block=True)          # host 0 dies inside this one
        rep, adopt_s = synced(lambda: migrate.adopt_sessions(sm,
                                                             dead_host=0))
        toks = {sid: sm.decode(sid, CONTINUE) for sid in sm.sessions}
        sm.close()
        return rep, adopt_s, toks

    results, errors = host_threads(2, os.path.join(root, "rdv2"), degraded)
    check(errors[0] is not None and errors[1] is None,
          f"sessions: host 0 must die and host 1 survive: {errors}")
    rep, adopt_s, toks = results[1]
    # the dead host's traceback holds its frame, its manager and through
    # it the engine's 23 GB of parameters, in a cycle only the collector
    # frees: the data-parallel ranks need that memory
    del results, errors
    gc.collect()
    man2 = read_manifest(store, 2)
    check([int(h) for h in man2["degraded"]["missing"]] == [0],
          f"sessions: step 2 degraded {man2.get('degraded')}")
    check(rep.step == 2 and rep.adopted == ["s0"] and rep.shed == ["s1"]
          and not rep.missing and rep.partner_served,
          f"sessions: adoption {rep}")
    for sid in ("s0", "s2", "s3"):
        want = _decode_tokens(eng, after[sid], CONTINUE)
        check(torch.equal(toks[sid], want), f"sessions: {sid} after "
              f"adoption decodes {toks[sid].tolist()}, not {want.tolist()}")
    launches = {**{k: K.LAUNCHES[k] for k in CKPT_KERNELS},
                "flash_attention": FK.LAUNCHES["flash_attention"]}
    # ---- end of the sessions path ----------------------------------------
    check(all(launches[k] > 0 for k in ("threshold_bitpack", "pack",
                                        "mask_scatter", "flash_attention")),
          f"a kernel of the sessions path was never launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    del eng, live, after, sm
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sessions: {SESS_N} sessions of {SESS_T} tokens, max_len "
          f"{SERVE_MAX_LEN}, on 2 host threads: live {live_bytes} B, "
          f"snapshot {snap_bytes} B ({snap_bytes / live_bytes:.4%}), KV "
          f"uncritical {unc_rate:.6f}, delta {delta_bytes} B a step")
    print(f"sessions: snapshot_s (base, per host) "
          f"{json.dumps([round(h['base_s'], 4) for h in hosts])} "
          f"delta_snapshot_s {json.dumps([round(h['delta_s'], 4) for h in hosts])}"
          f" migration_downtime_s={downtime_s:.4f} (a fresh manager restores "
          f"{SESS_N} sessions and serves a token each; h2d "
          f"{migrate_stats['h2d_bytes']} B); {CONTINUE} tokens a session "
          f"bit-identical to the uninterrupted decode")
    print(f"sessions: host 0 killed after its replicate at step 2: "
          f"degraded commit, host 1 adopted {rep.adopted} shed {rep.shed} "
          f"partner_served={rep.partner_served} (store bytes "
          f"{rep.read_stats['bytes_read_store']}, L2 "
          f"{rep.read_stats['bytes_read_l2']}) in {adopt_s:.4f} s; "
          f"continuations bit-identical; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; launches {json.dumps(launches)}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------------------
# phase 12: the compressed data-parallel step, two processes on the card
# ----------------------------------------------------------------------------

DP_LAYERS = 3                # one rrl unit of recurrentgemma-2b's 26 layers
DP_B, DP_FRAC = 2, 0.01      # rows a rank, top-k fraction
# every step's reduced gradient (the replicas' mean before clipping) and
# both ranks' error buffers against a one-process run of the step from
# both ranks' rows, the reference's functions composed: the same kernels
# on the same inputs (K6 and K7 use no atomics), so bit for bit is
# expected; the bound, times each leaf's largest magnitude, allows another
# summation order
DP_TOL = 1e-6

_DP_PROG = r"""
import dataclasses, json, os, time
import torch
import torch.distributed as dist
rank, W = int(os.environ["RANK"]), 2
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=W)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch import _tree, get_config
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.lru_scan import kernel as LK
from repro_torch.models import count_params, init_params
from repro_torch.train import optim, step as S
dev, T = "cuda", 1024
B, FRAC, TOL = int(os.environ["B"]), float(os.environ["FRAC"]), float(
    os.environ["TOL"])
cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                          n_layers=int(os.environ["LAYERS"]), remat=False)
mesh = {"data": W, "model": 1}
oc = optim.OptConfig(kind="adamw", lr=3e-4, warmup=100, clip_norm=1.0,
                     decay_steps=4)
params = init_params(cfg, torch.Generator(device=dev).manual_seed(2028))
n = count_params(params)

def batch(i):
    g = torch.Generator(device=dev).manual_seed(3000 + i)
    t = torch.randint(0, cfg.vocab, (W * B, T + 1), generator=g, device=dev,
                      dtype=torch.int32)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}

def leaves(tree):
    return [t for _, t in _tree.flatten_with_names(tree)[0]]

def digest(tree):
    out = []
    for p in leaves(tree):
        bits = p.detach().reshape(-1).view(torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for a in range(0, bits.numel(), 1 << 26):
            c = bits[a:a + (1 << 26)].long()
            w = torch.arange(a, a + c.numel(), device=dev) * 2654435761 \
                % 2147483647 + 1
            acc += (c * w).sum()
        out.append(acc)
    return torch.stack(out)

opt, errors = optim.init_opt(oc, params), S.init_errors(params)
# rank 0 follows both ranks' error buffers in one process
ref_err = [S.init_errors(params) for _ in range(W)] if rank == 0 else None

def counts():
    return dict(FK.LAUNCHES, **LK.LAUNCHES)

def reference(b, quantize):
    # the step's reduced gradient, the mean before clipping, from both
    # ranks' rows in one process: the loss and gradients of each rank's
    # rows, topk_ef_compress with its error buffer (advanced here), then
    # the int8 values summed in int32 with the largest scale, or the
    # dense mean
    sums, scales = None, None
    for r in range(W):
        _, g = S.loss_and_grads(cfg, params, S.local_batch(mesh, b, r))
        sparse, ref_err[r] = S.topk_ef_compress(g, ref_err[r], FRAC)
        del g
        if quantize:
            q = [S.quantize_int8(x) for x in leaves(sparse)]
            t = [x.to(torch.int32) for x, _ in q]
            s = torch.stack([sc for _, sc in q])
            del q
            scales = s if scales is None else torch.maximum(scales, s)
        else:
            t = leaves(sparse)
        del sparse
        sums = t if sums is None else [a + c for a, c in zip(sums, t)]
        del t
    if quantize:
        return [S.dequantize_int8(t, scales[i], W, torch.float32)
                for i, t in enumerate(sums)]
    return [t / W for t in sums]

def rel_err(got, want):
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))

real_clip, seen = S.clip_by_global_norm, {}

def clip(grads, norm):
    # the step's reduced gradient (before clipping) against the reference
    if "want" in seen:
        got = leaves(grads)
        seen["grad_rel"].append(rel_err(got, seen["want"]))
        seen["bitwise"].append(all(torch.equal(a, b)
                                   for a, b in zip(got, seen.pop("want"))))
    return real_clip(grads, norm)

S.clip_by_global_norm = clip
seen.update(grad_rel=[], err_rel=[], bitwise=[])
ref_launches = {}
torch.cuda.reset_peak_memory_stats()
FK.reset_launches()
LK.reset_launches()
steps = [(q, S.make_compressed_dp_step(cfg, oc, mesh, frac=FRAC, quantize=q))
         for q in (True, True, True, False)]
ms, losses, same = [], [], []
for i, (quantize, fn) in enumerate(steps):
    b = batch(i)
    if rank == 0:
        c0 = counts()
        seen["want"] = reference(b, quantize)
        for k, v in counts().items():
            ref_launches[k] = ref_launches.get(k, 0) + v - c0.get(k, 0)
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, errors, loss = fn(params, opt, errors, b)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
    d = digest(params)
    hi, lo = d.clone(), d.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    same.append(bool(torch.equal(hi, lo)))
    # each rank's error buffer against rank 0's one-process run of it;
    # rank 1's comes over a leaf at a time
    worst, bit = 0.0, True
    wants = [leaves(e) for e in ref_err] if rank == 0 else None
    for j, e in enumerate(leaves(errors)):
        got = e if rank == 1 else torch.empty_like(e)
        dist.broadcast(got, src=1)
        if rank == 0:
            for x, want in ((e, wants[0][j]), (got, wants[1][j])):
                worst = max(worst, rel_err([x], [want]))
                bit = bit and torch.equal(x, want)
        del got
    if rank == 0:
        seen["err_rel"].append(worst)
        seen["bitwise"][-1] = seen["bitwise"][-1] and bit
        del wants
launches = {k: v - ref_launches.get(k, 0) for k, v in counts().items()}
nonzero = sum(int((e != 0).sum()) for e in leaves(errors))
L = len(leaves(params))
out = {"rank": rank, "params": n, "leaves": L, "step_ms": ms,
       "losses": losses, "same_params": same,
       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
       "error_nonzero": nonzero, "launches": launches,
       "exchange_bytes": {"int8": 4 * n + 4 * L + 4, "dense_f32": 4 * n + 4}}
if rank == 0:
    out["vs_one_process"] = {"grad_rel": seen["grad_rel"],
                             "err_rel": seen["err_rel"],
                             "bitwise": seen["bitwise"]}
print("DP_OK " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pair(prog, what, env, timeout=600):
    """Run ``prog`` as ranks 0 and 1 of a gloo group → each rank's JSON
    result line (after ``tag``)."""
    init = f"tcp://localhost:{_free_port()}"
    procs = [_spawn(prog, [], dict(env, RANK=str(r), INIT=init))
             for r in range(2)]
    outs = _finish(procs, what, timeout=timeout)
    tag = what.split(":")[0] + " "
    return [json.loads(next(x for x in o.splitlines()
                            if x.startswith(tag))[len(tag):]) for o in outs]


def phase_data_parallel() -> dict:
    """recurrentgemma-2b at its published widths, depth 26 → 3, as two
    processes sharing the card in a gloo group: three steps with the int8
    exchange and one with the dense mean, each from the 4-row global
    batch, 2 rows a rank."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    # two ranks of about 25 GiB each share the card: segments that grow
    # keep their freed blocks from fragmenting it
    res = _pair(_DP_PROG, "DP_OK: data parallel",
                {"B": str(DP_B), "FRAC": str(DP_FRAC), "TOL": str(DP_TOL),
                 "LAYERS": str(DP_LAYERS),
                 "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    r0 = res[0]
    for r in res:
        check(all(r["same_params"]), f"data parallel: rank {r['rank']}'s "
              f"parameters differ from the other's after steps "
              f"{r['same_params']}")
        check(r["error_nonzero"] > 0, f"data parallel: rank {r['rank']}'s "
              "error buffers are all zero")
    check(res[0]["losses"] == res[1]["losses"],
          f"data parallel: the ranks' mean losses differ {res}")
    vs = r0["vs_one_process"]
    check(len(vs["grad_rel"]) == len(vs["err_rel"]) == len(r0["step_ms"])
          and max(vs["grad_rel"] + vs["err_rel"]) <= DP_TOL,
          f"data parallel: the reduced gradients and error buffers against "
          f"the one-process run of each step: {vs} > {DP_TOL}")
    launches = {k: res[0]["launches"][k] + res[1]["launches"][k]
                for k in res[0]["launches"]}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the data-parallel path was never launched: "
          f"{launches}")
    ex = r0["exchange_bytes"]
    print(f"data parallel: recurrentgemma-2b {DP_LAYERS} layers, "
          f"{r0['params']} parameters ({r0['leaves']} leaves), 2 ranks "
          f"in a gloo group on one card, {DP_B} rows x 1024 a rank, frac "
          f"{DP_FRAC}: step_ms (3 int8, 1 dense) {json.dumps([[round(x, 1) for x in r['step_ms']] for r in res])}"
          f"; losses {json.dumps(r0['losses'])}; parameters bit-identical "
          f"on both ranks after every step (digest); error buffers "
          f"non-zero {[r['error_nonzero'] for r in res]}")
    print(f"data parallel: every step against a one-process run of it "
          f"from both ranks' rows (max |Δ| / max |want| a leaf, bound "
          f"{DP_TOL}): the reduced gradient before clipping "
          f"{vs['grad_rel']}, both ranks' error buffers {vs['err_rel']}, "
          f"bitwise {vs['bitwise']}; peak device memory "
          f"a rank {json.dumps([round(r['peak_gib'], 2) for r in res])} GiB "
          f"(this process held {held / 2 ** 30:.2f} GiB);"
          f" exchange a step {ex['int8']} B (int32 sums of int8 values, a "
          f"scale a leaf, the loss) against a dense f32 all-reduce's "
          f"{ex['dense_f32']} B; launches {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------------------------
# phase 13: GPipe, two processes on the card
# ----------------------------------------------------------------------------

PP_LAYERS, PP_M, PP_T = 4, 4, 1024     # 2 stages x 2 blocks, microbatches
# outputs bit for bit the blocks run one after the other (the same kernels
# on the same inputs); gradients within PP_TOL of each leaf's largest
# |gradient| (the microbatches' parameter gradients add up in the order
# the cotangents arrive)
PP_TOL = 1e-5

_PP_PROG = r"""
import dataclasses, json, os, time
import torch
import torch.distributed as dist
rank, S = int(os.environ["RANK"]), 2
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=S)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch import _tree, get_config
from repro_torch.distributed import pipeline
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models import init_params
from repro_torch.models import model
dev = "cuda"
L, M, T = (int(os.environ[k]) for k in ("LAYERS", "M", "T"))
TOL = float(os.environ["TOL"])
cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=L)
seg = init_params(cfg, torch.Generator(device=dev).manual_seed(2029))[
    "segments"]["seg0"]["u0"]
named, treedef = _tree.flatten_with_names(seg)
per = L // S
mine = _tree.unflatten(treedef, [
    t[rank * per:(rank + 1) * per].detach().clone().requires_grad_(True)
    for _, t in named])
g = torch.Generator(device=dev).manual_seed(2030)
x = torch.randn(M, 1, T, cfg.d_model, generator=g, device=dev).to(
    torch.bfloat16).requires_grad_(True)
w = torch.randn(M, 1, T, cfg.d_model, generator=g, device=dev)
kind = model.layer_kinds(cfg)[0]
pos = torch.arange(T, dtype=torch.int32, device=dev).expand(1, T)

def block_fn(p, v):
    for layer in model._unstack(p):
        v = model.apply_block_train(cfg, kind, layer, v, pos)[0]
    return v

def run(fn):
    torch.cuda.synchronize()
    dist.barrier()                  # both stages start the clock together
    t0 = time.perf_counter()
    out = fn()
    (out.float() * w).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), time.perf_counter() - t0

# a first pass warms the kernels and the matmuls: untimed, uncounted
run(lambda: pipeline.gpipe_apply(None, block_fn, mine, x, M))
for p in _tree.leaves(mine) + [x]:
    p.grad = None
FK.reset_launches()
out, pipe_s = run(lambda: pipeline.gpipe_apply(None, block_fn, mine, x, M))
launches = dict(FK.LAUNCHES)
gx = x.grad.clone() if rank == 0 else None
x.grad = None
full = _tree.unflatten(treedef, [t.detach().clone().requires_grad_(True)
                                 for _, t in named])
ref, seq_s = run(lambda: torch.stack([block_fn(full, x[m])
                                      for m in range(M)]))

def rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))

g_rel = max(rel(p.grad, f.grad[rank * per:(rank + 1) * per])
            for p, f in zip(_tree.leaves(mine), _tree.leaves(full)))
res = {"rank": rank, "out_bitwise": bool(torch.equal(out, ref)),
       "grad_rel": g_rel, "pipe_s": pipe_s, "seq_s": seq_s,
       "ticks": M + S - 1, "bubble": pipeline.bubble_fraction(S, M),
       "launches": launches}
if rank == 0:
    res["x_grad_rel"] = rel(gx, x.grad)
print("PP_OK " + json.dumps(res), flush=True)
dist.destroy_process_group()
"""


def phase_pipeline() -> dict:
    """phi4-mini-3.8b's decoder blocks at full width, 2 stages x 2 blocks,
    M = 4 microbatches of (1, 1024, 3072) bf16, as two processes sharing
    the card: outputs on both ranks and every stage's gradients and x's
    against the four blocks run one after the other in one process."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    res = _pair(_PP_PROG, "PP_OK: pipeline",
                {"LAYERS": str(PP_LAYERS), "M": str(PP_M),
                 "T": str(PP_T), "TOL": str(PP_TOL)})
    for r in res:
        check(r["out_bitwise"], f"pipeline: rank {r['rank']}'s outputs are "
              "not the sequential run's")
        check(r["grad_rel"] <= PP_TOL, f"pipeline: stage {r['rank']}'s "
              f"gradients {r['grad_rel']} > {PP_TOL} of the sequential "
              "run's")
    check(res[0]["x_grad_rel"] <= PP_TOL,
          f"pipeline: x's gradient {res[0]['x_grad_rel']} > {PP_TOL}")
    launches = {k: res[0]["launches"][k] + res[1]["launches"][k]
                for k in res[0]["launches"]}
    check(launches["flash_attention"] == PP_LAYERS * PP_M
          and launches["flash_attention_backward"] == PP_LAYERS * PP_M,
          f"pipeline: K6 launches {launches}, not {PP_LAYERS * PP_M} each "
          "way")
    print(f"pipeline: phi4-mini-3.8b blocks, 2 stages x "
          f"{PP_LAYERS // 2} on 2 processes (gloo, one card), M={PP_M} "
          f"microbatches of (1, {PP_T}, 3072) bf16: ticks "
          f"{res[0]['ticks']}, bubble fraction {res[0]['bubble']:.4f}; "
          f"forward + backward wall (after a warm pass) "
          f"{json.dumps([round(r['pipe_s'], 4) for r in res])}"
          f" s (the blocks one after the other in one process "
          f"{json.dumps([round(r['seq_s'], 4) for r in res])} s); outputs "
          f"bit-identical to the sequential run's on both ranks; gradient "
          f"max |Δ| / max |g| per stage "
          f"{json.dumps([r['grad_rel'] for r in res])}, x "
          f"{res[0]['x_grad_rel']} (bound {PP_TOL}); launches "
          f"{json.dumps(launches)}; phase {time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------------------------
# phase 14: the launch tooling (build cache, dry run against the real run)
# ----------------------------------------------------------------------------

_CACHE_PROG = r"""
import json
from repro_torch.kernels.mask_pack import kernel as K
K.load_library()
print("cache " + json.dumps({k: K.LIBRARY.info[k] for k in
                             ("so", "built", "seconds")}))
"""
# the cells of phases 6 and 7, as ShapeCells of their own
DRY_CELLS = (("phi4-mini-3.8b", {}, "prefill", SERVE_B, SERVE_T, 2027),
             ("recurrentgemma-2b", {"n_layers": TRAIN_LAYERS, "remat": False},
              "train", TRAIN_B, TRAIN_T, 2028))
DRY_REPS = 3


def _cache_run(env, what):
    out = _finish([_spawn(_CACHE_PROG, [], env)], what, timeout=300)[0]
    line = next(x for x in out.splitlines() if x.startswith("cache "))
    return json.loads(line[len("cache "):])


def phase_cache(root: str) -> None:
    """(a) mask_pack.cu cold into a fresh ``REPRO_COMPILE_CACHE``, warm from
    it, and with the cache off, each in a process of its own."""
    fresh = os.path.join(root, "cache")
    with ThreadPoolExecutor(max_workers=2) as pool:
        cold = pool.submit(_cache_run, {"REPRO_COMPILE_CACHE": fresh},
                           "cache: cold")
        off = pool.submit(_cache_run, {"REPRO_COMPILE_CACHE": "0"},
                          "cache: off")
        cold, off = cold.result(), off.result()
    warm = _cache_run({"REPRO_COMPILE_CACHE": fresh}, "cache: warm")
    check(cold["built"] and os.path.dirname(cold["so"]) == fresh,
          f"cache: cold load {cold}")
    check(not warm["built"] and warm["so"] == cold["so"],
          f"cache: warm load {warm}")
    check(off["built"] and os.path.dirname(off["so"]) != fresh,
          f"cache: off {off}")
    print(f"cache: mask_pack.cu cold build {cold['seconds']:.3f} s, warm "
          f"load {warm['seconds'] * 1e3:.3f} ms, REPRO_COMPILE_CACHE=0 "
          f"built again in {off['seconds']:.3f} s")


def _accounted(fn):
    from repro_torch.launch.graph_analysis import Accountant
    with Accountant() as acct:
        fn()
    torch.cuda.synchronize()
    return acct.result()


def _dry_real(cfg, kind, B, T, seed):
    """The real step of a dense cell → (thunk, what to free)."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.specs import optimizer_kind
    from repro_torch.models import init_params, prefill
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    if kind == "prefill":
        params = init_params(cfg, gen)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                         device=DEV, dtype=torch.int32)}

        def run():
            with torch.no_grad():
                prefill(cfg, params, batch, T)
        return run, params
    oc = OptConfig(kind=optimizer_kind(cfg))
    state = launch.build_state(cfg, oc, B, T, seed=seed, device=DEV)
    batch = {k: torch.randint(0, cfg.vocab, (B, T), generator=gen,
                              device=DEV, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, oc)
    return (lambda: step(state["params"], state["opt"], batch)), state


def phase_launch_tooling(root: str) -> dict:
    """Phase 14 → launches.  (a) the build cache; (b) the dry run's
    accounting over fake tensors on the card against the same accountant
    over the real step, for phases 6 and 7's cells: FLOPs equal exactly;
    the real step timed without the accountant against ``model_flops`` and
    the roofline's bound; (c) olmoe at phase 9's shape, the balanced
    routing's count against the real routing's; (d) a production cell's
    dry run end to end."""
    from repro_torch import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PEAK_FLOPS
    from repro_torch.launch.roofline import Roofline, model_flops
    from repro_torch.launch.specs import ShapeCell

    t_phase = time.perf_counter()
    phase_cache(root)
    K.reset_launches()
    FK.reset_launches()
    LK.reset_launches()
    # ---- the launch-tooling path: counts from 0 here, read at the end -----
    for arch, changes, kind, B, T, seed in DRY_CELLS:
        cfg = dataclasses.replace(get_config(arch), **changes)
        cell = ShapeCell(f"{arch}:{kind}", kind, T, B)
        fake = dryrun.fake_account(cfg, cell, device=DEV)
        torch.cuda.empty_cache()
        run, held = _dry_real(cfg, kind, B, T, seed)
        real = _accounted(run)
        check(real["flops"] == fake["accounting"]["flops"]
              and real["flops_by_op"] == fake["accounting"]["flops_by_op"],
              f"dry run: {arch} {kind} FLOPs fake "
              f"{fake['accounting']['flops_by_op']} != real "
              f"{real['flops_by_op']}")
        ts = []
        for _ in range(DRY_REPS + 1):
            ts.append(synced(run)[1])
        t = float(np.median(ts[1:]))
        mf = model_flops(cfg, cell)
        rl = Roofline(arch=arch, shape=kind, mesh="1 card", chips=1,
                      hlo_flops=float(real["flops"]),
                      hlo_bytes=float(real["hbm_bytes"]), coll_bytes={},
                      model_flops=mf)
        bound = max(rl.t_compute, rl.t_memory)
        print(f"dry run: {arch} {kind} B={B} T={T} ({cfg.n_layers} layers): "
              f"aten FLOPs {real['flops']} fake == real "
              f"({json.dumps(real['flops_by_op'])}), fake run "
              f"{fake['seconds']:.2f} s; bytes fake "
              f"{fake['accounting']['hbm_bytes']} real {real['hbm_bytes']}; "
              f"model_flops {mf:.4e}; useful {rl.useful_fraction:.4f}; "
              f"bound {bound * 1e3:.3f} ms ({rl.dominant}); measured "
              f"{t * 1e3:.3f} ms (median of {DRY_REPS}); measured fraction "
              f"model_flops/(t*PEAK) {mf / (t * PEAK_FLOPS):.4f}")
        del run, held
        torch.cuda.empty_cache()

    # (c) the balanced MoE estimate against the real routing's count
    arch = FAMILIES[0][0]
    cfg = get_config(arch)
    cell = ShapeCell(f"{arch}:prefill", "prefill", FAM_T, FAM_B)
    fake = dryrun.fake_account(cfg, cell, device=DEV)
    run, held = _dry_real(cfg, "prefill", FAM_B, FAM_T, 2029)
    real = _accounted(run)
    ratio = fake["accounting"]["flops"] / real["flops"]
    print(f"dry run: {arch} prefill B={FAM_B} T={FAM_T}: balanced routing "
          f"{fake['accounting']['flops']} FLOPs against the real routing's "
          f"{real['flops']} (ratio {ratio:.6f}); {fake['moe_load']}")
    check(real["flops"] > 0 and fake["accounting"]["flops"] > 0,
          f"dry run: {arch} counted no FLOPs")
    del run, held
    torch.cuda.empty_cache()
    launches = dict(K.LAUNCHES, **FK.LAUNCHES, **LK.LAUNCHES)
    # ---- end of the launch-tooling path ----------------------------------
    ran = ("flash_attention", "flash_attention_backward", "lru_scan",
           "lru_scan_backward")
    check(all(launches[k] > 0 for k in ran),
          f"dry run: the real steps launched {launches}")

    # (d) a production cell end to end
    res = dryrun.lower_cell("xlstm-125m", "train_4k", verbose=False)
    check(res["status"] == "ok" and res["flops"] > 0,
          f"dry run: xlstm-125m train_4k {res}")
    print(f"dry run: xlstm-125m train_4k pod16x16: {res['trace_s']} s, "
          f"{res['n_nodes']} ops, FLOPs {res['flops']:.4e}, bytes "
          f"{res['bytes']:.4e}, dominant {res['dominant']}, t_compute "
          f"{res['t_compute_ms']:.3f} ms, t_memory {res['t_memory_ms']:.3f} "
          f"ms, t_collective {res['t_collective_ms']:.3f} ms")
    print(f"dry run: launches {json.dumps(launches)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------------------
# phase 5: every kernel timed at the main path's shapes
# ----------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
REPS = 10
SOURCE = "src/repro_torch/csrc/mask_pack.cu"
REPLACES = {
    "threshold_bitpack": "src/repro/kernels/mask_pack/kernel.py:217",
    "pack": "src/repro/kernels/mask_pack/kernel.py:83",
    "delta_flags": "src/repro/kernels/mask_pack/kernel.py:247",
    "mask_scatter": "src/repro/kernels/mask_pack/kernel.py:161",
    "unpack": "src/repro/kernels/mask_pack/kernel.py:114",
    "regions_words": "none",
}


def median_ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def batched_ms(fn, k: int = 20) -> float:
    """Median over REPS samples of the mean time of ``k`` calls issued back
    to back.  After the first call the host issues the next while the card
    runs this one, so a call that keeps the card busier than the host is
    timed by the card alone; :func:`median_ms` times one call started on an
    idle card, the host's issue time included."""
    fn()
    times = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    return float(np.median(times))


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    check(same_bytes(x, y), "kernel and plain version differ")
    if x.numel() == 0:
        return 0.0
    return float((x.double() - y.double()).abs().max())


PEAK_BF16_FLOP_S = 989e12   # H100 SXM data sheet, dense
PEAK_F32_FLOP_S = 67e12     # outside the tensor cores


def sdpa_call(q, k, v, causal=True):
    """The library yardstick for K6 (timed here, never called by the
    port): PyTorch's fused attention on (B, H, T, D) transposes, made
    outside the timed region; K/V are repeated to H heads there where
    this torch has no ``enable_gqa``."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt[:, :, :2], kt[:, :, :2],
                                       vt[:, :, :2], is_causal=causal,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    except TypeError:
        g = q.shape[2] // k.shape[2]
        kr, vr = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        return lambda: F.scaled_dot_product_attention(qt, kr, vr,
                                                      is_causal=causal)


def phase_timing(main, fa_in, k5_inputs, fam_k6) -> list:
    """K1–K6 timed at the main path's and the prefill's shapes, K5 also on
    the NPB restart's groups (one a program) and, beside them, leaf by
    leaf, K6 also at phase 9's four shapes, K8 at a cache leaf of the
    restore cell and on a fragmented table; main() fills in each row's
    launches."""
    state, sel_w, rep = main["state"], main["sel_w"], main["rep"]
    w = state["w"]
    n = w.numel()
    mag = rep["w"].magnitude_dev
    total = int(rep["w"].critical)
    rows = []

    def row(name, k_fn, p_fn, lib_fn, nbytes):
        k_out, p_out = k_fn(), p_fn()
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": max_abs_err(k_out, p_out),
            "ms": median_ms(k_fn), "plain_ms": median_ms(p_fn),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None if lib_fn is None else median_ms(lib_fn)})
        del k_out, p_out
        torch.cuda.empty_cache()

    # K1: the f32 accumulator of w → words + per-1024 counts
    row("threshold_bitpack",
        lambda: torch.cat([x.view(torch.uint8) for x in
                           ops.threshold_bitpack(mag, 0.0)]),
        lambda: torch.cat([x.view(torch.uint8) for x in
                           ref.bitpack_ref(mag, 0.0)]),
        None, 4 * n + n // 8 + 4 * (n // 1024))
    # K1 on an f64 leaf of the same bytes (the NPB accumulators are f64)
    mag64 = mag[: n // 2].double()
    n64 = mag64.numel()
    w64, w64_r = ops.threshold_bitpack(mag64, 0.0), ref.bitpack_ref(mag64, 0.0)
    check(all(same_bytes(x, y) for x, y in zip(w64, w64_r)),
          "K1 f64 leaf differs from bitpack_ref")
    b64 = 8 * n64 + n64 // 8 + 4 * (n64 // 1024)
    print(f"time threshold_bitpack f64: {n64} elements, kernel "
          f"{median_ms(lambda: ops.threshold_bitpack(mag64, 0.0)):.4f} ms "
          f"(batched "
          f"{batched_ms(lambda: ops.threshold_bitpack(mag64, 0.0)):.4f}), "
          f"bound {b64 / HBM_BYTES_PER_S * 1e3:.4f} ms, plain "
          f"{median_ms(lambda: ref.bitpack_ref(mag64, 0.0)):.4f} ms")
    print(f"time threshold_bitpack f32: batched "
          f"{batched_ms(lambda: ops.threshold_bitpack(mag, 0.0)):.4f} ms")
    del mag64, w64, w64_r
    torch.cuda.empty_cache()
    # K2 and K4 read the report's resident words (1 bit per element); the
    # byte mask sel_w, expanded already, is the old yardstick's input.
    words_w = rep["w"].device_words()
    expand = ops.expand_mask_bits

    def bounds(name, words_bytes, rest, library_words):
        """Print the bound from words beside the byte-mask bound of PR 14's
        design (N mask bytes) and the library route from words; return
        the bytes of the bound from words."""
        new, old = words_bytes + rest, n + rest
        lib_words = median_ms(library_words)
        print(f"{name} bound from words: {new} B = "
              f"{new / HBM_BYTES_PER_S * 1e3:.4f} ms; from a byte mask "
              f"{old} B = {old / HBM_BYTES_PER_S * 1e3:.4f} ms; library "
              f"from words (expand_mask_bits + the call) {lib_words:.4f} ms")
        return new

    # K2: the dense payload of w (as pack_group emits it), both counts
    # included.  A value is read only where its bit is set, so the bound
    # counts the 32-byte sectors of w that hold a critical element.
    sectors = int(sel_w.view(-1, 32 // w.element_size()).any(1).sum())
    print(f"K2 bound: {sectors} of {n * w.element_size() // 32} sectors "
          f"of w hold a critical element")
    k2_bytes = bounds("K2", n // 8, 32 * sectors + 4 * total + 4 * (n // 512),
                      lambda: torch.masked_select(w, expand(words_w, n=n)))
    row("pack", lambda: ops.pack_group([w], [words_w], [total])[0],
        lambda: ref.pack_payload_ref(w, expand(words_w, n=n), total)[0],
        lambda: torch.masked_select(w, sel_w), k2_bytes)
    # K3: w's payload against a base that differs in its first 1 MiB
    curr = torch.masked_select(w, sel_w)
    base = curr.clone()
    base[: MUTATED // 4] += 1.0
    c8, b8 = ops.as_bytes(curr), ops.as_bytes(base)
    nbytes8 = c8.numel()
    full8 = nbytes8 // 2048 * 2048
    row("delta_flags",
        lambda: K.delta_flags(c8, b8, ops.DELTA_CHUNK_BYTES),
        lambda: ref.delta_flags_ref(c8, b8, ops.DELTA_CHUNK_BYTES),
        lambda: (c8[:full8].view(-1, 2048) != b8[:full8].view(-1, 2048))
        .any(1),
        2 * nbytes8 + -(-nbytes8 // 2048))
    # K4: the restore expand of w's payload, its count pass included
    k4_bytes = bounds("K4", n // 8, 4 * total + 4 * n,
                      lambda: torch.zeros(n, device=DEV).masked_scatter_(
                          expand(words_w, n=n), curr))
    row("mask_scatter",
        lambda: ops.mask_scatter(curr, words_w, n=n, fill=0.0),
        lambda: ref.mask_scatter_ref(curr, expand(words_w, n=n), 0.0),
        lambda: torch.zeros(n, device=DEV).masked_scatter_(sel_w, curr),
        k4_bytes)
    del curr, base, c8, b8
    torch.cuda.empty_cache()
    # K5: w back from its tiled pack (K2's tiled form), from the report's
    # words.  It reads the words and each tile's critical prefix and
    # writes every element.
    packed, _ = ops.pack(w, words_w)
    k5_bytes = n // 8 + 4 * total + 4 * n
    print(f"K5 bound from words: {n // 8} + critical prefixes {4 * total} + "
          f"output {4 * n} = {k5_bytes} B = "
          f"{k5_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; from a byte mask "
          f"{n + 4 * total + 4 * n} B = "
          f"{(n + 4 * total + 4 * n) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    row("unpack", lambda: ops.unpack(packed, words_w, n=n, fill=0.0),
        lambda: ref.unpack_blocks_ref(packed, sel_w, 0.0), None, k5_bytes)
    print(f"time unpack 2^29 f32: batched "
          f"{batched_ms(lambda: ops.unpack(packed, words_w, n=n)):.4f} ms")
    del packed
    torch.cuda.empty_cache()
    # K5 at the NPB restart's leaves (phase 8): one group a program, as the
    # restart launches it; beside it each leaf by its own call (a launch a
    # leaf, the split before the group)
    k5 = dict.fromkeys(("ms", "batched", "per_leaf", "bound", "bound_mask",
                        "plain"), 0.0)
    per_program = []
    for name, leaves, packs, words, ns in k5_inputs:
        masks = [ops.expand_mask_bits(wd, n=nl) for wd, nl in zip(words, ns)]
        got = ops.unpack_group(packs, words, ns)
        for leaf, p, m, o in zip(leaves, packs, masks, got):
            check(same_bytes(o, ref.unpack_blocks_ref(p, m, 0.0)),
                  f"K5 at {name}({leaf}) differs from its plain version")
        t = median_ms(lambda: ops.unpack_group(packs, words, ns))
        k5["ms"] += t
        k5["batched"] += batched_ms(lambda: ops.unpack_group(packs, words,
                                                             ns))
        k5["plain"] += median_ms(lambda: [
            ref.unpack_blocks_ref(p, m, 0.0) for p, m in zip(packs, masks)])
        split = []
        for leaf, p, wd, nl in zip(leaves, packs, words, ns):
            tl = median_ms(lambda: ops.unpack(p, wd, n=nl))
            k5["per_leaf"] += tl
            split.append([leaf, nl, str(p.dtype).replace("torch.", ""),
                          round(tl, 4)])
        for p, m, nl in zip(packs, masks, ns):
            crit, width = int(m.sum()), p.element_size()
            k5["bound"] += (-(-nl // 8) + width * (crit + nl)) \
                / HBM_BYTES_PER_S * 1e3
            k5["bound_mask"] += (nl + width * (crit + nl)) \
                / HBM_BYTES_PER_S * 1e3
        per_program.append([name, round(t, 4), split])
    print(f"time unpack at the NPB restart: {len(k5_inputs)} groups (one "
          f"launch a program) {k5['ms']:.4f} ms in all (batched "
          f"{k5['batched']:.4f}); the {sum(len(x[1]) for x in k5_inputs)} "
          f"leaves by one call each {k5['per_leaf']:.4f} ms in all; bound "
          f"from words {k5['bound']:.4f} ms (from a byte mask "
          f"{k5['bound_mask']:.4f}), plain {k5['plain']:.4f} ms; per program "
          f"(ms, per leaf: n, dtype, ms alone) {json.dumps(per_program)}")
    # K8: the words of a cache leaf of the restore cell, (32, 4, 2048, 8,
    # 128) bf16, from its region table: one run a (layer, batch) row over
    # its first 1038 of 2048 slots.  It writes the words and reads the
    # table, 16 B a run.
    n8, rows8 = 32 * 4 * 2048 * 8 * 128, 32 * 4
    starts = torch.arange(rows8, device=DEV, dtype=torch.int64) \
        * (n8 // rows8)
    table = torch.stack([starts, starts + 1038 * 8 * 128], 1).contiguous()
    dense = torch.zeros(n8, dtype=torch.bool, device=DEV)
    for a, b in table.tolist():
        dense[a:b] = True
    check(same_bytes(ops.regions_words(table, n=n8),
                     ops.mask_to_words(dense)),
          "K8 at the restore cell's leaf differs from its mask's words")
    del dense
    row("regions_words", lambda: ops.regions_words(table, n=n8),
        lambda: ref.regions_words_ref(table, n8), None,
        -(-n8 // 8) + 16 * rows8)
    print(f"time regions_words: batched "
          f"{batched_ms(lambda: ops.regions_words(table, n=n8)):.4f} ms")
    # ... and on a fragmented table of the same leaf: about a million
    # runs of random lengths
    gen8 = torch.Generator(device=DEV)
    gen8.manual_seed(8)
    cuts = torch.unique(torch.randint(0, n8, (2_000_000,), generator=gen8,
                                      device=DEV))
    frag = cuts[: cuts.numel() // 2 * 2].view(-1, 2).contiguous()
    check(same_bytes(ops.regions_words(frag, n=n8),
                     ref.regions_words_ref(frag, n8)),
          "K8 on a fragmented table differs from its plain version")
    b8 = -(-n8 // 8) + 16 * frag.shape[0]
    print(f"time regions_words fragmented: {frag.shape[0]} runs over {n8} "
          f"elements, kernel "
          f"{median_ms(lambda: ops.regions_words(frag, n=n8)):.4f} ms "
          f"(batched "
          f"{batched_ms(lambda: ops.regions_words(frag, n=n8)):.4f}), bound "
          f"{b8 / HBM_BYTES_PER_S * 1e3:.4f} ms, plain "
          f"{median_ms(lambda: ref.regions_words_ref(frag, n8)):.4f} ms")
    del table, cuts, frag
    torch.cuda.empty_cache()
    # K6 at the serving prefill's shape, on layer 0's q/k/v of that run
    q, k, v, kw = fa_in["q"], fa_in["k"], fa_in["v"], fa_in["kw"]
    B, T, H, D = q.shape
    Kh, Dv = k.shape[2], v.shape[3]
    pairs = T * (T + 1) // 2 if kw["causal"] else T * T
    flops = 2 * B * H * pairs * (D + Dv)
    nbytes = (q.numel() + k.numel() + v.numel() + B * T * H * Dv) \
        * q.element_size()
    peak = PEAK_BF16_FLOP_S if q.dtype != torch.float32 else PEAK_F32_FLOP_S
    k6 = fa_ops.flash_attention(q, k, v, **kw)
    plain = flash_attention_ref(q, k, v, **kw)
    lib = sdpa_call(q, k, v)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": None,
        "max_abs_err": fa_err(k6, plain, fa_tol(q.dtype)),
        "ms": median_ms(lambda: fa_ops.flash_attention(q, k, v, **kw)),
        "plain_ms": median_ms(lambda: flash_attention_ref(q, k, v, **kw)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": median_ms(lib)})
    print(f"K6 bound: {flops} operations ({t_ops:.4f} ms), {nbytes} bytes "
          f"({t_bytes:.4f} ms) at B={B} T={T} H={H} K={Kh} D={D} "
          f"{str(q.dtype)} causal={kw['causal']}")
    for r in rows:
        rate = (f", {flops / r['ms'] / 1e9:.1f} TFLOP/s"
                if r["name"] == "flash_attention" else "")
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms{rate}, bound "
              f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}")
    del k6, plain, lib
    # K6 at phase 9's shapes, on each model's captured first-layer inputs
    for arch, q, k, v, kw in fam_k6:
        torch.cuda.empty_cache()
        flops = family_flops(q, k, v, kw["causal"])
        ms = median_ms(lambda: fa_ops.flash_attention(q, k, v, **kw))
        plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw))
        try:
            lib_ms = f"{median_ms(sdpa_call(q, k, v, kw['causal'])):.4f}"
        except RuntimeError as e:          # no SDPA backend for the shape
            lib_ms = f"none ({str(e).splitlines()[0][:80]})"
        print(f"time flash_attention {arch}: q {tuple(q.shape)} k "
              f"{tuple(k.shape)} v {tuple(v.shape)} {str(q.dtype)} causal="
              f"{kw['causal']}: kernel {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, bound "
              f"{flops / PEAK_BF16_FLOP_S * 1e3:.4f} ms ({flops:.4g} "
              f"operations), plain {plain_ms:.4f} ms, SDPA {lib_ms} ms")
    return rows


def _sdpa_backward_call(q, k, v, do):
    """The library yardstick for K6's backward (timed here, never called
    by the port): autograd's backward of PyTorch's fused attention, causal,
    on (B, H, T, D) transposes with ``enable_gqa``, the forward run once
    outside the timed region."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_timing_training(launches, per_step, inputs) -> list:
    """K7 forward and backward and K6's backward, timed on the inputs of
    phase 7's first launches.  The backward kernels take a unit-RMS
    cotangent there beside those inputs, in place of the loss's, whose
    values lie far below 1, and are held with :func:`scaled_err`."""
    rows = []
    gen = torch.Generator(device=DEV)
    gen.manual_seed(80)
    # the backward rows name the TPU kernel whose function they
    # differentiate: the reference has no backward kernel for either
    HOST = "src/repro/kernels/lru_scan/kernel.py:49"
    batched = {}     # K7: its time by batched_ms beside median_ms's

    def row(name, source, replaces, k_fn, p_fn, lib_fn, err, t_ops,
            t_bytes):
        if name.startswith("lru_scan"):
            batched[name] = batched_ms(k_fn)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": median_ms(k_fn),
            "plain_ms": median_ms(p_fn), "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None if lib_fn is None else median_ms(lib_fn)})

    # K7 forward: layer 0's a, b (f32 (B, T, R)); reads a, b, writes h
    a, b, h0 = inputs["lru_scan"]
    n = a.numel()
    h = LK.lru_scan(a, b, h0)
    err = fa_err(h, lru_scan_ref(a, b, h0), lru_tol(a.dtype), "K7 timed")
    row("lru_scan", "src/repro_torch/csrc/lru_scan.cu", HOST,
        lambda: LK.lru_scan(a, b, h0), lambda: lru_scan_ref(a, b, h0), None,
        err, 2 * n / PEAK_F32_FLOP_S * 1e3,
        3 * n * a.element_size() / HBM_BYTES_PER_S * 1e3)
    # K7 backward: reads a, h, dh, writes da, db
    a, b, h, h0, dh = inputs["lru_scan_backward"]
    dh = torch.randn(dh.shape, generator=gen, device=DEV).to(dh.dtype)
    live = [t.detach().clone().requires_grad_() for t in (a, b)]
    with torch.enable_grad():
        h_ref = lru_scan_ref(*live)
    got = LK.lru_scan_backward(a, h, h0, dh)
    want = torch.autograd.grad(h_ref, live, dh, retain_graph=True)
    err = max(scaled_err(g, w, lru_tol(a.dtype), "K7 backward timed")[0]
              for g, w in zip(got, want))
    row("lru_scan_backward", "src/repro_torch/csrc/lru_scan.cu", HOST,
        lambda: LK.lru_scan_backward(a, h, h0, dh),
        lambda: torch.autograd.grad(h_ref, live, dh, retain_graph=True),
        None, err, 3 * n / PEAK_F32_FLOP_S * 1e3,
        5 * n * a.element_size() / HBM_BYTES_PER_S * 1e3)
    del live, h_ref, got, want
    # K6 backward: the first attention layer's q, k, v, o, lse, do
    q, k, v, o, lse, do, kw = inputs["flash_attention_backward"]
    do = torch.randn(do.shape, generator=gen, device=DEV).to(do.dtype)
    B, T, H, D = q.shape
    Kh, Dv = k.shape[2], v.shape[3]
    qi = torch.arange(T, device=DEV)[:, None]
    ki = torch.arange(T, device=DEV)[None, :]
    ok = qi >= ki if kw["causal"] else torch.ones((T, T), dtype=torch.bool,
                                                  device=DEV)
    if kw["window"] is not None:
        ok &= qi - ki < kw["window"]
    pairs = int(ok.sum())
    flops = 2 * B * H * pairs * (3 * D + 2 * Dv)   # S, dP, dQ, dK, dV
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + do.numel()) \
        * q.element_size() + (o.numel() + lse.numel()) * 4
    peak = PEAK_BF16_FLOP_S if q.dtype != torch.float32 else PEAK_F32_FLOP_S
    got = FK.flash_attention_backward(q, k, v, o, lse, do, **kw)
    live = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o_ref = flash_attention_ref(*live, **kw)
    want = torch.autograd.grad(o_ref, live, do, retain_graph=True)
    err = max(scaled_err(g, w, fa_tol(q.dtype), "K6 backward timed")[0]
              for g, w in zip(got, want))
    check(kw["causal"] and (kw["window"] is None or kw["window"] >= T),
          "SDPA's causal mask must be the layer's mask")
    row("flash_attention_backward",
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:78",
        lambda: FK.flash_attention_backward(q, k, v, o, lse, do, **kw),
        lambda: torch.autograd.grad(o_ref, live, do, retain_graph=True),
        _sdpa_backward_call(q, k, v, do), err,
        flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3)
    print(f"K7 bound: {n} elements a tensor, forward {3 * n * 4} bytes, "
          f"backward {5 * n * 4} bytes at B={a.shape[0]} T={a.shape[1]} "
          f"R={a.shape[2]} {a.dtype}")
    print(f"K6 backward bound: {flops} operations ({pairs} pairs), {nbytes} "
          f"bytes at B={B} T={T} H={H} K={Kh} D={D} Dv={Dv} {q.dtype} "
          f"causal={kw['causal']} window={kw['window']}")
    for r in rows:
        rate = (f", {flops / r['ms'] / 1e9:.1f} TFLOP/s"
                if r["name"] == "flash_attention_backward" else "")
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms{rate}, bound "
              f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, launches {r['launches']} "
              f"({per_step[r['name']]} per train step)"
              + (f"; batched {batched[r['name']]:.4f} ms"
                 if r["name"] in batched else ""))
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    # full f32 in every f32 matmul and convolution of the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_card()
    phase_kernels()
    phase_bitpack_edges()
    phase_flash_attention()
    phase_lru_scan()
    phase_flash_attention_backward()
    phase_setup()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, main_state = phase_main_path(os.path.join(tmp, "main"))
        coord_launches = phase_coordinated(os.path.join(tmp, "coordinated"),
                                           main_state,
                                           os.path.join(tmp, "main"))
        phase_coordinated_processes(os.path.join(tmp, "processes"))
        phase_bench_bytes(os.path.join(tmp, "bench"))
        serve_launches, fa_in = phase_serving(os.path.join(tmp, "serve"))
        fam_launches, fam_k6 = phase_families(os.path.join(tmp, "families"))
        npb_launches, k5_inputs = phase_npb(os.path.join(tmp, "npb"))
        rows = phase_timing(main_state, fa_in, k5_inputs, fam_k6)
        del main_state, fa_in, k5_inputs, fam_k6
        (train_launches, per_step, train_in, train_mask,
         train_coord) = phase_training(os.path.join(tmp, "train"))
        sess_launches = phase_sessions(os.path.join(tmp, "sessions"))
    dp_launches = phase_data_parallel()
    pp_launches = phase_pipeline()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tool_launches = phase_launch_tooling(tmp)
    rows += phase_timing_training(train_launches, per_step, train_in)
    # every kernel's launches summed over the paths it runs on, each path
    # counted from 0 just before it and read just after
    paths = {"main": launches, "serving": serve_launches,
             "families": fam_launches, "npb": npb_launches,
             "training": dict(train_launches, **train_mask),
             "coordinated": {k: coord_launches.get(k, 0)
                             + train_coord.get(k, 0)
                             for k in set(coord_launches) | set(train_coord)},
             "sessions": sess_launches, "data_parallel": dp_launches,
             "pipeline": pp_launches, "launch_tooling": tool_launches}
    for r in rows:
        r["launches"] = sum(p.get(r["name"], 0) for p in paths.values())
    print(f"launches by path: {json.dumps(paths)}; in all "
          f"{json.dumps({r['name']: r['launches'] for r in rows})}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
