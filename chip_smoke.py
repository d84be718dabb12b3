"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` and checks each
against its plain PyTorch version on the card, then drives the port's main
path (scrutinize → device-packed save → delta chain → device restore) at a
≈2.5 GiB state, checks the hardware-independent byte counts of the
reference bench state, and times every kernel.  Any failed check raises
and ends the run with a non-zero exit; the last line is the device JSON.
It needs one card and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.kernels.mask_pack import kernel as K  # noqa: E402
from repro_torch.kernels.mask_pack import ops, ref  # noqa: E402

DEV = "cuda"
DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
          torch.int32, torch.bool)
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
    return torch.randn(n, generator=gen, device=DEV).to(dtype)


def selector(n: int, frac: float, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=DEV) < frac


def poison(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """±inf and NaN at a few uncritical positions of a float tensor."""
    x = x.clone()
    idx = torch.nonzero(~mask).reshape(-1)[:3]
    for v, i in zip((float("inf"), float("-inf"), float("nan")), idx):
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
    K.load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({'compiled' if K.BUILD_INFO['built'] else 'cached'} "
          f"{os.path.basename(str(K.BUILD_INFO['so']))})")
    return line


# ----------------------------------------------------------------------------
# phase 2: every kernel against its plain version, bit for bit
# ----------------------------------------------------------------------------

def phase_kernels() -> int:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    cases = 0
    for n in SIZES:
        for frac in DENSITIES:
            sel = selector(n, frac, gen)
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
            for dt in DTYPES:
                x = values(n, dt, gen)
                xs = [x] + ([poison(x, sel)] if dt.is_floating_point else [])
                for v in xs:
                    # K2 tiled and dense forms
                    p, c = ops.pack(v, sel)
                    p_r, c_r = ref.pack_blocks_ref(v, sel)
                    check(same_bytes(p, p_r) and same_bytes(c, c_r),
                          f"K2 tiled {dt} n={n} frac={frac}")
                    total = int(c_r.sum())
                    pay, cg = ops.pack_group([v, v[: n // 2]],
                                             [sel, sel[: n // 2]],
                                             [total, int(sel[: n // 2].sum())])
                    pay_r = torch.cat([ref.pack_payload_ref(v, sel, total)[0],
                                       v[: n // 2][sel[: n // 2]]])
                    check(same_bytes(pay, pay_r),
                          f"K2 dense {dt} n={n} frac={frac}")
                    # K4 scatter back, fill 0 and a non-zero fill
                    for fill in (0, 1):
                        o = ops.mask_scatter(pay[:total], sel, n=n, fill=fill)
                        o_r = ref.mask_scatter_ref(pay[:total], sel, fill)
                        check(same_bytes(o, o_r),
                              f"K4 {dt} n={n} frac={frac} fill={fill}")
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
                    cases += 1
    torch.cuda.synchronize()
    print(f"kernels: {cases} cases bit-identical to the plain versions; "
          f"comparison launches {json.dumps(K.LAUNCHES)}")
    return cases


# ----------------------------------------------------------------------------
# phase 3: the main path at a real size
# ----------------------------------------------------------------------------

N_W, N_B, N_H = 1 << 29, 1 << 26, 1 << 27
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
        check(torch.equal(rep[name].device_mask(), sel),
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
    (step, r1), _ = synced(lambda: mgr.restore(like))
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
    (step, r), restore_s = synced(lambda: mgr.restore(like))
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
    launches = dict(K.LAUNCHES)
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
    print(f"main path: launches {json.dumps(launches)}")
    return launches, {"state": state, "sel_w": sel_w, "rep": rep}


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


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    check(same_bytes(x, y), "kernel and plain version differ")
    if x.numel() == 0:
        return 0.0
    return float((x.double() - y.double()).abs().max())


def phase_timing(launches, main) -> list:
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
            "replaces": REPLACES[name], "launches": launches[name],
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
    # K2: the dense payload of w (as pack_group emits it).  A value is read
    # only where its mask is set, so the bound counts the 32-byte sectors
    # of w that hold a critical element, not all of w.
    sectors = int(sel_w.view(-1, 32 // w.element_size()).any(1).sum())
    print(f"K2 bound: {sectors} of {n * w.element_size() // 32} sectors "
          f"of w hold a critical element")
    row("pack", lambda: ops.pack_group([w], [sel_w], [total])[0],
        lambda: ref.pack_payload_ref(w, sel_w, total)[0],
        lambda: torch.masked_select(w, sel_w),
        n + 32 * sectors + 4 * total + 4 * (n // 512))
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
    # K4: the restore expand of w's payload
    row("mask_scatter",
        lambda: ops.mask_scatter(curr, sel_w, n=n, fill=0.0),
        lambda: ref.mask_scatter_ref(curr, sel_w, 0.0),
        lambda: torch.zeros(n, device=DEV).masked_scatter_(sel_w, curr),
        4 * total + n + 4 * n)
    for r in rows:
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    t0 = time.perf_counter()
    card = phase_card()
    phase_kernels()
    phase_setup()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, main_state = phase_main_path(os.path.join(tmp, "main"))
        phase_bench_bytes(os.path.join(tmp, "bench"))
    rows = phase_timing(launches, main_state)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
