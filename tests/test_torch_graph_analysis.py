"""The port's aten accounting (``repro_torch.launch.graph_analysis``) against
the reference's HLO accounting (``repro.launch.hlo_analysis``) on the same
functions: the reference lowers ``lax.scan`` loops and multiplies their
bodies by the trip count, the port traces the same loops unrolled with
``make_fx``; the FLOPs agree exactly.  Byte counts follow each package's
own rule (the reference's per fused kernel, the port's per unfused op),
so those cases pin the port's value and the reference's where it is
hardware-independent (a collective's result, a slice-like op)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.launch import hlo_analysis as H
from repro_torch.launch import graph_analysis as G
from repro_torch.launch import roofline
from test_hlo_analysis import COLL_HLO, F8_HLO

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _ref(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return H.analyze(jax.jit(f).lower(*args).compile().as_text())


def _port(f, *shapes, dtype=torch.float32):
    gm = make_fx(f, tracing_mode="fake")(
        *[torch.empty(s, dtype=dtype) for s in shapes])
    return G.analyze(gm)


def test_scanned_matmuls_flops_exact():
    def f_ref(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=10)[0]

    def f_port(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    want = 2.0 * 128 * 256 * 256 * 10
    ref = _ref(f_ref, (128, 256), (256, 256))
    port = _port(f_port, (128, 256), (256, 256))
    assert ref["flops"] == want and ref["n_whiles"] == 1
    assert port["flops"] == want
    assert port["flops_by_op"] == {"aten.mm": want}
    # 10 products and 10 tanh, nothing to multiply
    assert port["n_nodes"] == 20


def test_nested_scan_flops_exact():
    def g_ref(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=5)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    def g_port(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x

    want = 2.0 * 64 * 128 * 128 * 15
    assert _ref(g_ref, (64, 128), (128, 128))["flops"] == want
    assert _port(g_port, (64, 128), (128, 128))["flops"] == want


def test_stack_read_one_slice_at_a_time_not_multiplied():
    def f_ref(xs):
        def body(c, x):
            return c + x.sum(), None
        return jax.lax.scan(body, 0.0, xs)[0]

    def f_port(xs):
        c = torch.zeros(())
        for i in range(xs.shape[0]):
            c = c + xs[i].sum()
        return c

    full = 1024 * 128 * 4
    ref = _ref(f_ref, (1024, 128))
    port = _port(f_port, (1024, 128))
    assert ref["hbm_bytes"] < 20 * full
    assert port["hbm_bytes"] < 20 * full
    # each slice is a view (free) read once by its sum: the stack once,
    # plus the 4-byte scalars of the sums and adds
    assert port["hbm_bytes"] == full + 4 + 1024 * (4 + 12)


_ALL_REDUCE_PROG = r"""
import json, torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.fx.experimental.proxy_tensor import make_fx
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.graph_analysis import analyze
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
try:
    gm = make_fx(lambda x: funcol.all_reduce(x, "sum", dist.group.WORLD),
                 tracing_mode="fake")(torch.empty(1024))
    print(json.dumps(analyze(gm)))
finally:
    dist.destroy_process_group()
"""


def test_all_reduce_bytes():
    """An all-reduce of f32[1024] gives 4096 B in both; the port's runs in
    a process of its own, with a fake process group (another test file may
    hold a gloo group in this worker)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _ALL_REDUCE_PROG], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    port = json.loads(out.stdout.strip().splitlines()[-1])
    ref = H.analyze(COLL_HLO)
    assert ref["coll_bytes"]["all-reduce"] == 4096
    assert port["coll_bytes"] == {"all-reduce": 4096}
    assert roofline.collective_bytes(port) == {"all-reduce": 4096}


def test_f8_transpose_traffic():
    ref = H.analyze(F8_HLO)
    port = _port(lambda a: a.t().contiguous(), (64, 64),
                 dtype=torch.float8_e4m3fn)
    assert ref["hbm_bytes"] == 2 * 64 * 64
    assert port["hbm_bytes"] == 2 * 64 * 64


@pytest.mark.parametrize("window,causal,want", [
    (None, True, 4 * 2 * 1024 * 1024 * (64 + 32)),
    (None, False, 4 * 2 * 1024 * 1024 * (64 + 32) * 2),
    (100, True, 4 * 2 * 1024 * 100 * (64 + 32) * 2)])
def test_flash_attention_flop_formula(window, causal, want):
    """K6 forward (B=2, T=1024, H=4 over K=2 kv heads, D=64, Dv=32) counts
    QKᵀ and PV over the effective context (T/2 causal, the window, T);
    its backward 2·pairs·(3D + 2Dv), as the registry counts SDPA's; the
    same from ``FlopCounterMode`` and from the graph."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention.ops import flash_attention

    def f(q, k, v):
        return flash_attention(q, k, v, window=window, causal=causal)

    shapes = ((2, 1024, 4, 64), (2, 1024, 2, 64), (2, 1024, 2, 32))
    assert _port(f, *shapes)["flops"] == want
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q, k, v = (torch.empty(s, requires_grad=True) for s in shapes)
        with FlopCounterMode(display=False) as fc:
            f(q, k, v).sum().backward()
    assert fc.get_total_flops() == want + want // (64 + 32) * (3 * 64
                                                               + 2 * 32)


def test_accountant_repeat_and_views():
    """The dispatch-mode front door counts as ``analyze`` does; ``repeat``
    multiplies what runs inside it; views, allocations and ``.device``
    queries move nothing; the reshape of a transposed tensor copies (a
    slice-like clone: twice its result)."""
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    with G.Accountant() as acct:
        y = x @ w
        with acct.repeat(5):
            y.t().reshape(-1)
            torch.empty(100)
            _ = y.device
            z = torch.relu(y)
    got = acct.result()
    assert got["flops"] == 2 * 8 * 16 * 4
    # mm; then t, clone, _unsafe_view, empty, relu, five times
    assert got["n_nodes"] == 1 + 5 * 5
    mm = (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert got["hbm_bytes"] == mm + 5 * (2 * 32 * 4 + 2 * 32 * 4)
    assert z.shape == (8, 4)
