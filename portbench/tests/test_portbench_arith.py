"""The yardstick's FLOP and byte arithmetic against counts by hand."""

import pytest

from portbench.tests import tiny  # noqa: F401
from portbench.metrics import arith

DENSE = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
         "vocab_size": 10}
MOE = dict(DENSE, num_experts=4, num_experts_per_tok=2, intermediate_size=6)


def test_dense_decode_step_by_hand():
    # a layer: q 8x8, k 8x4, v 8x4, o 8x8, ffn 3 x 8x16 -> 2*(64+32+32+64+384)
    # = 1152 a row; two layers and the head (8x10): 2304 + 160 a row
    f = arith.decode_step_flops(DENSE, batch=3, pos=5)
    assert f["dense"] == 3 * (2 * 1152 + 160)
    # QK and PV: 2 heads x 2 products x 2 x 4 lanes x 6 slots, 2 layers
    assert f["attn"] == 3 * 2 * 2 * 2 * 2 * 4 * 6


def test_moe_decode_step_by_hand():
    # attention 2*(64+32+32+64) = 384, router 2*8*4 = 64,
    # two experts of 3 x 8x6: 2 * 3 * 2 * 48 = 576
    f = arith.decode_step_flops(MOE, batch=1, pos=0)
    assert f["dense"] == 2 * (384 + 64 + 576) + 160


def test_scrutiny_flops_by_hand():
    steps = [arith.decode_step_flops(DENSE, 2, p) for p in (7, 8)]
    fwd = sum(s["dense"] + s["attn"] for s in steps)
    bwd = sum(s["dense"] + 2 * s["attn"] for s in steps)
    assert arith.scrutiny_flops(DENSE, 2, 7, 2, 3) == 2 * fwd + 3 * bwd


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 4096])
def test_kernel_bytes_by_hand(n):
    tiles = -(-n // 1024)
    assert arith.bitpack_bytes(n) == 4 * n + -(-n // 8) + 4 * tiles
    assert arith.scatter_bytes(n, n // 2, 2) == n // 2 * 2 + -(-n // 8) + 2 * n
    assert arith.pack_bytes(n, n // 2, 2) == 2 * (n // 2 * 2) + -(-n // 8)
    assert arith.delta_bytes(n, 2048) == 2 * n + -(-n // 2048)


def test_roofline_share_takes_the_larger_bound():
    assert arith.roofline_share(3.35e12, 2.0) == pytest.approx(0.5)
    assert arith.roofline_share(0.0, 1.0, 989e12) == pytest.approx(1.0)
    assert arith.roofline_share(3.35e12, 1.0, 2 * 989e12) == \
        pytest.approx(2.0)


@pytest.mark.parametrize("full,name", [
    ("void (anonymous namespace)::scatter_kernel<unsigned short>(unsigned "
     "short const*, long long, unsigned char const*, long ", "scatter_kernel"),
    ("(anonymous namespace)::word_counts_kernel(unsigned char const*, long "
     "long, int*)", "word_counts_kernel"),
    ("void (anonymous namespace)::bitpack_kernel<float, true>(float const*)",
     "bitpack_kernel"),
    ("void delta_kernel(unsigned char const*, unsigned char const*)",
     "delta_kernel"),
    ("void at::native::elementwise_kernel<128, 2>(int)",
     "elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "HtoD"),
])
def test_kernel_names_from_the_profile(full, name):
    """Kernel names as the card's profile gives them."""
    from portbench.devtrace import kernel_name
    assert kernel_name(full) == name
