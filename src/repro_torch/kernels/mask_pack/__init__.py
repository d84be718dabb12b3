"""Mask pack/scatter/delta/bitpack: CUDA kernels K1-K4 and their ops."""
