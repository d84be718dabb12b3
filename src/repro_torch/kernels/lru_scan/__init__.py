"""The RG-LRU scan: CUDA kernel K7 (forward and backward) and its plain
version."""
