"""Batched exact dynamic programming over generated layouts.

``tabular`` solves the (door-config, carrying, dir, y, x) domain,
``tabular_key`` the key-position domain; ``cuda_vi`` holds the hand-written
CUDA kernels for both, each beside its plain PyTorch version.
"""
