"""Segmented reductions; the hot two run as hand-written CUDA kernels."""
