"""Sparse ops: windowed convolution, normalization, and the CUDA kernels
(``ops/kernels``)."""
