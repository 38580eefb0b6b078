"""Tensor ops of the port: resize, CoordConv channels and the CUDA
kernels."""
