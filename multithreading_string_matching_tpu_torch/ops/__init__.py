"""The window matcher: plain PyTorch version, staging plans and the
hand-written CUDA kernels."""
