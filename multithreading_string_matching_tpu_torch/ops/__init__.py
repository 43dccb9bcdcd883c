"""The window and table matchers and the DFA scans: plain PyTorch
versions, staging plans and the hand-written CUDA kernels."""
