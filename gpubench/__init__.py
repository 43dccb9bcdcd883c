"""The benchmark of the PyTorch and CUDA port (see run.py)."""
