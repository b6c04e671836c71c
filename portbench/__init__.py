"""The benchmark of v2e_tpu_torch, the PyTorch and CUDA port (see bench.py)."""
