"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 `emulator_scan.refractory_scan` and K3 `warp.bilinear_warp`.
Sources are in v2e_tpu_torch/csrc/; `build` compiles them on first use."""
