"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 `emulator_scan.refractory_scan`, K2 `emulator_scan.scan`, K3
`warp.bilinear_warp`, K4 `warp_tiled.warp_tiled`, K5
`conv3.conv3x3_lane` and K6 `upsample.upsample2x`.  Sources are in v2e_tpu_torch/csrc/; `build` compiles
them on first use."""
