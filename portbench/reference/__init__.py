"""Plain PyTorch and numpy references the benchmark judges the port with.

Nothing here imports jax, v2e_tpu or v2e_tpu_torch; every module follows
the published equations (Super-SloMo, the v2e DVS pixel model) and takes
its inputs from the benchmark, never from the program.
"""
