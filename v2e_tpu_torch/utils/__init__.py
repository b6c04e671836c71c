"""Host-side helpers of the CLI: output folders, camera sizes, the lowpass
check and AVI writing (the port's own copies of v2e_tpu/utils)."""
