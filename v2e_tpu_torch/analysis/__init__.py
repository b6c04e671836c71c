"""Validation and calibration tooling of the port (port of
v2e_tpu/analysis/): threshold estimation."""

from v2e_tpu_torch.analysis.thres_estimator import estimate_thresholds

__all__ = ["estimate_thresholds"]
