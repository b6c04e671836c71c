"""Sanity check of the IIR lowpass at a sample rate (a copy of
v2e_tpu/utils/lowpass.py): warns when the update factor eps of the
photoreceptor filter is too large for the timestamp resolution."""
from __future__ import annotations

import logging
import math

logger = logging.getLogger(__name__)


def check_lowpass(cutoff_hz: float, sample_rate_hz: float) -> None:
    if cutoff_hz <= 0 or sample_rate_hz <= 0:
        return
    tau = 1.0 / (2 * math.pi * cutoff_hz)
    eps = (1.0 / sample_rate_hz) / tau
    if eps > 0.3:
        logger.warning(
            f"IIR lowpass cutoff_hz={cutoff_hz} is too high for signal update "
            f"rate {sample_rate_hz} Hz: eps={eps:.2f} > 0.3. Some pixels will "
            "lowpass incorrectly; use a smaller timestamp resolution or cutoff."
        )
    elif eps > 0.1:
        logger.info(
            f"IIR lowpass update eps={eps:.2f} is marginal at sample rate "
            f"{sample_rate_hz} Hz for cutoff_hz={cutoff_hz}"
        )
