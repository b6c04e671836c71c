"""Photoreceptor-noise amplitude calibration (host-side scalar precompute).

Computes the Gaussian RMS voltage to inject into the log photoreceptor signal
(before the IIR lowpass) so that the observed noise-event rate matches a
desired shot-noise rate, following the Graca & Delbruck 2021 curve fit
(the original v2e's emulator_utils.py).  A numpy copy of
v2e_tpu/ops/noise.py: it runs once per sample rate on the host, a scalar
calibration rather than per-pixel work.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def _vn_from_log_rate_per_hz(thr: np.ndarray, x: float) -> np.ndarray:
    """Invert the Fig.3 fit of Graca&Delbruck 2021: given x = log10(Rn/f3db),
    the fit gives y = log10(thr/Vn); return the Vn achieving rate Rn."""
    y = -0.0026 * x**3 - 0.036 * x**2 - 0.1949 * x + 0.321
    thr_per_vn = 10.0**y
    return thr / thr_per_vn


@dataclass
class _Cache:
    sample_rate: Optional[float] = None
    vn: Optional[float] = None


_cache = _Cache()


def compute_photoreceptor_noise_voltage(
    shot_noise_rate_hz: float,
    f3db: float,
    sample_rate_hz: float,
    pos_thr: float,
    neg_thr: float,
    sigma_thr: float,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """White-noise RMS (ln units) to add before the photoreceptor lowpass.

    Two steps, matching the reference:
    1. Monte-Carlo average the fit-derived Vn over the Gaussian threshold
       mismatch (min of ON/OFF thresholds per sample).
    2. Scale up by the noise-equivalent-bandwidth factor of the actual IIR
       at this sample rate, estimated by filtering a long white sequence the
       same way the emulator will.
       Here the IIR output variance ratio is computed vectorized instead of
       a Python sample loop.

    Cached per sample rate (within 10%).
    """
    if _cache.sample_rate is not None:
        if abs(sample_rate_hz / _cache.sample_rate - 1.0) < 0.1:
            return float(_cache.vn)

    if rng is None:
        rng = np.random.default_rng()

    rate_per_bw = (shot_noise_rate_hz / f3db) / 2.0
    if rate_per_bw > 0.5:
        logger.warning(
            f"shot noise rate per Hz of bandwidth {rate_per_bw:.3g} is large "
            f"(rate_hz={shot_noise_rate_hz} Hz, 3dB bandwidth={f3db} Hz)"
        )
    x = math.log10(rate_per_bw)
    if x < -5.0:
        logger.warning(
            f"desired noise rate {shot_noise_rate_hz} Hz is too low to accurately "
            "compute a photoreceptor noise amplitude"
        )
    elif x > 0.0:
        logger.warning(
            f"desired noise rate {shot_noise_rate_hz} Hz is too large to accurately "
            "compute a photoreceptor noise amplitude"
        )

    # Monte-Carlo over threshold mismatch: each pixel's effective threshold is
    # the smaller of its ON/OFF thresholds.
    n_samples = 300
    pos_samps = pos_thr + sigma_thr * rng.standard_normal(n_samples)
    neg_samps = neg_thr + sigma_thr * rng.standard_normal(n_samples)
    mins = np.minimum(pos_samps, neg_samps)
    vn = float(np.mean(_vn_from_log_rate_per_hz(mins, x)))

    # Noise-equivalent-bandwidth correction: white noise of RMS vn, after the
    # first-order IIR y[i] = (1-eps) y[i-1] + eps x[i], has steady-state RMS
    # vn * sqrt(eps / (2 - eps)).  We still estimate it empirically over
    # 1000*tau like the reference (tolerant of short sequences), but with a
    # vectorized lfilter-style recursion.
    tau = 1.0 / (f3db * 2.0 * math.pi)
    dt = 1.0 / sample_rate_hz
    eps = dt / tau
    if eps > 0.1:
        logger.warning(
            f"eps={eps:.3f} for the IIR lowpass is >0.1; reduce the timestep "
            f"(currently {dt:.3g}s) or decrease cutoff_hz (currently {f3db:.3g} Hz). "
            "Expect the generated shot noise rate to be lower than desired."
        )
    n = max(int(1000.0 * tau / dt), 16)
    rin = vn * rng.standard_normal(n)
    rms_in = float(np.std(rin))
    # y[i] = (1-eps) y[i-1] + eps x[i], y[0]=0 — scipy-free vectorized IIR.
    a = 1.0 - eps
    rout = np.empty_like(rin)
    acc = 0.0
    # chunked recursion: exact sequential filter, but in C-speed numpy blocks
    block = 4096
    powers = a ** np.arange(1, block + 1)
    for start in range(0, n, block):
        xb = rin[start : start + block]
        nb = len(xb)
        # y[k] = a^{k+1} * acc + eps * sum_{j<=k} a^{k-j} x[j]
        conv = eps * np.convolve(xb, a ** np.arange(nb))[:nb]
        yb = powers[:nb] * acc + conv
        rout[start : start + nb] = yb
        acc = yb[-1]
    rms_out = float(np.std(rout))
    scale = rms_in / rms_out if rms_out > 0 else 1.0
    vnscaled = scale * vn

    _cache.sample_rate = sample_rate_hz
    _cache.vn = vnscaled
    logger.info(
        f"for desired shot_noise_rate_hz={shot_noise_rate_hz} Hz computed "
        f"photoreceptor_noise_rms={vn:.3f} ln units, scaled by {scale:.3f} to "
        f"{vnscaled:.3f} before the 1st-order lowpass (sample rate "
        f"{sample_rate_hz:.3g} Hz, cutoff {f3db} Hz)"
    )
    return vnscaled


def reset_photoreceptor_noise_cache() -> None:
    _cache.sample_rate = None
    _cache.vn = None
