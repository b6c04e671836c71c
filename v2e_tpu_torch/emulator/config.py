"""Static configuration of the DVS pixel model (port of
v2e_tpu/emulator/config.py).

The JAX package's `use_pallas_scan` switch has no counterpart: the
sequential core runs its kernel (K1, or K2 when the refractory period is
0) whenever its tensors are on a CUDA device and the kernel's plain version
when they are on the CPU.  The center-surround
(CSDVS) and SciDVS pixels are not ported yet and have no fields here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EmulatorConfig:
    """DVS model parameters."""

    # nominal log_e thresholds and their per-pixel Gaussian mismatch
    pos_thres: float = 0.2
    neg_thres: float = 0.2
    sigma_thres: float = 0.03

    # photoreceptor first-order IIR lowpass 3dB cutoff; <=0 disables
    cutoff_hz: float = 0.0

    # leak events (junction leakage in the reset switch)
    leak_rate_hz: float = 0.1
    leak_jitter_fraction: float = 0.1
    noise_rate_cov_decades: float = 0.1

    # refractory period; <=0 disables
    refractory_period_s: float = 0.0

    # shot noise: simple Bernoulli events (photoreceptor_noise=False) or
    # Gaussian noise injected into the photoreceptor (=True)
    shot_noise_rate_hz: float = 0.0
    photoreceptor_noise: bool = False
    shot_noise_inten_factor: float = 0.25

    # treat input as log-encoded HDR floating-point gray (skip lin-log)
    hdr: bool = False

    # seed of the emulator's torch.Generator; 0 means fresh entropy
    seed: int = 0

    @property
    def needs_inten01(self) -> bool:
        """Whether intensity rescaling is used."""
        return self.cutoff_hz > 0 or self.shot_noise_rate_hz > 0

    @property
    def simple_shot_noise(self) -> bool:
        """Bernoulli shot-noise path."""
        return self.shot_noise_rate_hz > 0 and not self.photoreceptor_noise

    def validate(self) -> None:
        if self.photoreceptor_noise:
            if self.shot_noise_rate_hz == 0:
                raise ValueError(
                    "photoreceptor_noise requires a finite shot_noise_rate_hz"
                )
            if self.cutoff_hz == 0:
                raise ValueError("photoreceptor_noise requires a finite cutoff_hz")

    @classmethod
    def clean(cls, **overrides) -> "EmulatorConfig":
        """The `--dvs_params clean` preset."""
        base = dict(
            pos_thres=0.2, neg_thres=0.2, sigma_thres=0.02,
            cutoff_hz=0.0, leak_rate_hz=0.0, leak_jitter_fraction=0.0,
            noise_rate_cov_decades=0.0, shot_noise_rate_hz=0.0,
            refractory_period_s=0.0,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def noisy(cls, **overrides) -> "EmulatorConfig":
        """The `--dvs_params noisy` preset."""
        base = dict(
            pos_thres=0.2, neg_thres=0.2, sigma_thres=0.05,
            cutoff_hz=30.0, leak_rate_hz=0.1, shot_noise_rate_hz=5.0,
            refractory_period_s=0.0, leak_jitter_fraction=0.1,
            noise_rate_cov_decades=0.1,
        )
        base.update(overrides)
        return cls(**base)
