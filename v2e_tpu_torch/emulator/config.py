"""Static configuration of the DVS pixel model (port of
v2e_tpu/emulator/config.py).

The JAX package's `use_pallas_scan` switch has no counterpart: the
sequential core runs its kernel (K1, or K2 when the refractory period is
0) whenever its tensors are on a CUDA device and the kernel's plain version
when they are on the CPU, except for the SciDVS pixel, whose core is a
plain loop (core.py), as the JAX package sends it to its XLA scan.
`pad_rows` appends inert rows to the pixel plane so that its rows split
evenly into the strips of a mesh (parallel/mesh.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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

    # SciDVS adaptive-photoreceptor pixel
    scidvs: bool = False
    scidvs_gain: float = 2.0
    scidvs_tau_s: float = 0.01
    scidvs_tau_cov: float = 0.5

    # center-surround DVS (diffuser network); None disables
    cs_lambda_pixels: Optional[float] = None
    cs_tau_p_ms: Optional[float] = None
    # "exact": the closed-form transient in the DCT-II basis; "euler": the
    # capped Euler stepping, kept for cross-validation
    csdvs_solver: str = "exact"

    # seed of the emulator's torch.Generator; 0 means fresh entropy
    seed: int = 0

    # rows of inert padding appended to the pixel plane so that H splits
    # evenly into a mesh's strips: pad pixels have thresholds of 1e9 and
    # zero noise rates and never emit, and the random draws are made at the
    # logical shape (core.draw_chunk_noise), so the logical pixels of a
    # padded run equal those of an unpadded one bit for bit
    pad_rows: int = 0

    # record one pixel's internal states per frame, (x, y)
    probe: Optional[tuple] = None
    # names of the state frames each step returns (emulator.MODEL_STATES)
    emit_states: tuple = ()

    @property
    def csdvs_enabled(self) -> bool:
        return self.cs_lambda_pixels is not None

    @property
    def cs_tau_h_ms(self) -> float:
        """Surround (horizontal-cell) time constant."""
        if not self.csdvs_enabled:
            return 0.0
        if self.cs_tau_p_ms is None or self.cs_tau_p_ms == 0:
            return 0.0
        return self.cs_tau_p_ms / (self.cs_lambda_pixels**2)

    @property
    def per_frame(self) -> bool:
        """Whether a chunk runs the per-frame step (core.emulator_step):
        CSDVS, the probe and the state frames need its per-frame values."""
        return self.csdvs_enabled or bool(self.emit_states) or self.probe is not None

    @property
    def needs_inten01(self) -> bool:
        """Whether intensity rescaling is used."""
        return self.cutoff_hz > 0 or self.shot_noise_rate_hz > 0

    @property
    def simple_shot_noise(self) -> bool:
        """Bernoulli shot-noise path."""
        return self.shot_noise_rate_hz > 0 and not self.photoreceptor_noise

    def validate(self) -> None:
        if self.pad_rows < 0:
            raise ValueError(f"pad_rows {self.pad_rows} must be >= 0")
        if self.pad_rows and self.csdvs_enabled:
            raise ValueError(
                "pad_rows is incompatible with the center-surround DVS: the "
                "surround diffusion would couple logical pixels to the pad "
                "rows (use a divisor device count instead)"
            )
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
