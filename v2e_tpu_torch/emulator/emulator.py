"""`EventEmulator`: the stateful DVS emulator facade (port of the parts of
v2e_tpu/emulator/emulator.py that the fused conversion uses).

Push chunks of frames with `generate_events_batch(frames, times)`, or split
the work with `submit_batch` / `collect`.  The chunk runs on the device
(`emulate_and_compact_impl`); `collect` fetches the compacted cells and
materializes AER events on the host, writing the AEDAT-2 and text sinks.
The HDF5 and AEDAT-4 sinks, the probe and model-state outputs and the
multi-device modes are not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from v2e_tpu_torch.device import resolve_device
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import (
    compact_chunk,
    draw_chunk_noise,
    emulate_and_compact_impl,
    unpack_scalars,
)
from v2e_tpu_torch.emulator.events import materialize_events_sparse
from v2e_tpu_torch.emulator.state import init_state, rebase_state
from v2e_tpu_torch.ops.noise import compute_photoreceptor_noise_voltage

logger = logging.getLogger(__name__)


def _capacity_bucket(n: int) -> int:
    """Next power-of-two capacity >= n."""
    cap = 4096
    while cap < n:
        cap *= 2
    return cap


def _add_suffix(path: str, suffix: str) -> str:
    return path if path.endswith(suffix) else path + suffix


class EventEmulator:
    """Stateful DVS emulator with the original v2e constructor surface."""

    def __init__(
        self,
        pos_thres: float = 0.2,
        neg_thres: float = 0.2,
        sigma_thres: float = 0.03,
        cutoff_hz: float = 0.0,
        leak_rate_hz: float = 0.1,
        refractory_period_s: float = 0.0,
        shot_noise_rate_hz: float = 0.0,
        photoreceptor_noise: bool = False,
        leak_jitter_fraction: float = 0.1,
        noise_rate_cov_decades: float = 0.1,
        seed: int = 0,
        output_folder: Optional[str] = None,
        dvs_aedat2: Optional[str] = None,
        dvs_text: Optional[str] = None,
        output_width: Optional[int] = None,
        output_height: Optional[int] = None,
        device: Optional[str] = None,
        hdr: bool = False,
        label_signal_noise: bool = False,
        shuffle_events_within_iteration: bool = True,
        compaction_capacity_hint: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.cfg = EmulatorConfig(
            pos_thres=pos_thres, neg_thres=neg_thres, sigma_thres=sigma_thres,
            cutoff_hz=cutoff_hz, leak_rate_hz=leak_rate_hz,
            leak_jitter_fraction=leak_jitter_fraction,
            noise_rate_cov_decades=noise_rate_cov_decades,
            refractory_period_s=refractory_period_s,
            shot_noise_rate_hz=shot_noise_rate_hz,
            photoreceptor_noise=photoreceptor_noise, hdr=hdr, seed=seed,
        )
        self.cfg.validate()
        self.label_signal_noise = label_signal_noise
        self.shuffle = shuffle_events_within_iteration
        self.output_folder = output_folder
        self.output_width = output_width
        self.output_height = output_height

        self.params = None
        self.state = None
        self.t_origin: float = 0.0  # absolute f64 time of the chunk origin
        self.t_previous: float = 0.0
        self.frame_counter = 0
        self.num_events_total = 0
        self.num_events_on = 0
        self.num_events_off = 0

        seed_val = seed if seed != 0 else int.from_bytes(os.urandom(4), "little")
        self.generator = torch.Generator(device=self.device).manual_seed(seed_val)
        self._pr_noise_pending = False
        self._capacity = (
            _capacity_bucket(compaction_capacity_hint)
            if compaction_capacity_hint else 16384
        )
        self._np_rng = np.random.default_rng(seed if seed != 0 else None)

        self.dvs_aedat2 = None
        self.dvs_text = None
        if output_folder is not None:
            os.makedirs(output_folder, exist_ok=True)
        if dvs_aedat2:
            from v2e_tpu_torch.io.aedat2 import AEDat2Output

            self.dvs_aedat2 = AEDat2Output(
                _add_suffix(os.path.join(output_folder or ".", dvs_aedat2), ".aedat"),
                output_width=output_width or 346,
                output_height=output_height or 260,
                label_signal_noise=label_signal_noise,
            )
        if dvs_text:
            from v2e_tpu_torch.io.text import DVSTextOutput

            self.dvs_text = DVSTextOutput(
                _add_suffix(os.path.join(output_folder or ".", dvs_text), ".txt"),
                label_signal_noise=label_signal_noise,
            )

    def set_dvs_params(self, model: str) -> None:
        """Apply the 'clean' or 'noisy' preset before the first frame."""
        if self.state is not None:
            raise RuntimeError("set_dvs_params must be called before the first frame")
        presets = {"clean": EmulatorConfig.clean, "noisy": EmulatorConfig.noisy}
        if model not in presets:
            logger.warning(f"dvs_params '{model}' not known: using the given options")
            return
        self.cfg = presets[model](hdr=self.cfg.hdr, seed=self.cfg.seed)

    # ------------------------------------------------------------------
    def _initialize(self, first_frame: torch.Tensor, t0: float) -> None:
        if self.output_height is None:
            self.output_height, self.output_width = first_frame.shape
        self.t_origin = float(t0)
        self.params, self.state = init_state(self.cfg, first_frame, 0.0, self.generator)
        self._pr_noise_pending = self.cfg.photoreceptor_noise

    def _calibrate_photoreceptor_noise(self, delta_time: float) -> None:
        vrms = compute_photoreceptor_noise_voltage(
            shot_noise_rate_hz=self.cfg.shot_noise_rate_hz,
            f3db=self.cfg.cutoff_hz,
            sample_rate_hz=1.0 / delta_time,
            pos_thr=self.cfg.pos_thres,
            neg_thr=self.cfg.neg_thres,
            sigma_thr=self.cfg.sigma_thres,
            rng=self._np_rng,
        )
        self.params = dataclasses.replace(
            self.params,
            photoreceptor_noise_vrms=torch.tensor(vrms, dtype=torch.float32, device=self.device),
        )
        self._pr_noise_pending = False

    def _check_times(self, times: np.ndarray) -> np.ndarray:
        times = np.asarray(times, dtype=np.float64)
        if self.frame_counter and times[0] < self.t_previous:
            raise ValueError(
                f"frame time {times[0]} is earlier than previous {self.t_previous}"
            )
        return times

    def _advance(self, times: np.ndarray, t_origin: float) -> None:
        """Bookkeeping after a chunk; rebase the chunk-relative device times
        to keep float32 precision over long runs."""
        self.frame_counter += times.shape[0]
        self.t_previous = float(times[-1])
        last_rel = float(times[-1] - t_origin)
        if last_rel > 8.0:
            self.state = rebase_state(self.state, last_rel)
            self.t_origin += last_rel

    # ------------------------------------------------------------------
    def generate_events_batch(self, frames, times) -> Optional[np.ndarray]:
        """Emulate a chunk of frames [F,H,W] at absolute float64 times [F];
        returns the chunk's events f64[N,4] = [t, x, y, p] or None."""
        handle = self.submit_batch(frames, times)
        if handle is None:
            return None
        events, _, _ = self.collect(handle)
        return events if events.shape[0] else None

    def submit_batch(self, frames, times) -> Optional[Dict]:
        """Run a chunk on the device; returns a handle for `collect`, or
        None if the chunk only initialized the emulator (one frame)."""
        frames = torch.as_tensor(frames).to(self.device)
        times = self._check_times(times)
        if frames.ndim != 3 or frames.shape[0] != times.shape[0]:
            raise ValueError("frames must be [F,H,W] matching times [F]")
        start = 0
        if self.state is None:
            self._initialize(frames[0], times[0])
            self.t_previous = float(times[0])
            self.frame_counter += 1
            start = 1
            if start >= frames.shape[0]:
                return None
        if self._pr_noise_pending:
            self._calibrate_photoreceptor_noise(float(times[start]) - self.t_previous)
        chunk = frames[start:]
        t_origin = self.t_origin
        rel_times = torch.as_tensor(
            (times[start:] - t_origin).astype(np.float32), device=self.device
        )
        draws = draw_chunk_noise(
            self.cfg, chunk.shape[0], chunk.shape[1:], self.generator, self.device
        )
        self.state, outs, packed = emulate_and_compact_impl(
            self.cfg, self.params, self.state, chunk, rel_times, self._capacity, draws
        )
        self._advance(times[start:], t_origin)
        return self._handle(outs, packed, t_origin, times[start:])

    def submit_batch_fused(
        self, fused_fn, statics, flow_net, interp_net, frames, times
    ) -> Dict:
        """Run one interpolate + emulate + compact chunk (`fused.fused_chunk`)
        on SOURCE frames [B+1,H,W] with interpolated times [B*U].  Needs an
        initialized emulator."""
        if self.state is None:
            raise RuntimeError(
                "submit_batch_fused needs an initialized emulator (feed the "
                "first chunk through submit_batch)"
            )
        times = self._check_times(times)
        if self._pr_noise_pending:
            self._calibrate_photoreceptor_noise(float(times[0]) - self.t_previous)
        frames = torch.as_tensor(frames).to(self.device)
        t_origin = self.t_origin
        rel_times = torch.as_tensor(
            (times - t_origin).astype(np.float32), device=self.device
        )
        self.state, outs, packed = fused_fn(
            self.cfg, statics, self.params, self.state, flow_net, interp_net,
            self._capacity, frames, rel_times, self.generator,
        )
        self._advance(times, t_origin)
        handle = self._handle(outs, packed, t_origin, times)
        handle["fused"] = True
        return handle

    def _handle(self, outs, packed, t_origin, times) -> Dict:
        return {
            "outs": outs, "packed": packed, "t_origin": t_origin,
            "times": times, "shape": tuple(outs["ev_count"].shape),
            "capacity": int(packed["sparse"]["idx"].shape[0]),
        }

    def collect(self, handle: Dict):
        """Fetch and materialize a submitted chunk and write the sinks.

        Returns (events f64[N,4], labels, frame_offsets).  Chunks must be
        collected in submission order.
        """
        scalars = handle["packed"]["scalars"].cpu().numpy()
        if handle.get("fused"):
            # fused chunks append the max-flow magnitude (fused.py)
            handle["max_flow"] = float(scalars[-1:].view(np.float32)[0])
            scalars = scalars[:-1]
        packed = unpack_scalars(scalars)
        n_occ = packed["n_occ"]
        sparse = handle["packed"]["sparse"]
        if n_occ > handle["capacity"]:
            # capacity overflow: recompact the dense maps at a larger bucket
            cap = _capacity_bucket(n_occ)
            logger.info(f"compaction capacity {handle['capacity']} -> {cap}")
            sparse = compact_chunk(self.cfg, handle["outs"], cap)
        self._capacity = max(self._capacity, _capacity_bucket(2 * max(n_occ, 1)))
        sp = {k: v[:n_occ].cpu().numpy() for k, v in sparse.items()}

        F, H, W = handle["shape"]
        if n_occ:
            events, labels, offsets = materialize_events_sparse(
                sp["idx"], sp["count"], sp["i0"], sp.get("shot"),
                packed["stride"], packed["K"], packed["t_prev"],
                packed["t_frame"], H, W, handle["t_origin"],
                rng=self._np_rng if self.shuffle else None,
                label_signal_noise=self.label_signal_noise,
            )
        else:
            events = np.empty((0, 4), dtype=np.float64)
            labels = np.empty(0, dtype=bool) if self.label_signal_noise else None
            offsets = np.zeros(F + 1, dtype=np.int64)

        self.num_events_on += int(np.sum(packed["num_on"]))
        self.num_events_off += int(np.sum(packed["num_off"]))
        self.num_events_total = self.num_events_on + self.num_events_off
        if self.dvs_aedat2 is not None:
            self.dvs_aedat2.appendEvents(events, signnoise_label=labels)
        if self.dvs_text is not None:
            self.dvs_text.appendEvents(events, signnoise_label=labels)
        return events, labels, offsets

    def cleanup(self) -> None:
        for sink in (self.dvs_aedat2, self.dvs_text):
            if sink is not None:
                sink.close()
