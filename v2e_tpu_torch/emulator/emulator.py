"""`EventEmulator`: the stateful DVS emulator facade (port of
v2e_tpu/emulator/emulator.py).

Push frames with `generate_events(frame, t)` or chunks of frames with
`generate_events_batch(frames, times)`, or split the work with
`submit_batch` / `collect`.  The chunk runs on the device
(`emulate_and_compact_impl`); `collect` fetches the compacted cells, the
single-pixel probe and the model-state frames (`collect_fetch`) and
materializes AER events on the host, writing the AEDAT-2, AEDAT-4, text
and HDF5 sinks (with `prepare_storage`, the HDF5 file also takes the
frames, DDD-style), the probe's record and the state videos
(`collect_finalize`).  `save_state` / `load_state` checkpoint a
conversion.  The JAX package's `prewarm_collect` compiles XLA slice
programs ahead of time; PyTorch runs eagerly, so it has no counterpart.
With a mesh (parallel/) a chunk runs in pixel strips
(`parallel_mode="pixel"`, parallel/mesh.py) or in time segments
(`"segment"`, parallel/convert.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch import tracing
from v2e_tpu_torch.device import resolve_device, upload
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import (
    _slice_logical,
    compact_chunk,
    draw_chunk_noise,
    emulate_and_compact_impl,
    pack_chunk,
    unpack_scalars,
)
from v2e_tpu_torch.emulator.events import materialize_events_sparse
from v2e_tpu_torch.emulator.state import init_state, rebase_state
from v2e_tpu_torch.ops.noise import compute_photoreceptor_noise_voltage
from v2e_tpu_torch.utils.paths import check_add_suffix

logger = logging.getLogger(__name__)

# display ranges of the model-state videos
_L255 = float(np.log(255.0))
MODEL_STATES = {
    "new_frame": (0, 255),
    "log_new_frame": (0, _L255),
    "lp_log_frame": (0, _L255),
    "scidvs_highpass": (-_L255 / 8, _L255 / 8),
    "photoreceptor_noise_arr": (-_L255 / 8, _L255 / 8),
    "cs_surround_frame": (0, _L255),
    "c_minus_s_frame": (-_L255 / 8, _L255 / 8),
    "base_log_frame": (-_L255 / 8, _L255 / 8),
    "diff_frame": (-_L255 / 8, _L255 / 8),
}

SINGLE_PIXEL_STATES_FILENAME = "pixel-states.dat"
SINGLE_PIXEL_MAX_SAMPLES = 10000
# the probe's values per frame, in the order of emulator_step's out["probe"]
_PROBE_KEYS = (
    "new_frame",
    "base_log_frame",
    "lp_log_frame",
    "log_new_frame",
    "pos_thres",
    "neg_thres",
    "diff_frame",
    "final_neg_evts_frame",
    "final_pos_evts_frame",
)

# save_state's array names: "params/.<field>", "state/.<field>" (the JAX
# package's key paths), the host counters and the generator's state
_SCALARS = "__scalars"
_GENERATOR = "__generator_state"
_SHUFFLE = "__shuffle_state"  # the within-iteration shuffle's numpy generator
_JAX_KEY = "__key_data"


class _ChunkCopy:
    """Copies of one chunk's device arrays to the host that wait for that
    chunk alone.  On a card they run on a copy stream of their own, which
    waits on the chunk's event `done` (`EventEmulator._handle`), into pinned
    memory, and only that stream is synchronised: a copy on the current
    stream would also wait for every chunk queued behind this one.  On the
    CPU they are plain copies."""

    def __init__(self, done: Optional["torch.cuda.Event"], stream: Optional["torch.cuda.Stream"]):
        self.stream = None if done is None else stream
        if self.stream is not None:
            self.stream.wait_event(done)

    def after_chunk(self):
        """A context in which device work follows the chunk's, and nothing
        queued after it."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def to_host(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """The tensors as numpy arrays, once their copies have run."""
        if self.stream is None:
            return {k: v.cpu().numpy() for k, v in tensors.items()}
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in tensors.items():
                out[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                out[k].copy_(v, non_blocking=True)
        self.stream.synchronize()
        return {k: v.numpy() for k, v in out.items()}

    def array(self, tensor: torch.Tensor) -> np.ndarray:
        return self.to_host({"": tensor})[""]


def _capacity_bucket(n: int) -> int:
    """Next power-of-two capacity >= n."""
    cap = 4096
    while cap < n:
        cap *= 2
    return cap


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
        dvs_h5: Optional[str] = None,
        dvs_aedat2: Optional[str] = None,
        dvs_aedat4: Optional[str] = None,
        dvs_text: Optional[str] = None,
        output_width: Optional[int] = None,
        output_height: Optional[int] = None,
        device: Optional[str] = None,
        hdr: bool = False,
        label_signal_noise: bool = False,
        shuffle_events_within_iteration: bool = True,
        compaction_capacity_hint: Optional[int] = None,
        scidvs: bool = False,
        cs_lambda_pixels: Optional[float] = None,
        cs_tau_p_ms: Optional[float] = None,
        show_dvs_model_state: Optional[List[str]] = None,
        save_dvs_model_state: bool = False,
        record_single_pixel_states: Optional[Tuple[int, int]] = None,
        mesh=None,
        parallel_mode: str = "pixel",
        segment_warmup: int = 8,
        n_segments: Optional[int] = None,
        pad_rows: int = 0,
    ):
        """`record_single_pixel_states` (x, y) records that pixel's states
        each frame into pixel-states.dat; `show_dvs_model_state` names the
        state frames each frame computes (["all"] for every one of
        MODEL_STATES), which `save_dvs_model_state` writes to an AVI each
        (there is no display window).

        `mesh` (parallel.mesh.Mesh) runs each chunk over several devices,
        the state kept on the mesh's first device (which `device` then is):
        parallel_mode "pixel" splits the image rows into strips over the
        mesh's 'spatial' axis, bit-exact against one device, with
        `pad_rows` inert rows making H divide; "segment" splits the chunk
        into `n_segments` (default: the mesh's size) time segments over a
        1-D 'seg' mesh, each seeded with `segment_warmup` overlap frames
        whose events are dropped, events at a seam shifting by at most one
        threshold crossing (parallel/convert.py)."""
        self.device = mesh.lead if mesh is not None else resolve_device(device)
        if record_single_pixel_states is not None:
            if (
                not isinstance(record_single_pixel_states, tuple)
                or len(record_single_pixel_states) != 2
                or not all(isinstance(i, int) for i in record_single_pixel_states)
            ):
                raise ValueError(
                    f"record_single_pixel_states {record_single_pixel_states} must "
                    "be an (x, y) tuple of ints"
                )
        emit_states: tuple = ()
        if show_dvs_model_state is not None:
            if len(show_dvs_model_state) == 1 and show_dvs_model_state[0] == "all":
                emit_states = tuple(MODEL_STATES.keys())
            else:
                emit_states = tuple(show_dvs_model_state)
        self.cfg = EmulatorConfig(
            pos_thres=pos_thres, neg_thres=neg_thres, sigma_thres=sigma_thres,
            cutoff_hz=cutoff_hz, leak_rate_hz=leak_rate_hz,
            leak_jitter_fraction=leak_jitter_fraction,
            noise_rate_cov_decades=noise_rate_cov_decades,
            refractory_period_s=refractory_period_s,
            shot_noise_rate_hz=shot_noise_rate_hz,
            photoreceptor_noise=photoreceptor_noise, hdr=hdr, seed=seed,
            scidvs=scidvs, cs_lambda_pixels=cs_lambda_pixels, cs_tau_p_ms=cs_tau_p_ms,
            probe=record_single_pixel_states, emit_states=emit_states,
            pad_rows=int(pad_rows),
        )
        if parallel_mode not in ("pixel", "segment"):
            raise ValueError(f"parallel_mode {parallel_mode!r} must be 'pixel' or 'segment'")
        if pad_rows and parallel_mode == "segment":
            raise ValueError("pad_rows applies to pixel strips only (segment mode splits "
                             "time, not rows)")
        if mesh is not None and parallel_mode == "segment":
            if "seg" not in mesh.axis_names:
                raise ValueError("segment-parallel mode needs a 1-D mesh with axis 'seg' "
                                 "(see v2e_tpu_torch.parallel.convert.make_segment_mesh)")
            if record_single_pixel_states is not None or emit_states:
                raise ValueError("segment-parallel mode does not support the single-pixel "
                                 "probe or model-state emission (use parallel_mode='pixel')")
        if mesh is not None and parallel_mode == "pixel" and "spatial" not in mesh.axis_names:
            raise ValueError("pixel strips need a mesh with axis 'spatial' "
                             "(see v2e_tpu_torch.parallel.make_mesh)")
        self.mesh = mesh
        self.parallel_mode = parallel_mode
        self.segment_warmup = int(segment_warmup)
        self.n_segments = n_segments
        self._tail = None  # segment mode: the last warmup+1 frames, times and warmup draws
        self.cfg.validate()
        self.label_signal_noise = label_signal_noise
        self.shuffle = shuffle_events_within_iteration
        self.output_folder = output_folder
        self.output_width = output_width
        self.output_height = output_height
        self.show_dvs_model_state = show_dvs_model_state
        self.save_dvs_model_state = save_dvs_model_state

        self.params = None
        self.state = None
        self.t_origin: float = 0.0  # absolute f64 time of the chunk origin
        self.t_previous: float = 0.0
        self.frame_counter = 0
        self.num_events_total = 0
        self.num_events_on = 0
        self.num_events_off = 0
        self._submitted = 0  # chunks submitted: the next chunk's id in its spans
        # the fetch's copies to the host (_ChunkCopy)
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        seed_val = seed if seed != 0 else int.from_bytes(os.urandom(4), "little")
        self.generator = torch.Generator(device=self.device).manual_seed(seed_val)
        self._pr_noise_pending = False
        self._capacity = (
            _capacity_bucket(compaction_capacity_hint)
            if compaction_capacity_hint else 16384
        )
        self._np_rng = np.random.default_rng(seed if seed != 0 else None)

        self.record_single_pixel_states = record_single_pixel_states
        self.single_pixel_sample_count = 0
        self.single_pixel_states = None
        if record_single_pixel_states is not None:
            self.single_pixel_states = {
                k: np.full(SINGLE_PIXEL_MAX_SAMPLES, np.nan) for k in ("time",) + _PROBE_KEYS
            }

        self.dvs_h5 = None
        self.dvs_aedat2 = None
        self.dvs_aedat4 = None
        self.dvs_text = None
        self._video_writers: Dict[str, object] = {}
        if output_folder is not None:
            os.makedirs(output_folder, exist_ok=True)
        if dvs_h5:
            from v2e_tpu_torch.io.hdf5 import DVSH5Output

            self.dvs_h5 = DVSH5Output(
                check_add_suffix(os.path.join(output_folder or ".", dvs_h5), ".h5"))
        if dvs_aedat2:
            from v2e_tpu_torch.io.aedat2 import AEDat2Output

            self.dvs_aedat2 = AEDat2Output(
                check_add_suffix(os.path.join(output_folder or ".", dvs_aedat2), ".aedat"),
                output_width=output_width or 346,
                output_height=output_height or 260,
                label_signal_noise=label_signal_noise,
            )
        if dvs_aedat4:
            from v2e_tpu_torch.io.aedat4 import AEDat4Output

            self.dvs_aedat4 = AEDat4Output(
                check_add_suffix(os.path.join(output_folder or ".", dvs_aedat4), ".aedat4"),
                output_width=output_width or 640,
                output_height=output_height or 480,
            )
        if dvs_text:
            from v2e_tpu_torch.io.text import DVSTextOutput

            self.dvs_text = DVSTextOutput(
                check_add_suffix(os.path.join(output_folder or ".", dvs_text), ".txt"),
                label_signal_noise=label_signal_noise,
            )

    def set_dvs_params(self, model: str) -> None:
        """Apply the 'clean' or 'noisy' preset before the first frame; the
        pixel variant, the probe and the state frames are kept."""
        if self.state is not None:
            raise RuntimeError("set_dvs_params must be called before the first frame")
        presets = {"clean": EmulatorConfig.clean, "noisy": EmulatorConfig.noisy}
        if model not in presets:
            logger.warning(f"dvs_params '{model}' not known: using the given options")
            return
        cfg = self.cfg
        self.cfg = presets[model](
            hdr=cfg.hdr, seed=cfg.seed, scidvs=cfg.scidvs,
            cs_lambda_pixels=cfg.cs_lambda_pixels, cs_tau_p_ms=cfg.cs_tau_p_ms,
            probe=cfg.probe, emit_states=cfg.emit_states, pad_rows=cfg.pad_rows,
        )

    def reset(self) -> None:
        """Start again from the next frame, which initializes the state."""
        self.params = None
        self.state = None
        self.t_origin = 0.0
        self.t_previous = 0.0
        self.frame_counter = 0
        self.num_events_total = 0
        self.num_events_on = 0
        self.num_events_off = 0
        self._tail = None

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
    def generate_events(self, new_frame, t_frame: float) -> Optional[np.ndarray]:
        """The single-frame API of the original v2e: one frame at absolute
        time `t_frame`; returns its events f64[N,4] = [t, x, y, p], or None
        (the first frame, or no events)."""
        return self.generate_events_batch(
            torch.as_tensor(new_frame)[None], np.array([t_frame], dtype=np.float64)
        )

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
        cid = self._next_chunk()
        with tracing.root("submit", cid) as sp:
            return self._submit(frames, times, cid, sp)

    def _next_chunk(self) -> int:
        self._submitted += 1
        return self._submitted - 1

    def _submit(self, frames, times, cid, sp) -> Optional[Dict]:
        with tracing.span("submit.upload", tracing.WAIT):
            frames = upload(frames, self.device)
        times = self._check_times(times)
        if frames.ndim != 3 or frames.shape[0] != times.shape[0]:
            raise ValueError("frames must be [F,H,W] matching times [F]")
        start = 0
        if self.state is None:
            self._initialize(frames[0], times[0])
            self.t_previous = float(times[0])
            self.frame_counter += 1
            if self.dvs_h5 is not None:
                self.dvs_h5.appendFrame(frames[0].cpu().numpy(), ts=float(times[0]),
                                        ev_idx=self.dvs_h5.numEventsWritten)
            start = 1
            if start >= frames.shape[0]:
                return None
        if self._pr_noise_pending:
            self._calibrate_photoreceptor_noise(float(times[start]) - self.t_previous)
        chunk = frames[start:]
        t_origin = self.t_origin
        with tracing.span("submit.upload", tracing.WAIT):
            rel_times = upload((times[start:] - t_origin).astype(np.float32), self.device)
        if self.mesh is not None and self.parallel_mode == "segment":
            outs, packed = self._submit_segments(frames, chunk, times, start, t_origin, rel_times)
        else:
            if self.cfg.pad_rows:
                # inert rows so that H splits evenly (EmulatorConfig.pad_rows)
                chunk = torch.nn.functional.pad(chunk, (0, 0, 0, self.cfg.pad_rows))
            with tracing.span("emulator.precore", tracing.DEVICE, self.device):
                draws = draw_chunk_noise(
                    self.cfg, chunk.shape[0], chunk.shape[1:], self.generator, self.device
                )
            if self.mesh is not None:
                from v2e_tpu_torch.parallel.mesh import emulate_chunk_sharded

                self.state, outs = emulate_chunk_sharded(
                    self.cfg, self.mesh, self.params, self.state, chunk, rel_times, draws=draws)
                packed = pack_chunk(self.cfg, outs, self._capacity)
            else:
                self.state, outs, packed = emulate_and_compact_impl(
                    self.cfg, self.params, self.state, chunk, rel_times, self._capacity, draws
                )
        self._advance(times[start:], t_origin)
        handle = self._handle(outs, packed, t_origin, times[start:], cid, sp)
        if self.dvs_h5 is not None:
            handle["frames_for_h5"] = frames[start:]
        return handle

    def _submit_segments(self, frames, chunk, times, start, t_origin, rel_times):
        """A chunk in time segments (parallel/convert.py), with the tail of
        the last warmup+1 frames, their times and the last warmup frames
        of draws rolled on to the next chunk."""
        from v2e_tpu_torch.parallel.convert import emulate_and_compact_segmented

        W = self.segment_warmup
        with tracing.span("emulator.precore", tracing.DEVICE, self.device):
            draws = draw_chunk_noise(
                self.cfg, chunk.shape[0], chunk.shape[1:], self.generator, self.device)
        if self._tail is None:
            # first chunk: the first frame replayed at its own time (dt = 0
            # replays change nothing, whatever their draws)
            self._tail = (
                frames[0].to(torch.float32).expand(W + 1, *frames.shape[1:]),
                np.full(W + 1, float(times[0])),
                {k: None if v is None else torch.zeros_like(v[:1]).expand(W, *v.shape[1:])
                 for k, v in draws.items()},
            )
        tail_frames, tail_times, tail_draws = self._tail
        S = self.n_segments or self.mesh.size
        tail_rel = upload((tail_times - t_origin).astype(np.float32), self.device)
        self.state, outs, packed = emulate_and_compact_segmented(
            self.cfg, self.params, self.state, chunk, rel_times, tail_frames, tail_rel, S, W,
            self._capacity, self.mesh, draws, tail_draws)
        self._tail = (
            torch.cat([tail_frames, chunk.to(torch.float32)])[-(W + 1):],
            np.concatenate([tail_times, times[start:]])[-(W + 1):],
            {k: None if v is None else torch.cat([tail_draws[k], v])[-W:] if W else v[:0]
             for k, v in draws.items()},
        )
        return outs, packed

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
        if self.mesh is not None or self.cfg.pad_rows:
            raise RuntimeError("fused submission is single-device only")
        times = self._check_times(times)
        if self._pr_noise_pending:
            self._calibrate_photoreceptor_noise(float(times[0]) - self.t_previous)
        cid = self._next_chunk()
        with tracing.root("submit", cid) as sp:
            with tracing.span("submit.upload", tracing.WAIT):
                frames = upload(frames, self.device)
                rel_times = upload((times - self.t_origin).astype(np.float32), self.device)
            t_origin = self.t_origin
            self.state, outs, packed = fused_fn(
                self.cfg, statics, self.params, self.state, flow_net, interp_net,
                self._capacity, frames, rel_times, self.generator,
            )
            self._advance(times, t_origin)
            handle = self._handle(outs, packed, t_origin, times, cid, sp)
        handle["fused"] = True
        return handle

    def _handle(self, outs, packed, t_origin, times, cid: int, sp) -> Dict:
        """A chunk's collect handle; it carries the chunk's id and whether its
        spans record (`tracing`) to the collect threads, and on a card the
        event `done`, recorded after the chunk's last device work, which the
        fetch waits on instead of the whole stream."""
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return {
            "outs": outs, "packed": packed, "t_origin": t_origin,
            "times": times, "shape": tuple(outs["ev_count"].shape),
            "capacity": int(packed["sparse"]["idx"].shape[0]),
            "chunk": cid, "traced": sp.recording, "done": done,
        }

    def collect(self, handle: Dict):
        """Fetch and materialize a submitted chunk and write the sinks.

        Returns (events f64[N,4], labels, frame_offsets).  Chunks must be
        collected in submission order.  `collect(h)` is
        `collect_finalize(h, collect_fetch(h))`: a pipelined caller runs the
        fetch of chunk N beside the finalize of chunk N-1.
        """
        return self.collect_finalize(handle, self.collect_fetch(handle))

    def collect_fetch(self, handle: Dict) -> Dict:
        """Stage 1 of `collect`: wait for the chunk, copy its scalars and
        occupied sparse cells to the host, and recompact at a larger
        capacity on overflow.  Device and copy work only, no sink writes."""
        with tracing.root("collect.fetch", handle["chunk"], traced=handle["traced"]):
            return self._fetch(handle)

    def _fetch(self, handle: Dict) -> Dict:
        copy = _ChunkCopy(handle["done"], self._copy_stream)
        with tracing.span("collect.fetch.wait", tracing.WAIT):
            scalars = copy.array(handle["packed"]["scalars"])
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
            tracing.count("compact.recompact")
            with copy.after_chunk():
                sparse = compact_chunk(self.cfg, handle["outs"], cap)
        self._capacity = max(self._capacity, _capacity_bucket(2 * max(n_occ, 1)))
        packed["sparse"] = copy.to_host({k: v[:n_occ] for k, v in sparse.items()})
        if self.cfg.probe is not None:
            packed["probe"] = copy.array(handle["packed"]["probe"])
        if self.cfg.emit_states and self.save_dvs_model_state:
            packed["states"] = copy.to_host(handle["outs"]["states"])
        if "frames_for_h5" in handle:
            packed["frames_for_h5"] = copy.array(handle["frames_for_h5"])
        return packed

    def collect_finalize(self, handle: Dict, packed: Dict):
        """Stage 2 of `collect`: materialize the events on the host, count
        them and write the sinks.  Runs in submission order."""
        with tracing.root("collect.finalize", handle["chunk"], traced=handle["traced"]) as sp:
            out = self._finalize(handle, packed)
            sp.add("events", out[0].shape[0])
        return out

    def _finalize(self, handle: Dict, packed: Dict):
        n_occ = packed["n_occ"]
        sp = packed["sparse"]
        F, H, W = handle["shape"]
        if n_occ:
            with tracing.span("collect.materialize"):
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
        if "probe" in packed:
            self._record_probe(packed["probe"], handle["times"])
        if "states" in packed:
            self._handle_state_frames(packed["states"])
        if "frames_for_h5" in packed:
            base_idx = self.dvs_h5.numEventsWritten
            for f, frame in enumerate(packed["frames_for_h5"]):
                self.dvs_h5.appendFrame(frame, ts=float(handle["times"][f]),
                                        ev_idx=base_idx + int(offsets[f + 1]))
            with tracing.span("collect.write"):
                self.dvs_h5.appendEvents(events)
        for sink in (self.dvs_aedat2, self.dvs_aedat4, self.dvs_text):
            if sink is not None:
                with tracing.span("collect.write"):
                    sink.appendEvents(events, signnoise_label=labels)
        return events, labels, offsets

    # ------------------------------------------------------------------
    def _record_probe(self, probe: np.ndarray, times: np.ndarray) -> None:
        """Append the chunk's probe rows f32[F,9] at their absolute times;
        at SINGLE_PIXEL_MAX_SAMPLES samples the record is saved and closed."""
        if self.single_pixel_states is None:
            return
        for f in range(probe.shape[0]):
            k = self.single_pixel_sample_count
            if k >= SINGLE_PIXEL_MAX_SAMPLES:
                self.save_recorded_single_pixel_states()
                self.single_pixel_states = None
                return
            self.single_pixel_states["time"][k] = times[f]
            for i, name in enumerate(_PROBE_KEYS):
                self.single_pixel_states[name][k] = probe[f, i]
            self.single_pixel_sample_count += 1

    def save_recorded_single_pixel_states(self) -> None:
        """Pickle the probe's record (a dict of float arrays, NaN past the
        last sample) to pixel-states.dat in the output folder."""
        if self.single_pixel_states is None:
            return
        path = os.path.join(self.output_folder or ".", SINGLE_PIXEL_STATES_FILENAME)
        with open(path, "wb") as f:
            pickle.dump(self.single_pixel_states, f, protocol=pickle.HIGHEST_PROTOCOL)
        logger.info(
            f"saved single-pixel states with {self.single_pixel_sample_count} "
            f"samples to {path}"
        )

    def _handle_state_frames(self, states: Dict[str, np.ndarray]) -> None:
        """Append each state's frames [F,H,W] to <name>.avi in the output
        folder, scaled by its MODEL_STATES range to 8 bits."""
        import cv2

        from v2e_tpu_torch.utils.video import video_writer

        for name, stack in states.items():
            stack = _slice_logical(self.cfg, stack)
            lo, hi = MODEL_STATES[name]
            if name not in self._video_writers:
                h, w = stack.shape[1:]
                self._video_writers[name] = video_writer(
                    os.path.join(self.output_folder or ".", name + ".avi"), h, w
                )
            vw = self._video_writers[name]
            for frame in stack:
                img8 = (np.clip((frame - lo) / (hi - lo), 0, 1) * 255).astype(np.uint8)
                vw.write(cv2.cvtColor(img8, cv2.COLOR_GRAY2BGR))

    # ------------------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Checkpoint the emulator so a conversion can resume: every
        parameter and state array, the host counters, the generator's state
        and the event shuffle's, in one .npz with the JAX package's names
        (the generator's state takes the place of its PRNG key)."""
        if self.state is None:
            raise RuntimeError("no state to save (no frames processed yet)")
        if self.mesh is not None:
            raise RuntimeError("save_state runs without a mesh only")
        blobs = {}
        for name in ("params", "state"):
            obj = getattr(self, name)
            for f in dataclasses.fields(obj):
                value = getattr(obj, f.name)
                if value is not None:
                    blobs[f"{name}/.{f.name}"] = value.cpu().numpy()
        blobs[_SCALARS] = np.array(
            [self.t_origin, self.t_previous, self.frame_counter,
             self.num_events_on, self.num_events_off, self._capacity],
            dtype=np.float64,
        )
        blobs[_GENERATOR] = self.generator.get_state().numpy()
        blobs[_SHUFFLE] = np.array(json.dumps(self._np_rng.bit_generator.state))
        np.savez(path, **blobs)
        logger.info(f"saved emulator state to {path}")

    def load_state(self, path: str) -> None:
        """Restore a checkpoint written by `save_state`, or by the JAX
        package's.  The emulator must have the checkpoint's configuration
        and no frames yet.  A JAX checkpoint holds a PRNG key instead of the
        generator's state: the generator then stays seeded from the
        configuration, so the noise stream is the port's own."""
        if self.state is not None:
            raise RuntimeError("load_state requires a fresh emulator")
        if self.mesh is not None:
            raise RuntimeError("load_state runs without a mesh only")
        npz = np.load(path)
        H, W = next(npz[k].shape for k in npz.files if k.endswith("pos_thres"))
        H -= self.cfg.pad_rows
        # the configuration's fields, from a throwaway initialization
        params, state = init_state(
            self.cfg, torch.zeros((H, W), device=self.device), 0.0,
            torch.Generator(device=self.device),
        )

        def restore(name, obj):
            values = {}
            for f in dataclasses.fields(obj):
                key = f"{name}/.{f.name}"
                if key in npz.files:
                    values[f.name] = torch.from_numpy(npz[key]).to(self.device)
            return dataclasses.replace(obj, **values)

        self.params = restore("params", params)
        self.state = restore("state", state)
        sc = npz[_SCALARS]
        self.t_origin = float(sc[0])
        self.t_previous = float(sc[1])
        self.frame_counter = int(sc[2])
        self.num_events_on = int(sc[3])
        self.num_events_off = int(sc[4])
        self.num_events_total = self.num_events_on + self.num_events_off
        self._capacity = int(sc[5])
        if _GENERATOR in npz.files:
            self.generator.set_state(torch.from_numpy(npz[_GENERATOR]))
            self._np_rng.bit_generator.state = json.loads(str(npz[_SHUFFLE]))
        elif _JAX_KEY in npz.files:
            logger.info(
                f"{path} was written by v2e_tpu: its PRNG key has no counterpart "
                "here, so the noise stream from now on is this emulator's own "
                f"(its generator seeded from the configuration, seed {self.cfg.seed})"
            )
        if self.output_height is None:
            self.output_height, self.output_width = H, W
        logger.info(
            f"restored emulator state from {path} "
            f"(t={self.t_previous:.4f}s, {self.frame_counter} frames)"
        )

    def prepare_storage(self, n_frames: Optional[int], frame_ts) -> None:
        """DDD-style frame storage in the HDF5 file (--ddd_output): the
        frame datasets, grown as frames arrive when `n_frames` is None."""
        if self.dvs_h5 is not None:
            self.dvs_h5.prepare_frame_storage(
                n_frames, frame_ts, self.output_height, self.output_width
            )

    def cleanup(self) -> None:
        """Close the event sinks and state videos and save the probe's
        record."""
        for sink in (self.dvs_h5, self.dvs_aedat2, self.dvs_aedat4, self.dvs_text):
            if sink is not None:
                sink.close()
        for vw in self._video_writers.values():
            vw.release()
        self._video_writers = {}
        if self.record_single_pixel_states is not None:
            self.save_recorded_single_pixel_states()
