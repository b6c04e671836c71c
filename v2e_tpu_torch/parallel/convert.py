"""Time-segment conversion: the segments of a chunk on the devices of a
mesh (port of v2e_tpu/parallel/convert.py).

A chunk of F frames splits into S contiguous time segments, segment s on
device s of a 1-D `seg` mesh (round robin when S exceeds the mesh).  Each
segment is seeded from the frame before its `warmup` overlap frames: its
state starts fresh there (the emulator's first-frame initialization,
state.init_state; the parameters are the run's), the overlap frames are
replayed to converge the photoreceptor lowpass and re-align the memorized
base, and their events are thrown away.  Each segment is one whole-plane
`emulate_chunk_apply` on its device, so K1 or K2 run as they are, once
per segment.  The segments' outputs are merged on the lead device in
time order and compacted as one chunk.

Draws.  The port draws a chunk's noise from one sequential generator, not
from a counter per frame as the JAX package does.  So a segment takes the
chunk's draws sliced by frame, and its overlap frames take the previous
chunk's last `warmup` frames of draws, which the caller keeps beside its
tail of frames (EventEmulator does): then the segments draw what the
continuous run drew.  Before the first chunk the tail replays the first
frame with dt = 0, which no draw can change.

Exactness is the JAX package's: the base re-synchronizes exactly whenever
a pixel's log intensity returns to a level it held at the segment's seed
(and whenever shot noise resets the pixel); otherwise it may carry a
residual below one threshold, shifting events near a seam by at most one
threshold crossing per pixel.  Pixel strips (parallel/mesh.py) are
bit-exact; segments scale better when H*W is small and F is large.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch.device import resolve_device, scalar
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import (
    Draws,
    draw_chunk_noise,
    emulate_chunk_apply,
    pack_chunk,
)
from v2e_tpu_torch.emulator.state import EmulatorParams, EmulatorState, init_state
from v2e_tpu_torch.ops.core import lin_log
from v2e_tpu_torch.parallel.mesh import Mesh, mesh_devices


def make_segment_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-D mesh with axis 'seg' over `mesh_devices(n_devices, device)`."""
    return Mesh(np.array(mesh_devices(n_devices, device), dtype=object), ("seg",))


def _segment_init_states(
    cfg: EmulatorConfig,
    init_frames: torch.Tensor,  # [S,H,W] each segment's seed frame
    init_times: torch.Tensor,  # f32[S]
) -> List[EmulatorState]:
    """Fresh states, one per segment, with state.init_state's first-frame
    semantics (the parameters are the continuous run's)."""
    states = []
    for frame, t in zip(init_frames.to(torch.float32), init_times.to(torch.float32)):
        lp = frame if cfg.hdr else lin_log(frame)
        cs = lp if cfg.csdvs_enabled else None
        zeros = torch.zeros_like(lp)
        states.append(EmulatorState(
            base_log_frame=(lp - cs) if cfg.csdvs_enabled else lp,
            lp_log_frame=lp,
            photoreceptor_noise_arr=zeros,
            timestamp_mem=(t - scalar(cfg.refractory_period_s, t)).expand(lp.shape).clone(),
            t_prev=t,
            scidvs_highpass=zeros if cfg.scidvs else None,
            scidvs_previous_photo=lp if cfg.scidvs else None,
            cs_surround_frame=cs,
        ))
    return states


def _plan_segments(F: int, n_segments: int) -> Tuple[int, int]:
    """(frames per segment L, padded total) for F output frames."""
    L = -(-F // n_segments)
    return L, L * n_segments


def _to(obj, dev: torch.device):
    return dataclasses.replace(obj, **{
        f.name: None if getattr(obj, f.name) is None else getattr(obj, f.name).to(dev)
        for f in dataclasses.fields(obj)})


def emulate_chunk_segmented(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    tail_frames: torch.Tensor,
    tail_times: torch.Tensor,
    n_segments: int,
    warmup: int,
    mesh: Optional[Mesh] = None,
    draws: Optional[Draws] = None,
    tail_draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[EmulatorState, Dict[str, torch.Tensor]]:
    """The chunk in time segments (see the module note); what
    `emulate_chunk_apply` returns, on the frames' device.

    frames [F,H,W] and times f32[F] (chunk-relative) are preceded on the
    timeline by tail_frames [W+1,H,W] at tail_times f32[W+1] (the previous
    chunk's last W+1 frames; for the first chunk, the first frame W+1 times
    at its own time).  draws: the chunk's draws (by default drawn from
    `generator`); tail_draws: the previous chunk's last W frames of draws
    (by default zeros, right only for a first chunk's tail).  Segment s
    runs on device s of the mesh's devices (the frames' device without a
    mesh).
    """
    lead = frames.device
    F, H, W_px = frames.shape
    W, S = warmup, n_segments
    L, F_pad = _plan_segments(F, S)
    frames = frames.to(torch.float32)
    times = times.to(torch.float32)
    if draws is None:
        draws = draw_chunk_noise(cfg, F, (H, W_px), generator, lead)
    # pad the chunk's end with dt = 0 replays of its last frame
    ext = torch.cat([tail_frames.to(lead, torch.float32), frames,
                     frames[-1:].expand(F_pad - F, H, W_px)])
    ext_t = torch.cat([tail_times.to(lead, torch.float32), times, times[-1:].expand(F_pad - F)])
    ext_draws = {}
    for k, v in draws.items():
        if v is not None:
            tail = (torch.zeros((W, H, W_px), dtype=v.dtype, device=lead)
                    if tail_draws is None else tail_draws[k].to(lead))
            ext_draws[k] = torch.cat([tail, v, torch.zeros_like(v[:1]).expand(F_pad - F, H, W_px)])
        else:
            ext_draws[k] = None
    devices = list(mesh.devices.flat) if mesh is not None else [lead]

    # segment s: seed at ext[s*L], run ext[s*L+1 .. s*L+W+L], keep the last L
    starts = [s * L for s in range(S)]
    seeds = _segment_init_states(cfg, ext[starts], ext_t[starts])
    runs = []
    for s, (a, seed) in enumerate(zip(starts, seeds)):
        dev = devices[s % len(devices)]
        seg_draws = {k: None if v is None else v[a: a + W + L].to(dev)
                     for k, v in ext_draws.items()}
        runs.append(emulate_chunk_apply(
            cfg, _to(params, dev), _to(seed, dev), ext[a + 1: a + W + L + 1].to(dev),
            ext_t[a + 1: a + W + L + 1].to(dev), seg_draws))

    def merge(key, parts):
        if key == "states":
            return {n: merge(n, [p[n] for p in parts]) for n in parts[0]}
        return torch.cat([p[W:].to(lead) for p in parts])[:F]

    outs = {key: merge(key, [o[key] for _, o in runs]) for key in runs[0][1]}
    return _to(runs[-1][0], lead), outs


def emulate_and_compact_segmented(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    tail_frames: torch.Tensor,
    tail_times: torch.Tensor,
    n_segments: int,
    warmup: int,
    capacity: int,
    mesh: Optional[Mesh] = None,
    draws: Optional[Draws] = None,
    tail_draws: Optional[Draws] = None,
):
    """`emulate_chunk_segmented`, then the compaction: (state, outs,
    packed), the packed contract of core.emulate_and_compact_impl."""
    state, outs = emulate_chunk_segmented(
        cfg, params, state, frames, times, tail_frames, tail_times, n_segments, warmup,
        mesh, draws, tail_draws)
    return state, outs, pack_chunk(cfg, outs, capacity)


def shard_segment_inputs(mesh: Mesh, frames, times, tail_frames, tail_times):
    """The chunk's inputs on every distinct device of the mesh: a tuple of
    four dicts, device -> tensor (the JAX package replicates them over the
    mesh the same way)."""
    devices = list(dict.fromkeys(mesh.devices.flat))
    return tuple({d: x.to(d) for d in devices} for x in (frames, times, tail_frames, tail_times))


def dryrun_segments(n_devices: int, device=None) -> int:
    """A small segmented conversion over an n-segment 'seg' mesh
    (`make_segment_mesh(n_devices, device)`, segments taking the devices
    in turn); returns the total event count."""
    dev = resolve_device(device)
    mesh = make_segment_mesh(n_devices, device)
    cfg = EmulatorConfig(sigma_thres=0.03, shot_noise_rate_hz=1.0)
    rng = np.random.default_rng(0)
    F, H, W = 4 * n_devices, 16, 32
    frames = torch.from_numpy(rng.uniform(0, 255, (F + 1, H, W)).astype(np.float32)).to(dev)
    times = torch.arange(F + 1, dtype=torch.float32, device=dev) / 100.0
    gen = torch.Generator(device=dev).manual_seed(0)
    params, state = init_state(cfg, frames[0], 0.0, gen)
    warmup = 2
    _, outs = emulate_chunk_segmented(
        cfg, params, state, frames[1:], times[1:], frames[0].expand(warmup + 1, H, W),
        times[0].expand(warmup + 1), n_devices, warmup, mesh, generator=gen)
    assert tuple(outs["ev_count"].shape) == (F, H, W)
    return int((outs["num_on"] + outs["num_off"]).sum())
