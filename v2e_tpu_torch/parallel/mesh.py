"""Device meshes and the emulator's chunk in pixel strips (port of
v2e_tpu/parallel/mesh.py).

`Mesh` mirrors `jax.sharding.Mesh`: an array of devices (here
`torch.device`s) with axis names.  A mesh may name one device several
times (`make_mesh(4, device="cuda:0")`), as a JAX mesh may be built from
any device array: that is how one card runs several strips.  Conversion
stays one process; a strip is a set of tensors on its mesh device.

Pixel strips: the image rows split into S strips, one per device of the
mesh's `spatial` axis.  Each strip runs the chunk program
(`emulator.core.chunk_program`) on its rows: lin-log, the lowpass, leak
and shot noise, then the sequential core (K2 per strip when the refractory
period is 0; when it is positive, K1 on strips, one launch per strip that
exchanges each frame's K with the other strips in memory; the SciDVS loop
or the per-frame path otherwise).  The programs run in lock step, and
where one asks for a value of the whole plane `_drive` answers it: the
refractory core's request with one call of `refractory_scan_strips` for
all strips; SciDVS's per-frame K and the CSDVS surround on the lead device
(the mesh's first), each strip's value copied there (`.to`, ordered on the
devices' current streams), combined, and copied back.  The chunk's outputs
are gathered on the lead device in row order, so compaction, and with it
the event stream, equals the single-device run's.  The random draws are the whole plane's,
made on the lead device's generator; a strip takes its rows of them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from v2e_tpu_torch.device import resolve_device
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import (
    MAX,
    STRIPS,
    Draws,
    _update_csdvs,
    chunk_program,
    draw_chunk_noise,
)
from v2e_tpu_torch.emulator.state import EmulatorParams, EmulatorState
from v2e_tpu_torch.ops.kernels.emulator_scan import refractory_scan_strips


class Mesh:
    """Devices in an array with named axes (as `jax.sharding.Mesh`)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def lead(self) -> torch.device:
        """The first device: it holds the state between chunks and answers
        the strips' requests."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        index = tuple(slice(None) if i == k else 0 for i in range(self.devices.ndim))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def mesh_devices(n_devices: Optional[int] = None, device=None) -> List[torch.device]:
    """Devices for a mesh: the first `n_devices` visible CUDA cards (all of
    them by default, fewer if fewer are visible); for a device with an index
    ("cuda:0") or the CPU, that device `n_devices` times (once by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", i) for i in range(min(n_devices or count, count))]
    return [dev] * (n_devices or 1)


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, str] = ("data", "spatial"),
    device=None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A 2-D (data, spatial) mesh over `devices` (by default
    `mesh_devices(n_devices, device)`): with n devices the shape is
    (n // s, s), s the largest power of two up to 4 that divides n (the JAX
    package's rule)."""
    if devices is None:
        devices = mesh_devices(n_devices, device)
    n = len(devices)
    s = 1
    while s * 2 <= n and n % (s * 2) == 0 and s * 2 <= 4:
        s *= 2
    d = n // s
    return Mesh(np.array(devices[: d * s], dtype=object).reshape(d, s), axes)


def strip_bounds(n_rows: int, n_strips: int) -> List[Tuple[int, int]]:
    """Rows [a, b) of each strip: as even as can be, the earlier strips no
    larger (EmulatorConfig.pad_rows makes them equal)."""
    if n_strips > n_rows:
        raise ValueError(f"{n_rows} rows cannot split into {n_strips} strips")
    cuts = [s * n_rows // n_strips for s in range(n_strips + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _rows(x, a: int, b: int, dev: torch.device):
    """Rows [a, b) of a plane or stack of planes on `dev`; scalars copied."""
    if x is None:
        return None
    if x.ndim >= 2:
        return x[..., a:b, :].to(dev).contiguous()
    return x.to(dev)


def _split_dataclass(obj, a: int, b: int, dev: torch.device):
    return dataclasses.replace(obj, **{
        f.name: _rows(getattr(obj, f.name), a, b, dev) for f in dataclasses.fields(obj)})


def shard_emulator_args(
    mesh: Mesh,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    draws: Optional[Draws] = None,
):
    """Place the emulator's inputs on the mesh in row strips, one per device
    of its `spatial` axis, scalars and times copied to each.

    Where the JAX package returns sharded global arrays, this returns the
    pieces: a list with one (params, state, frames, times, draws) per
    strip, each on its device (draws None when not given).
    """
    devices = mesh.axis_devices("spatial")
    out = []
    for (a, b), dev in zip(strip_bounds(frames.shape[-2], len(devices)), devices):
        out.append((
            _split_dataclass(params, a, b, dev),
            _split_dataclass(state, a, b, dev),
            _rows(frames, a, b, dev),
            times.to(dev),
            None if draws is None else {k: _rows(v, a, b, dev) for k, v in draws.items()},
        ))
    return out


def _drive(cfg: EmulatorConfig, lead: torch.device, programs, bounds, devices):
    """Run one chunk program per strip in lock step, answering each request
    across the strips (see the module note); returns the programs'
    results."""
    answers = [None] * len(programs)
    while True:
        requests, results = [], []
        for program, answer in zip(programs, answers):
            try:
                requests.append(program.send(answer))
            except StopIteration as stop:
                results.append(stop.value)
        if (results and requests) or len({r[0] for r in requests}) > 1:
            raise RuntimeError("the strips' programs went out of step")
        if results:
            return results
        if requests[0][0] == STRIPS:  # K1 on every strip, one launch each
            answers = refractory_scan_strips([r[1] for r in requests])
        elif requests[0][0] == MAX:
            m = torch.stack([r[1].to(lead) for r in requests]).amax(dim=0)
            answers = [m.to(d) for d in devices]
        else:  # SURROUND: the plane's surround, solved on the lead device
            lp = torch.cat([r[1].to(lead) for r in requests])
            cs = torch.cat([r[2].to(lead) for r in requests])
            h = _update_csdvs(cfg, lp, cs, requests[0][3].to(lead))
            answers = [h[a:b].to(d) for (a, b), d in zip(bounds, devices)]


def _gather_outs(results, lead: torch.device) -> Dict:
    """The strips' outputs as the whole plane's, on `lead`: maps joined
    along their rows in strip order, event totals summed, per-frame scalars
    (the same in every strip) from the first strip, the probe from the
    strip that holds its pixel."""
    outs = {}
    for key, first in results[0].items():
        parts = [r[key] for r in results if key in r]
        if key == "states":
            outs[key] = {n: torch.cat([p[n].to(lead) for p in parts], dim=1) for n in first}
        elif key in ("num_on", "num_off"):
            outs[key] = sum(p.to(lead) for p in parts)
        elif first.ndim == 3:  # [F,h,W] maps
            outs[key] = torch.cat([p.to(lead) for p in parts], dim=1)
        else:
            outs[key] = first.to(lead)
    for r in results[1:]:  # the probe's pixel may lie in a later strip
        if "probe" in r:
            outs["probe"] = r["probe"].to(lead)
    return outs


def _gather_state(state: EmulatorState, states, lead: torch.device) -> EmulatorState:
    def join(name):
        first = getattr(states[0], name)
        if first is None or first.ndim < 2:
            return None if first is None else first.to(lead)
        return torch.cat([getattr(s, name).to(lead) for s in states])

    return dataclasses.replace(state, **{f.name: join(f.name) for f in dataclasses.fields(state)})


def emulate_chunk_sharded(
    cfg: EmulatorConfig,
    mesh: Mesh,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
):
    """The emulator's chunk with the pixel plane in row strips over the
    mesh's `spatial` axis (see the module note); what
    `emulator.core.emulate_chunk` returns, on the lead device.

    params, state, frames [F,H,W] and times [F] are the whole plane's.
    draws: the chunk's random draws (`draw_chunk_noise`), by default drawn
    from `generator` on the frames' device.  K1 on strips runs even when
    every strip lies on one device, and a mesh of one strip gives K1's own
    result.
    """
    lead = mesh.lead
    frames = frames.to(torch.float32)
    if draws is None:
        draws = draw_chunk_noise(cfg, frames.shape[0], tuple(frames.shape[1:]), generator,
                                 frames.device)
    devices = mesh.axis_devices("spatial")
    bounds = strip_bounds(frames.shape[1], len(devices))
    pieces = shard_emulator_args(mesh, params, state, frames, times, draws)
    programs = [chunk_program(cfg, *piece, row0=a, split=True)
                for (a, _), piece in zip(bounds, pieces)]
    results = _drive(cfg, lead, programs, bounds, devices)
    new_state = _gather_state(state, [r[0] for r in results], lead)
    return new_state, _gather_outs([r[1] for r in results], lead)
