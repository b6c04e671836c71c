"""The emulator's chunk evaluation and sparse compaction (port of
v2e_tpu/emulator/core.py).

A chunk is split in two steps:

* `draw_chunk_noise`: every random draw of the chunk (leak jitter normals,
  shot-noise uniforms, injected photoreceptor-noise normals) from a
  `torch.Generator`;
* `emulate_chunk_apply`: the deterministic model given those draws.  Two
  ways through it, chosen as the JAX package chooses them:
  - the fast path: lin-log, the photoreceptor IIR lowpass, leak deltas and
    shot-noise maps for the whole chunk, then the sequential core: kernel
    K2 (`scan`) when the refractory period is 0, kernel K1
    (`refractory_scan`) when it is positive, and for the SciDVS pixel a
    plain loop over the frames (`_scidvs_core`), as the JAX package sends
    SciDVS to its XLA scan and never to a Pallas kernel;
  - the per-frame path (`emulator_step` over each frame) when the
    center-surround (CSDVS) pixel, the single-pixel probe or the
    model-state frames are asked for.  It launches no kernel: a plain
    loop of small PyTorch operations per frame, with the CSDVS surround
    solved exactly in the DCT-II basis (`_update_csdvs`).

Frame f of a chunk takes frame f of the chunk's draws on both paths, so
tests hand the apply step the draws the JAX package made and compare both
packages event for event.

Both paths are written as chunk programs (`chunk_program`, a generator):
where a value couples the whole pixel plane (a frame's largest count K,
the CSDVS surround) the program yields a request and goes on with the
answer.  On one device `run_local` answers each request from the
program's own plane.  Under pixel strips (parallel/mesh.py) one program
runs per strip, in lock step, and each request is answered across the
strips (`parallel.mesh._drive`), so a strip computes what the same rows of
the whole plane compute: the refractory core is one request per chunk,
which one call of `refractory_scan_strips` answers for every strip (the
frames' K exchanged inside its kernels); SciDVS's K per frame and the
CSDVS surround are answered on the lead device.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from v2e_tpu_torch import tracing
from v2e_tpu_torch.device import scalar
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.state import EmulatorParams, EmulatorState
from v2e_tpu_torch.ops.core import (
    I32_MAX_F,
    compute_event_map,
    fma_f32,
    generate_shot_noise,
    lin_log,
    low_pass_filter,
    refractory_filter,
    rescale_intensity_frame,
    subtract_leak_current,
)
from v2e_tpu_torch.ops.kernels.emulator_scan import (
    refractory_scan,
    refractory_scan_strips,
    scan,
)

Draws = Dict[str, Optional[torch.Tensor]]

# The CSDVS Euler diffuser's stop test and step limits (the JAX package's)
CS_MAX_CHANGE = 1e-5
CS_NUM_STEPS_PER_TAU = 5
CS_MAX_STEPS = 1000
# Euler steps run between two host reads of the stop test
CS_STEPS_PER_READ = 16

# The requests a chunk program yields (see the module note):
# (MAX, local maxima) -> the plane's maxima, same shape;
# (SURROUND, lp, surround, dt) -> the plane's surround after dt (`_update_csdvs`);
# (STRIPS, args) -> K1 on the program's rows with K over the whole plane:
#   what `refractory_scan(*args)` returns for those rows, answered for all
#   strips at once by `refractory_scan_strips`.
MAX = "max"
SURROUND = "surround"
STRIPS = "strips"


def run_local(cfg: EmulatorConfig, program):
    """Run a chunk program on one plane, answering its requests from the
    plane itself; returns the program's result."""
    answer = None
    while True:
        try:
            request = program.send(answer)
        except StopIteration as stop:
            return stop.value
        if request[0] == MAX:
            answer = request[1]
        elif request[0] == STRIPS:  # a lone strip
            answer = refractory_scan_strips([request[1]])[0]
        else:
            answer = _update_csdvs(cfg, *request[1:])


def _logical_shape(cfg: EmulatorConfig, shape) -> Tuple[int, int]:
    """The pixel plane's shape without its pad rows (EmulatorConfig.pad_rows)."""
    return (shape[0] - cfg.pad_rows, shape[1])


def _pad_plane(cfg: EmulatorConfig, x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """Append cfg.pad_rows rows of `value` to the second-to-last axis."""
    if cfg.pad_rows == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, cfg.pad_rows), value=value)


def _slice_logical(cfg: EmulatorConfig, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Drop the pad rows (the inverse of `_pad_plane`)."""
    if cfg.pad_rows == 0 or x is None:
        return x
    return x[..., : x.shape[-2] - cfg.pad_rows, :]


def _csdvs_taus(cfg: EmulatorConfig) -> Tuple[float, float]:
    """Photoreceptor and horizontal-cell time constants in seconds, with
    the zero-tau floor of the original v2e."""
    abs_min_tau_p = 1e-9
    tau_p = (
        abs_min_tau_p
        if (cfg.cs_tau_p_ms is None or cfg.cs_tau_p_ms == 0)
        else cfg.cs_tau_p_ms * 1e-3
    )
    tau_h = (
        abs_min_tau_p / (cfg.cs_lambda_pixels**2)
        if cfg.cs_tau_h_ms == 0
        else cfg.cs_tau_h_ms * 1e-3
    )
    return tau_p, tau_h


@functools.lru_cache(maxsize=16)
def _dct_plan(h: int, w: int, tau_p: float, tau_h: float, device: torch.device):
    """float64 orthonormal DCT-II bases of an [h,w] plane and the modes'
    relaxation constants: (C_h, C_w, a, g) with ``dct2(x) = C_h x C_w^T``,
    ``a = 1/tau_p + lam/tau_h`` and the steady-state gain
    ``g = 1/(1 + lam tau_p/tau_h)``, lam the 5-point Laplacian's negated
    eigenvalue under zero-flux edges."""

    def basis(n: int) -> np.ndarray:
        k = np.arange(n)[:, None]
        c = np.cos(np.pi * (2 * np.arange(n)[None, :] + 1) * k / (2.0 * n))
        c *= np.sqrt(2.0 / n)
        c[0] /= np.sqrt(2.0)
        return c

    si = np.sin(np.pi * np.arange(h) / (2.0 * h)) ** 2
    sj = np.sin(np.pi * np.arange(w) / (2.0 * w)) ** 2
    lam = 4.0 * (si[:, None] + sj[None, :])
    a = 1.0 / tau_p + lam / tau_h
    g = 1.0 / (1.0 + lam * (tau_p / tau_h))
    return tuple(torch.from_numpy(x).to(device) for x in (basis(h), basis(w), a, g))


def _update_csdvs(
    cfg: EmulatorConfig,
    lp_log_frame: torch.Tensor,
    cs_surround_frame: torch.Tensor,
    delta_time: torch.Tensor,
) -> torch.Tensor:
    """Advance the horizontal-cell diffuser by ``delta_time``, exactly.

    ``dh/dt = (p - h)/tau_p + lap(h)/tau_h`` with a zero-flux (replicated
    edge) 5-point Laplacian is diagonal in the DCT-II basis, so each mode
    relaxes in closed form: ``h_hat(dt) = hss_hat + exp(-a dt) (h0_hat -
    hss_hat)``, ``hss_hat = g p_hat``.  The JAX package takes the DCT with
    an FFT in float32; PyTorch has none, so the transform here is a product
    with the basis matrices, in float64 (no TF32 setting can touch it), and
    the result is rounded to float32 once.
    """
    if cfg.csdvs_solver == "euler":
        return _update_csdvs_euler(cfg, lp_log_frame, cs_surround_frame, delta_time)
    H, W = lp_log_frame.shape
    ch, cw, a, g = _dct_plan(H, W, *_csdvs_taus(cfg), lp_log_frame.device)
    p_hat = ch @ lp_log_frame.double() @ cw.T
    h_hat = ch @ cs_surround_frame.double() @ cw.T
    hss_hat = g * p_hat
    decay = torch.exp(-delta_time.double() * a)
    return (ch.T @ (hss_hat + decay * (h_hat - hss_hat)) @ cw).float()


def _laplacian(h: torch.Tensor) -> torch.Tensor:
    """The 5-point Laplacian with replicated edges."""
    hp = torch.nn.functional.pad(h[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return hp[:-2, 1:-1] + hp[1:-1, :-2] + -4.0 * h + hp[1:-1, 2:] + hp[2:, 1:-1]


def _update_csdvs_euler(
    cfg: EmulatorConfig,
    lp_log_frame: torch.Tensor,
    cs_surround_frame: torch.Tensor,
    delta_time: torch.Tensor,
) -> torch.Tensor:
    """Euler-step the diffuser toward its steady state (``csdvs_solver =
    "euler"``): at most CS_MAX_STEPS steps, and none after the largest
    update falls to CS_MAX_CHANGE.  The step count derives from the
    uncapped count, so a capped run lags rather than oscillates.

    The JAX package's `lax.while_loop` tests its stop condition before
    every step.  Here steps run in blocks of CS_STEPS_PER_READ on the
    device, each masked by the same condition, and the host reads the
    condition once per block: the steps past the stop change nothing.
    """
    tau_p, tau_h = _csdvs_taus(cfg)
    min_tau = min(tau_p, tau_h)
    f32 = torch.float32
    p = lp_log_frame
    dt = delta_time.to(f32)
    num_steps = torch.ceil((dt / scalar(min_tau, p)) * CS_NUM_STEPS_PER_TAU)
    # saturate before the cast (a zero tau gives counts past 2^31)
    num_steps = torch.clamp(num_steps, max=I32_MAX_F).to(torch.int32)
    num_steps = torch.clamp(num_steps, 1, CS_MAX_STEPS)
    actual_dt = torch.minimum(
        dt / num_steps.to(f32), scalar(min_tau / CS_NUM_STEPS_PER_TAU, p)
    )
    alpha_p = actual_dt / scalar(tau_p, p)
    alpha_h = actual_dt / scalar(tau_h, p)
    h = cs_surround_frame
    steps = torch.zeros((), dtype=torch.int32, device=p.device)
    max_change = scalar(2 * CS_MAX_CHANGE, p)
    limit = scalar(CS_MAX_CHANGE, p)
    for _ in range(0, CS_MAX_STEPS, CS_STEPS_PER_READ):
        for _ in range(CS_STEPS_PER_READ):
            go = (steps < num_steps) & (max_change > limit)
            change = alpha_p * (p - h) + alpha_h * _laplacian(h)
            h = torch.where(go, h + change, h)
            max_change = torch.where(go, change.abs().max(), max_change)
            steps = steps + go.to(torch.int32)
        if not bool((steps < num_steps) & (max_change > limit)):
            break
    return h


def _scidvs_dvdt(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """SciDVS highpass decay rate: a sinh conductance."""
    efold = 1.0 / 0.7
    return (1.0 / tau) * torch.sinh(v / scalar(efold, v))


def _scidvs_highpass(
    hp: torch.Tensor, lp: torch.Tensor, lp_prev: torch.Tensor, dt: torch.Tensor,
    tau: torch.Tensor,
) -> torch.Tensor:
    """One frame of the SciDVS highpass: ``hp + (lp - lp_prev) - dt *
    dvdt(hp)``."""
    return hp + (lp - lp_prev) - dt * _scidvs_dvdt(hp, tau)


def _emit(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    diff: torch.Tensor,
    base: torch.Tensor,
    mem: torch.Tensor,
    dt: torch.Tensor,
    t_prev: torch.Tensor,
):
    """Quantize one frame's ``diff`` into events, pass them through the
    refractory filter and move the memorized base by the emitted events.

    A program step: K, the frame's largest count over the whole plane, is
    a MAX request.  Returns (final_pos, final_neg, i0, stride, K, new_mem,
    new_base); the base update is one float32 multiply-add, as XLA
    contracts it.
    """
    pos_evts, neg_evts = compute_event_map(diff, params.pos_thres, params.neg_thres)
    count = pos_evts + neg_evts  # disjoint per pixel (diff has one sign)
    K = yield (MAX, count.max())
    ts_step = torch.maximum(dt, scalar(1e-12, dt)) / torch.clamp(K, min=1).to(torch.float32)
    if cfg.refractory_period_s > 0:
        n_emit, i0, stride, mem = refractory_filter(
            count, mem, t_prev, ts_step, cfg.refractory_period_s
        )
    else:
        n_emit, i0 = count, torch.zeros_like(count)
        stride = torch.ones((), dtype=torch.int32, device=diff.device)
    final_pos = torch.where(pos_evts > 0, n_emit, 0)
    final_neg = torch.where(neg_evts > 0, n_emit, 0)
    base = fma_f32(final_pos.to(torch.float32), params.pos_thres, base)
    base = fma_f32(-final_neg.to(torch.float32), params.neg_thres, base)
    return final_pos, final_neg, i0, stride, K, mem, base


def draw_chunk_noise(
    cfg: EmulatorConfig, n_frames: int, shape, generator: torch.Generator,
    device: torch.device,
) -> Draws:
    """All random numbers one chunk of `n_frames` frames of `shape`
    consumes.  They are drawn at the logical shape (without cfg.pad_rows),
    so a padded run draws what an unpadded one draws, and padded with inert
    values: leak and photoreceptor normals with 0, where the noise rates
    are 0 anyway, and shot uniforms with 0.5, which fires neither side of
    a pad pixel's shot noise (ON needs u > 1 - p, OFF u < p, and there p
    is the frame's shot factor over the pad's threshold of 1e9)."""
    full = (n_frames, *_logical_shape(cfg, shape))

    def normal():
        return _pad_plane(cfg, torch.randn(full, generator=generator, device=device))

    return {
        "leak": normal() if cfg.leak_rate_hz > 0 else None,
        "shot": _pad_plane(cfg, torch.rand(full, generator=generator, device=device), 0.5)
        if cfg.simple_shot_noise else None,
        "photoreceptor": normal() if cfg.photoreceptor_noise else None,
    }


def linear_iir(init: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[f] = a[f] * y[f-1] + b[f] over the leading axis, y[-1] = init.

    The JAX package solves this recurrence with an associative scan; the
    sequential form here rounds differently by a few ulp."""
    out = torch.empty_like(b)
    y = init
    for f in range(b.shape[0]):
        y = a[f] * y + b[f]
        out[f] = y
    return out


def emulator_step(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    new_frame: torch.Tensor,
    t_frame: torch.Tensor,
    draws: Draws,
) -> Tuple[EmulatorState, Dict[str, torch.Tensor]]:
    """One inter-frame step of the full pixel model (the JAX package's
    `emulator_step`): lin-log, the lowpass, injected photoreceptor noise,
    the CSDVS surround, the SciDVS highpass, leak, events through the
    refractory filter, shot noise.

    new_frame: [H,W] linear 0-255 intensity (HDR log if cfg.hdr); t_frame:
    f32 chunk-relative frame time; draws: this frame's leak normals, shot
    uniforms and photoreceptor normals, [H,W] each (None where unused).
    Returns (new state, out) with out's per-frame maps and scalars, the
    probe's 9 values when cfg.probe is set and the `states` frames named
    in cfg.emit_states.
    """
    return run_local(cfg, step_program(cfg, params, state, new_frame, t_frame, draws))


def step_program(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    new_frame: torch.Tensor,
    t_frame: torch.Tensor,
    draws: Draws,
    row0: int = 0,
):
    """`emulator_step` as a program (see the module note) on rows
    [row0, row0 + h) of the plane: the surround is a SURROUND request and
    K a MAX request.  Only the rows that hold the probe's pixel record it.
    """
    delta_time = t_frame - state.t_prev
    new_frame = new_frame.to(torch.float32)
    log_new = new_frame if cfg.hdr else lin_log(new_frame)
    inten01 = rescale_intensity_frame(new_frame) if cfg.needs_inten01 else None
    lp = low_pass_filter(log_new, state.lp_log_frame, inten01, delta_time, cfg.cutoff_hz)

    pr_noise = state.photoreceptor_noise_arr
    if cfg.photoreceptor_noise:
        noise = params.photoreceptor_noise_vrms * draws["photoreceptor"]
        pr_noise = low_pass_filter(noise, pr_noise, None, delta_time, cfg.cutoff_hz)

    cs_surround = state.cs_surround_frame
    if cfg.csdvs_enabled:
        cs_surround = yield (SURROUND, lp, cs_surround, delta_time)

    hp, lp_prev = state.scidvs_highpass, state.scidvs_previous_photo
    if cfg.scidvs:
        hp = _scidvs_highpass(hp, lp, lp_prev, delta_time, params.scidvs_tau_arr)
        lp_prev = lp

    base = state.base_log_frame
    if cfg.leak_rate_hz > 0:
        base = subtract_leak_current(
            base, cfg.leak_rate_hz, delta_time, params.pos_thres,
            cfg.leak_jitter_fraction, params.noise_rate_array, draws["leak"],
        )

    photoreceptor = cfg.scidvs_gain * hp if cfg.scidvs else lp
    if cfg.csdvs_enabled:
        c_minus_s = photoreceptor + pr_noise - cs_surround
        diff = c_minus_s - base
    else:
        diff = photoreceptor + pr_noise - base

    final_pos, final_neg, i0, stride, K, new_mem, base = yield from _emit(
        cfg, params, diff, base, state.timestamp_mem, delta_time, state.t_prev
    )
    out: Dict[str, torch.Tensor] = {}
    num_on = final_pos.sum()
    num_off = final_neg.sum()
    if cfg.simple_shot_noise:
        shot_on, shot_off = generate_shot_noise(
            draws["shot"], cfg.shot_noise_rate_hz, delta_time,
            cfg.shot_noise_inten_factor, inten01,
            params.pos_thres_pre_prob, params.neg_thres_pre_prob,
        )
        # shot events reset the pixel memory to the photoreceptor value
        base = torch.where(shot_on | shot_off, lp, base)
        out["shot_on"] = shot_on
        out["shot_off"] = shot_off
        num_on = num_on + shot_on.sum()
        num_off = num_off + shot_off.sum()

    if cfg.probe is not None and 0 <= cfg.probe[1] - row0 < new_frame.shape[0]:
        px, py = cfg.probe[0], cfg.probe[1] - row0  # (x, y) in these rows
        out["probe"] = torch.stack([
            new_frame[py, px],
            base[py, px],  # after this frame's update
            lp[py, px],
            log_new[py, px],
            params.pos_thres[py, px],
            params.neg_thres[py, px],
            diff[py, px],
            final_neg[py, px].to(torch.float32),
            final_pos[py, px].to(torch.float32),
        ])

    if cfg.emit_states:
        available = {
            "new_frame": new_frame,
            "log_new_frame": log_new,
            "lp_log_frame": lp,
            "photoreceptor_noise_arr": pr_noise,
            "base_log_frame": base,
            "diff_frame": diff,
        }
        if cfg.scidvs:
            available["scidvs_highpass"] = hp
        if cfg.csdvs_enabled:
            available["cs_surround_frame"] = cs_surround
            available["c_minus_s_frame"] = c_minus_s
        out["states"] = {
            name: available[name] for name in cfg.emit_states if name in available
        }

    out.update(
        ev_count=(final_pos - final_neg).to(torch.int16),
        i0=i0.to(torch.int16),
        stride=stride,
        K=K,
        t_prev=state.t_prev,
        t_frame=t_frame,
        num_on=num_on.to(torch.int32),
        num_off=num_off.to(torch.int32),
    )
    new_state = dataclasses.replace(
        state,
        base_log_frame=base,
        lp_log_frame=lp,
        photoreceptor_noise_arr=pr_noise,
        timestamp_mem=new_mem,
        t_prev=t_frame,
        scidvs_highpass=hp,
        scidvs_previous_photo=lp_prev,
        cs_surround_frame=cs_surround,
    )
    return new_state, out


def _stack_outs(steps):
    """Stack the per-frame outputs of `emulator_step` on a leading F axis."""
    outs = {}
    for key, first in steps[0].items():
        if key == "states":
            outs[key] = {
                name: torch.stack([s[key][name] for s in steps]) for name in first
            }
        else:
            outs[key] = torch.stack([s[key] for s in steps])
    return outs


def _chunk_steps(cfg, params, state, frames, times, draws, row0):
    """The per-frame path as a program: `step_program` over each frame of
    the chunk, frame f taking frame f of the chunk's draws."""
    steps = []
    for f in range(frames.shape[0]):
        frame_draws = {k: (None if v is None else v[f]) for k, v in draws.items()}
        state, out = yield from step_program(
            cfg, params, state, frames[f], times[f], frame_draws, row0)
        steps.append(out)
    return state, _stack_outs(steps)


def _scidvs_core(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    lp: torch.Tensor,
    pr_noise: Optional[torch.Tensor],
    leak_delta: Optional[torch.Tensor],
    shot_any: Optional[torch.Tensor],
    dts: torch.Tensor,
    t_prevs: torch.Tensor,
):
    """The fast path's sequential core for the SciDVS pixel, a loop over
    the frames (the JAX package's XLA scan body, core.py:931-973; SciDVS
    never reaches K1 or K2 there, nor here), as a program: each frame's K
    is a MAX request.

    Returns (new_base, new_mem, highpass, previous photoreceptor, signed
    counts i16[F,H,W], i0 i16[F,H,W], stride i32[F], K i32[F]).
    """
    F = lp.shape[0]
    base, mem = state.base_log_frame, state.timestamp_mem
    hp, lp_prev = state.scidvs_highpass, state.scidvs_previous_photo
    counts = torch.empty(lp.shape, dtype=torch.int16, device=lp.device)
    i0s = torch.empty_like(counts)
    strides = torch.empty(F, dtype=torch.int32, device=lp.device)
    Ks = torch.empty_like(strides)
    for f in range(F):
        if leak_delta is not None:
            base = base - leak_delta[f]
        hp = _scidvs_highpass(hp, lp[f], lp_prev, dts[f], params.scidvs_tau_arr)
        lp_prev = lp[f]
        diff = cfg.scidvs_gain * hp
        if pr_noise is not None:
            diff = diff + pr_noise[f]
        diff = diff - base
        final_pos, final_neg, i0, stride, K, mem, base = yield from _emit(
            cfg, params, diff, base, mem, dts[f], t_prevs[f]
        )
        if shot_any is not None:
            base = torch.where(shot_any[f] != 0, lp[f], base)
        counts[f] = (final_pos - final_neg).to(torch.int16)
        i0s[f] = i0.to(torch.int16)
        strides[f] = stride
        Ks[f] = K
    return base, mem, hp, lp_prev, counts, i0s, strides, Ks


def emulate_chunk_apply(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    draws: Draws,
) -> Tuple[EmulatorState, Dict[str, torch.Tensor]]:
    """Evaluate F frames given the chunk's draws.

    frames: [F,H,W] linear 0-255 intensity (HDR log if cfg.hdr); times:
    f32[F] chunk-relative, strictly increasing, times[0] > state.t_prev.
    Returns (new state, per-frame outputs stacked on a leading F axis).
    CSDVS, the probe and the state frames take the per-frame path
    (`emulator_step`), everything else the fast path.
    """
    return run_local(cfg, chunk_program(cfg, params, state, frames, times, draws))


def chunk_program(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    draws: Draws,
    row0: int = 0,
    split: bool = False,
):
    """`emulate_chunk_apply` as a program (see the module note) on rows
    [row0, row0 + h) of the plane.  With `split` the refractory core is
    one STRIPS request, K1 with each frame's K taken over every strip (what
    pixel strips run); without it, K1 itself, whose K spans only the
    program's own rows.
    """
    frames = frames.to(torch.float32)
    times = times.to(torch.float32)
    if cfg.per_frame:
        return (yield from _chunk_steps(cfg, params, state, frames, times, draws, row0))
    with tracing.span("emulator.precore", tracing.DEVICE, frames.device):
        dts = torch.diff(times, prepend=state.t_prev.reshape(1))
        t_prevs = times - dts
        dts3 = dts[:, None, None]

        log_new = frames if cfg.hdr else lin_log(frames)
        inten01 = rescale_intensity_frame(frames) if cfg.needs_inten01 else None

        if cfg.cutoff_hz > 0:
            tau = scalar(1.0 / (math.pi * 2 * cfg.cutoff_hz), frames)
            eps = torch.clamp(inten01 * (dts3 / tau), max=1.0)
            lp = linear_iir(state.lp_log_frame, 1.0 - eps, eps * log_new)
        else:
            lp = log_new

        pr_last = state.photoreceptor_noise_arr
        lp_eff = lp
        pr_noise = None
        if cfg.photoreceptor_noise:
            tau = scalar(1.0 / (math.pi * 2 * cfg.cutoff_hz), frames)
            noise = params.photoreceptor_noise_vrms * draws["photoreceptor"]
            eps_n = (dts / tau)[:, None, None] * torch.ones_like(frames[0])
            pr_noise = linear_iir(pr_last, 1.0 - eps_n, eps_n * noise)
            pr_last = pr_noise[-1]
            lp_eff = lp + pr_noise

        leak_delta = None
        if cfg.leak_rate_hz > 0:
            leak_delta = (
                dts3
                * (cfg.leak_rate_hz * params.noise_rate_array)
                * (1.0 - cfg.leak_jitter_fraction * draws["leak"])
                * params.pos_thres
            )

        shot_on = shot_off = shot_any = None
        if cfg.simple_shot_noise:
            shot_on, shot_off = generate_shot_noise(
                draws["shot"], cfg.shot_noise_rate_hz, dts3,
                cfg.shot_noise_inten_factor, inten01,
                params.pos_thres_pre_prob, params.neg_thres_pre_prob,
            )
            shot_any = (shot_on | shot_off).to(torch.uint8)

        lp_eff = lp_eff.contiguous()
        pos_th = params.pos_thres.contiguous()
        neg_th = params.neg_thres.contiguous()
        base = state.base_log_frame.contiguous()
    scidvs_state = {}
    if cfg.scidvs:
        new_base, new_mem, hp, lp_prev, signed16, i0_16, stride, K = yield from _scidvs_core(
            cfg, params, state, lp, pr_noise, leak_delta, shot_any, dts, t_prevs
        )
        scidvs_state = dict(scidvs_highpass=hp, scidvs_previous_photo=lp_prev)
    elif cfg.refractory_period_s <= 0:
        # the JAX package's refractory-free branch (core.py:832-866)
        new_base, signed16 = scan(lp_eff, leak_delta, shot_any, pos_th, neg_th, base)
        new_mem = state.timestamp_mem
        K = yield (MAX, signed16.to(torch.int32).abs().amax(dim=(1, 2)))
        i0_16 = torch.zeros_like(signed16)
        stride = torch.ones_like(K)
    else:
        args = (lp_eff, leak_delta, shot_any, pos_th, neg_th, base,
                state.timestamp_mem.contiguous(), dts.contiguous(),
                t_prevs.contiguous(), float(cfg.refractory_period_s))
        if split:
            new_base, new_mem, signed16, i0_16, K = yield (STRIPS, args)
        else:
            new_base, new_mem, signed16, i0_16, K = refractory_scan(*args)
        # per-frame stride from K, the formula of the refractory filter
        R = scalar(cfg.refractory_period_s, frames)
        ts_step = torch.maximum(dts, scalar(1e-12, dts)) / torch.clamp(K, min=1).to(torch.float32)
        m = (torch.floor(R / ts_step) + 1.0).to(torch.int32)
        stride = torch.where(R > ts_step, m, 1)
    signed = signed16.to(torch.int32)
    num_on = torch.clamp(signed, min=0).sum(dim=(1, 2))
    num_off = torch.clamp(-signed, min=0).sum(dim=(1, 2))
    outs = {"ev_count": signed16, "i0": i0_16, "stride": stride, "K": K}
    if shot_on is not None:
        num_on = num_on + shot_on.sum(dim=(1, 2))
        num_off = num_off + shot_off.sum(dim=(1, 2))
        outs["shot_on"] = shot_on
        outs["shot_off"] = shot_off
    outs.update(t_prev=t_prevs, t_frame=times, num_on=num_on, num_off=num_off)
    new_state = dataclasses.replace(
        state,
        base_log_frame=new_base,
        lp_log_frame=lp[-1],
        photoreceptor_noise_arr=pr_last,
        timestamp_mem=new_mem,
        t_prev=times[-1],
        **scidvs_state,
    )
    return new_state, outs


def emulate_chunk(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    generator: Optional[torch.Generator] = None,
) -> Tuple[EmulatorState, Dict[str, torch.Tensor]]:
    """Evaluate a chunk of frames [F,H,W] at chunk-relative times [F]: the
    chunk's noise drawn from `generator` (on the frames' device; None takes
    torch's default generator), then `emulate_chunk_apply`.  The JAX
    package's `emulate_chunk` draws from the key in its state instead."""
    draws = draw_chunk_noise(cfg, frames.shape[0], tuple(frames.shape[1:]),
                             generator, frames.device)
    return emulate_chunk_apply(cfg, params, state, frames, times, draws)


def count_occupied(cfg: EmulatorConfig, outs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Number of (frame, pixel) cells carrying any event."""
    return _occupancy(cfg, outs).sum(dtype=torch.int32)


def _occupancy(cfg: EmulatorConfig, outs: Dict[str, torch.Tensor]) -> torch.Tensor:
    occ = outs["ev_count"].reshape(-1) != 0
    if cfg.simple_shot_noise:
        occ = occ | outs["shot_on"].reshape(-1) | outs["shot_off"].reshape(-1)
    return occ


def select_occupied(occ: torch.Tensor, capacity: int) -> torch.Tensor:
    """i32[capacity]: the indices of the first `capacity` True entries of
    the flat mask `occ`, ascending, then occ.numel() in the unused slots;
    torch.nonzero(occ)[:capacity] padded, with no wait for the device (the
    output's size does not depend on the data).  Slot k holds the first
    index at which the running count of True entries reaches k + 1."""
    running = torch.cumsum(occ, 0, dtype=torch.int32)
    wanted = torch.arange(1, capacity + 1, dtype=torch.int32, device=occ.device)
    return torch.searchsorted(running, wanted, out_int32=True)


def compact_chunk(
    cfg: EmulatorConfig, outs: Dict[str, torch.Tensor], capacity: int
) -> Dict[str, torch.Tensor]:
    """Gather the occupied cells of the dense per-frame maps:

      idx   i32[C]  flat cell index (frame*H*W + row*W + col), ascending
      count i16[C]  signed post-refractory event count
      i0    i16[C]  first emitted sub-frame iteration
      shot  u8[C]   bit0 = shot ON, bit1 = shot OFF

    The first `capacity` occupied cells in index order; entries beyond the
    occupancy are zero with idx == F*H*W (the JAX package's top-k select
    gives the same, overflow included).
    """
    cnt = outs["ev_count"].reshape(-1)
    total = cnt.shape[0]
    idx = select_occupied(_occupancy(cfg, outs), capacity)
    valid = idx < total
    safe = torch.clamp(idx, max=total - 1).to(torch.int64)
    out = {
        "idx": idx,
        "count": torch.where(valid, cnt[safe], 0).to(torch.int16),
        "i0": torch.where(valid, outs["i0"].reshape(-1)[safe], 0).to(torch.int16),
    }
    if cfg.simple_shot_noise:
        on = outs["shot_on"].reshape(-1)[safe].to(torch.uint8)
        off = outs["shot_off"].reshape(-1)[safe].to(torch.uint8)
        out["shot"] = torch.where(valid, on | (off << 1), 0).to(torch.uint8)
    return out


def emulate_and_compact_impl(
    cfg: EmulatorConfig,
    params: EmulatorParams,
    state: EmulatorState,
    frames: torch.Tensor,
    times: torch.Tensor,
    capacity: int,
    draws: Draws,
):
    """One chunk: apply + compaction.  Returns (state, outs, packed) with
    packed = {"scalars": i32 buffer of every per-frame scalar and the
    occupancy (`unpack_scalars`), "sparse": `compact_chunk`'s arrays, and
    "probe": f32[F,9] when cfg.probe is set}; the state frames stay in
    outs["states"]."""
    state, outs = emulate_chunk_apply(cfg, params, state, frames, times, draws)
    return state, outs, pack_chunk(cfg, outs, capacity)


def pack_chunk(cfg: EmulatorConfig, outs: Dict[str, torch.Tensor], capacity: int) -> Dict:
    """A chunk's outputs packed for the host (see `emulate_and_compact_impl`)."""
    with tracing.span("emulator.compact", tracing.DEVICE, outs["ev_count"].device):
        sparse = compact_chunk(cfg, outs, capacity)
        n_occ = count_occupied(cfg, outs)
        scalars = torch.cat(
            [
                outs["stride"].to(torch.int32),
                outs["K"].to(torch.int32),
                outs["num_on"].to(torch.int32),
                outs["num_off"].to(torch.int32),
                outs["t_prev"].to(torch.float32).view(torch.int32),
                outs["t_frame"].to(torch.float32).view(torch.int32),
                n_occ.reshape(1).to(torch.int32),
            ]
        )
    packed = {"scalars": scalars, "sparse": sparse}
    if cfg.probe is not None:
        packed["probe"] = outs["probe"]
    return packed


def unpack_scalars(scalars) -> Dict:
    """Host-side inverse of the scalar packing."""
    scalars = np.asarray(scalars)
    F = (scalars.shape[0] - 1) // 6
    return {
        "stride": scalars[0:F],
        "K": scalars[F: 2 * F],
        "num_on": scalars[2 * F: 3 * F],
        "num_off": scalars[3 * F: 4 * F],
        "t_prev": scalars[4 * F: 5 * F].view(np.float32),
        "t_frame": scalars[5 * F: 6 * F].view(np.float32),
        "n_occ": int(scalars[-1]),
    }
