"""The port's CLI with the emulator variants against the JAX package's CLI
(CPU): --scidvs, --cs_lambda_pixels/--cs_tau_p_ms, the single-pixel probe
(--record_single_pixel_states), the model-state videos
(--show_dvs_model_state all --save_dvs_model_state), and
--checkpoint_state followed by --resume_state.

The input, the golden SuperSloMo fixture and the deterministic emulator
flags are test_torch_cli.py's, at a fixed U=7 and --cutoff_hz 0 (1 staged
and 2 fused windows: the probe and the state frames travel with both kinds
of chunk).  Tolerances are test_torch_cli.py's: total events within 0.1 %,
per-pixel ON and OFF counts by at most one event at no more than 1 % of the
pixels (bf16 UNet roundings move events to a neighbouring interpolated
frame).  The probe's record and the state videos: the same names, keys and
sample or frame counts (one per emulated frame: the interpolated frames but
the first, which initializes the emulator), and the probe's times equal.

--scidvs and --cs_lambda_pixels run with the UNets in float32 on both
sides, as test_torch_cli_rounding.py isolates SloMo: there the events were
equal, event for event (179,153 for SciDVS at U=96, 2,985 for CSDVS at
U=7).  In the CLI's bf16 a level flip moves a CSDVS event through the
surround as well (16 events of 2,973 apart, at 30 pixels), and SciDVS's
highpass, an explicit Euler step, grows it where the frame interval
exceeds twice a pixel's time constant (U=7 gives 4.8 ms against a
lognormal map around 10 ms: totals 1-5 % apart, also in float32), so
SciDVS runs at U=96 (0.35 ms).
SciDVS also draws that time-constant map at its first frame, and no flag
turns it off; the two packages' generators differ, so the port's CLI is
handed the map the JAX CLI drew (`same_scidvs_tau`), as the other flags
make every other parameter map equal.

--resume_state loads the checkpoint before the conversion, whose frame
times start at 0 again in both CLIs, so a resume over a checkpoint taken
after frame 0 stops with the same ValueError in both ("earlier than
previous"); a checkpoint of the first frame alone (--disable_slomo
--stop_time 0.04) resumes, and the resumed runs agree.
"""
import os
import pickle

import cv2
import dataclasses
import numpy as np
import pytest
import torch

import v2e_tpu.emulator.emulator as jax_emulator
import v2e_tpu_torch.emulator.emulator as port_emulator

from test_torch_cli_rounding import float32_slomo
from test_torch_cli import (  # noqa: F401 (frames_dir is a fixture)
    AUTO_U96,
    FIXED_U7,
    N_FRAMES,
    RTOL_EVENTS,
    assert_pixel_counts_close,
    common_args,
    events,
    frames_dir,
)
from v2e_tpu.cli import main as jax_main
from v2e_tpu_torch import cli

U = 7
N_OUT = (N_FRAMES - 1) * U
N_EMULATED = N_OUT - 1


def run_both(frames_dir, tmp_path, flags, u_flags=FIXED_U7, u=U):
    assert jax_main(common_args(frames_dir, tmp_path / "jax") + u_flags + flags) == 0
    stats = cli.run(common_args(frames_dir, tmp_path / "port") + u_flags + flags, device="cpu")
    assert (stats.staged_chunks, stats.fused_chunks) == (1, 2)
    assert stats.upsampling == [u] * 3
    assert stats.n_frames == (N_FRAMES - 1) * u
    a, b = events(tmp_path / "jax"), events(tmp_path / "port")
    assert len(a) > 2000
    assert abs(len(a) - len(b)) <= RTOL_EVENTS * len(a)
    assert stats.num_events == len(b)
    assert_pixel_counts_close(a, b, 0.01)
    return stats


@pytest.fixture
def same_scidvs_tau(monkeypatch):
    """The port's emulator takes the SciDVS tau map the JAX one drew."""
    drawn = []
    jax_init, port_init = jax_emulator.init_state, port_emulator.init_state

    def jax_side(*a):
        params, state = jax_init(*a)
        drawn.append(np.array(params.scidvs_tau_arr))
        return params, state

    def port_side(*a):
        params, state = port_init(*a)
        tau = torch.from_numpy(drawn[-1]).to(params.pos_thres.device)
        return dataclasses.replace(params, scidvs_tau_arr=tau), state

    monkeypatch.setattr(jax_emulator, "init_state", jax_side)
    monkeypatch.setattr(port_emulator, "init_state", port_side)
    return drawn


def test_scidvs_matches_jax(frames_dir, tmp_path, monkeypatch, same_scidvs_tau):
    float32_slomo(monkeypatch)
    run_both(frames_dir, tmp_path, ["--scidvs", "--dvs_emulator_seed", "1"], AUTO_U96, 96)
    assert len(same_scidvs_tau) == 1 and same_scidvs_tau[0].std() > 0


def test_csdvs_matches_jax(frames_dir, tmp_path, monkeypatch):
    float32_slomo(monkeypatch)
    run_both(frames_dir, tmp_path, ["--cs_lambda_pixels", "2", "--cs_tau_p_ms", "3"])


def test_single_pixel_probe_matches_jax(frames_dir, tmp_path):
    run_both(frames_dir, tmp_path, ["--record_single_pixel_states", "(40,20)"])
    rec = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "pixel-states.dat", "rb") as f:
            rec[side] = pickle.load(f)
    assert set(rec["port"]) == set(rec["jax"])
    for key in rec["jax"]:
        n = np.isfinite(rec["port"][key]).sum()
        assert n == np.isfinite(rec["jax"][key]).sum() == N_EMULATED, key
    np.testing.assert_array_equal(rec["port"]["time"], rec["jax"]["time"])


def frame_count(path):
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_model_state_videos_match_jax(frames_dir, tmp_path):
    run_both(frames_dir, tmp_path, ["--show_dvs_model_state", "all", "--save_dvs_model_state"])
    names = {side: sorted(n for n in os.listdir(tmp_path / side)
                          if n.endswith(".avi") and n != "dvs-video.avi")
             for side in ("jax", "port")}
    assert names["port"] == names["jax"] and len(names["jax"]) == 6
    for name in names["jax"]:
        n = frame_count(tmp_path / "port" / name)
        assert n == frame_count(tmp_path / "jax" / name) == N_EMULATED, name


def test_checkpoint_then_resume_matches_jax(frames_dir, tmp_path):
    direct = ["--disable_slomo", "--chunk_size", "5"]
    for side, main in (("jax", jax_main), ("port", lambda a: cli.main(a, device="cpu"))):
        ckpt = str(tmp_path / f"{side}.npz")
        first = common_args(frames_dir, tmp_path / side / "first") + direct
        assert main(first + ["--stop_time", "0.04", "--checkpoint_state", ckpt]) == 0
        assert os.path.isfile(ckpt)
        resumed = common_args(frames_dir, tmp_path / side / "resumed") + direct
        assert main(resumed + ["--resume_state", ckpt]) == 0
        # a checkpoint after the last frame: the restarted frame times are earlier
        assert main(first + ["--checkpoint_state", ckpt]) == 0
        with pytest.raises(ValueError, match="earlier than previous"):
            main(common_args(frames_dir, tmp_path / side / "late") + direct
                 + ["--resume_state", ckpt])
    a, b = events(tmp_path / "jax" / "resumed"), events(tmp_path / "port" / "resumed")
    assert len(a) > 500
    assert abs(len(a) - len(b)) <= RTOL_EVENTS * len(a)
    assert_pixel_counts_close(a, b, 0.0)
