"""The port's DDD20 data layer (v2e_tpu_torch/io/ddd.py, utils/roi.py) and
dataset tools (v2e_tpu_torch/dataset_tools: the four DDD tools and
batch_convert) against v2e_tpu's and the repository's dataset_tools, on the
CPU, on the synthetic recording tests/test_ddd.py builds.

Tolerance: the codec, the readers, the writer's rows, the ROI helpers, the
calibrated thresholds, the real-event files and the extracted frame times
are equal; the synthetic event totals (the emulator behind the tools, noise
and threshold mismatch off) within tests/test_torch_cli.py's 0.1 %.
ddd_v2e's SuperSloMo runs float32 UNets on both sides, as
tests/test_torch_cli_variants.py does: in bf16 the two frameworks' UNets
leave 5 % of the 260x346 interpolated pixels one or two levels apart
(69,079 of 1.35 M on the textured recording below), which moves 0.34 % of
the events (150 of 44,633); in float32, 5 pixels.
"""
import os

import cv2
import h5py
import numpy as np
import pytest

import dataset_tools.batch_convert as jax_batch
import dataset_tools.ddd_extract_data as jax_extract
import dataset_tools.ddd_find_thresholds as jax_thres
import dataset_tools.ddd_plot_event_counts as jax_plot
import dataset_tools.ddd_v2e as jax_v2e
import v2e_tpu.io.ddd as jax_ddd
import v2e_tpu.utils.roi as jax_roi
from test_ddd import (  # noqa: F401 (ddd_file is a fixture)
    H,
    W,
    caer_header,
    ddd_file,
    frame_packet,
    polarity_packet,
)
from test_torch_cli import RTOL_EVENTS
from test_torch_cli_rounding import float32_slomo
from test_torch_train import one_torch_thread  # noqa: F401 (autouse fixture)
from v2e_tpu_torch.dataset_tools import (
    batch_convert,
    ddd_extract_data,
    ddd_find_thresholds,
    ddd_plot_event_counts,
    ddd_v2e,
)
from v2e_tpu_torch.io import ddd
from v2e_tpu_torch.utils import roi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "slomo_golden.npz")
QUIET = ["--cutoff_hz", "0", "--leak_rate_hz", "0", "--shot_noise_rate_hz", "0",
         "--sigma_thres", "0"]


def aedat_payload(path):
    """An AEDAT-2 file's bytes after its '#' header lines (which hold the
    time of writing)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while data.startswith(b"#", pos):
        pos = data.index(b"\r\n", pos) + 2
    return data[pos:]


def packets():
    img = np.arange(H * W, dtype=np.uint16).reshape(H, W) * 3
    special = np.array([[0, 5], [4, 9]], np.uint32)
    return [
        polarity_packet([(42, 10, 20, 1), (50, 345, 259, 0), (61, 0, 0, 1)]),
        frame_packet(7_000_000, img),
        (caer_header(0, 8, 2), special.tobytes()),
    ]


@pytest.mark.parametrize("rotate180", [True, False])
def test_codec_matches(rotate180):
    for hdr, payload in packets():
        want, got = jax_ddd.unpack_header(hdr), ddd.unpack_header(hdr)
        assert got == want
        want["dvs_data"] = got["dvs_data"] = payload
        want, got = jax_ddd.unpack_data(want, rotate180), ddd.unpack_data(got, rotate180)
        assert got["timestamp"] == want["timestamp"]
        np.testing.assert_array_equal(got["data"], want["data"])
        if got["etype"] == "frame_event":
            np.testing.assert_array_equal(ddd.filter_frame(got), jax_ddd.filter_frame(want))


@pytest.mark.parametrize("rotate180", [True, False])
def test_readers_match(ddd_file, rotate180):
    want = jax_ddd.DDD20SimpleReader(ddd_file, rotate180=rotate180)
    got = ddd.DDD20SimpleReader(ddd_file, rotate180=rotate180)
    for k in ("numPackets", "firstPacketNumber", "firstTimeS", "lastTimeS", "durationS"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.search(0.4) == want.search(0.4)
    for (fw, ew), (fg, eg) in ((want.readEntire(), got.readEntire()),
                               (want.readEntire(0.4), got.readEntire(0.4))):
        assert fg.dtype == fw.dtype
        np.testing.assert_array_equal(fg["ts"], fw["ts"])
        np.testing.assert_array_equal(fg["frame"], fw["frame"])
        np.testing.assert_array_equal(eg, ew)
    want.close()
    got.close()

    want = jax_ddd.DDD20StreamingReader(ddd_file, rotate180=rotate180)
    got = ddd.DDD20StreamingReader(ddd_file, rotate180=rotate180)
    pw, pg = list(want), list(got)
    want.close()
    got.close()
    assert [p["etype"] for p in pg] == [p["etype"] for p in pw]
    for a, b in zip(pg, pw):
        assert a["timestamp"] == b["timestamp"]
        np.testing.assert_array_equal(a["data"], b["data"])


def test_writer_matches(tmp_path):
    rows = {}
    for name, mod in (("jax", jax_ddd), ("port", ddd)):
        path = str(tmp_path / f"{name}.hdf5")
        w = mod.DDDH5Writer(path)
        for hdr, payload in packets():
            w.append_packet(hdr, payload)
        for i in range(130):  # > one chunk of 128
            w.append("imu", 0.01 * i, np.full((6,), i, dtype=np.float32))
        w.close()
        with h5py.File(path, "r") as f:
            rows[name] = ([bytes(c) for row in f["dvs"]["data"][...] for c in row],
                          f["dvs"]["imu"][...])
    assert rows["port"][0] == rows["jax"][0]
    np.testing.assert_array_equal(rows["port"][1], rows["jax"][1])


def test_roi_matches(tmp_path):
    rng = np.random.default_rng(0)
    ev = np.stack([np.sort(rng.uniform(0, 1, 400)), rng.integers(0, 346, 400),
                   rng.integers(0, 260, 400), rng.choice([-1, 1], 400)], axis=1)
    for x, y in ((None, None), ((50, 300), None), ((50, 300), (20, 200))):
        np.testing.assert_array_equal(roi.select_events_in_roi(ev, x, y),
                                      jax_roi.select_events_in_roi(ev, x, y))
    for kw in ({}, {"polarity": 1, "time_bin_ms": 20.0}, {"start": 0.2, "stop": 0.9}):
        np.testing.assert_array_equal(roi.histogram_events_in_time_bins(ev, **kw),
                                      jax_roi.histogram_events_in_time_bins(ev, **kw))
    txt = tmp_path / "ev.txt"
    np.savetxt(txt, np.column_stack([ev[:, :3], (ev[:, 3] > 0)]), header="t x y p")
    np.testing.assert_array_equal(roi.read_aedat_txt_events(str(txt)),
                                  jax_roi.read_aedat_txt_events(str(txt)))


def test_extract_tool_matches(ddd_file, tmp_path):
    out = {}
    for name, tool in (("jax", jax_extract.main), ("port", ddd_extract_data.main)):
        out[name] = str(tmp_path / name)
        assert tool(["-i", ddd_file, "-o", out[name], "--rotate180", "false"]) == 0
    assert aedat_payload(os.path.join(out["port"], "dvs.aedat")) == \
        aedat_payload(os.path.join(out["jax"], "dvs.aedat"))
    for f in ("aps-frame_times.txt", "aps.avi"):
        with open(os.path.join(out["port"], f), "rb") as a, \
                open(os.path.join(out["jax"], f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.fixture
def ddd_textured(tmp_path):
    """Four APS frames of a blurred texture with a bright bar moving 9 px
    per frame, 40 ms apart, and one polarity packet: motion for
    SuperSloMo to interpolate (ddd_file's two frames are flat)."""
    rng = np.random.default_rng(4)
    tex = cv2.GaussianBlur(rng.uniform(0, 1, (H, W)).astype(np.float32), (0, 0), 2.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    path = str(tmp_path / "textured.hdf5")
    w = ddd.DDDH5Writer(path)
    for i in range(4):
        f = 60 + 120 * tex
        f[:, 40 + 9 * i:52 + 9 * i] += 60
        img = (np.clip(f, 0, 255).astype(np.uint16) * 256)
        w.append_packet(*frame_packet(1_000_000 + 40_000 * i, img))
        if i == 1:
            w.append_packet(*polarity_packet([(1_050_000, 10, 20, 1), (1_060_000, 30, 40, 0)]))
    w.close()
    return path


@pytest.mark.parametrize("slomo", [False, True], ids=["disable_slomo", "golden_slomo"])
def test_ddd_v2e_tool_matches(ddd_file, ddd_textured, tmp_path, monkeypatch, slomo):
    if slomo:
        ddd_file = ddd_textured
        float32_slomo(monkeypatch)
    flags = QUIET + (["--slomo_model", GOLDEN, "--timestamp_resolution", "0.008"] if slomo
                     else ["--disable_slomo"])
    out = {}
    for name, tool, kw in (("jax", jax_v2e.main, {}),
                           ("port", ddd_v2e.main, {"device": "cpu"})):
        out[name] = str(tmp_path / name)
        assert tool(["-i", ddd_file, "-o", out[name], "--rotate180", "false",
                     "--numpy_output"] + flags, **kw) == 0
    assert aedat_payload(os.path.join(out["port"], "ddd-real.aedat")) == \
        aedat_payload(os.path.join(out["jax"], "ddd-real.aedat"))
    np.testing.assert_array_equal(np.load(os.path.join(out["port"], "events-real.npy")),
                                  np.load(os.path.join(out["jax"], "events-real.npy")))
    syn = {k: np.load(os.path.join(v, "events-v2e.npy")) for k, v in out.items()}
    assert syn["jax"].shape[0] > 0
    assert abs(syn["port"].shape[0] - syn["jax"].shape[0]) <= RTOL_EVENTS * syn["jax"].shape[0]
    if not slomo:  # 100 -> 160 DN at thres 0.2: 2 ON events per pixel, on both
        assert syn["port"].shape[0] == syn["jax"].shape[0] == 2 * H * W
    for f in ("dvs-video-real.avi", "dvs-video-fake.avi"):
        assert os.path.getsize(os.path.join(out["port"], f)) > 0


def test_find_thresholds_tool_matches(tmp_path, capsys):
    """tests/test_ddd.py's recording: frames drifting in log intensity and a
    polarity packet with the counts v2e_tpu's emulator makes at threshold
    0.3; both tools must calibrate the same thresholds."""
    rng = np.random.default_rng(3)
    F = 6
    times_us = (1_000_000 + np.arange(F) * 33_000).astype(np.int64)
    vals = np.clip(128 * np.exp(np.cumsum(rng.normal(0, 0.12, (F, H, W)), axis=0)),
                   1, 255).astype(np.uint8)
    from v2e_tpu.emulator import EventEmulator

    em = EventEmulator(pos_thres=0.3, neg_thres=0.3, sigma_thres=0.0, leak_rate_hz=0.0,
                       cutoff_hz=0.0, shot_noise_rate_hz=0.0, seed=42)
    em.generate_events_batch(vals.astype(np.float32), times_us.astype(np.float64) / 1e6)
    n_on, n_off = int(em.num_events_on), int(em.num_events_off)
    evs = [(1_010_000 + k, 10 + (k % 300), 20 + (k % 200), 1) for k in range(n_on)]
    evs += [(1_020_000 + k, 11 + (k % 300), 21 + (k % 200), 0) for k in range(n_off)]
    path = str(tmp_path / "rec.hdf5")
    w = ddd.DDDH5Writer(path)
    for t, v in zip(times_us, vals):
        w.append_packet(*frame_packet(int(t), v.astype(np.uint16) * 256))
    w.append_packet(*polarity_packet(evs))
    w.close()

    lines = []
    for tool, kw in ((jax_thres.main, {}), (ddd_find_thresholds.main, {"device": "cpu"})):
        assert tool(["-i", path, "--rotate180", "false", "--max_iter", "7"] + QUIET, **kw) == 0
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("pos_thres=")])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    pos, neg = (float(p.split("=")[1]) for p in lines[0][0].split())
    assert abs(pos - 0.3) < 0.1 and abs(neg - 0.3) < 0.1


def test_plot_tool_matches(tmp_path):
    rng = np.random.default_rng(0)

    def mk(n):
        ev = np.empty((n, 4))
        ev[:, 0] = np.sort(rng.uniform(0, 1, n))
        ev[:, 1] = rng.integers(0, 346, n)
        ev[:, 2] = rng.integers(0, 260, n)
        ev[:, 3] = rng.choice([-1, 1], n)
        return ev

    np.save(tmp_path / "real.npy", mk(500))
    np.save(tmp_path / "v2e.npy", mk(480))
    images = []
    for name, tool in (("jax", jax_plot.main), ("port", ddd_plot_event_counts.main)):
        out = str(tmp_path / f"{name}.png")
        assert tool(["--real", str(tmp_path / "real.npy"), "--v2e", str(tmp_path / "v2e.npy"),
                     "--roi_x", "50", "300", "--roi_y", "50", "200", "-o", out]) == 0
        images.append(cv2.imread(out))
    assert images[0].size > 0
    np.testing.assert_array_equal(images[1], images[0])


def test_batch_convert_matches(tmp_path):
    """Two videos in a two-class tree, converted by both tools without
    SuperSloMo, noise or threshold mismatch: the tree mirrored, the event
    totals within 0.1 %."""
    rng = np.random.default_rng(0)
    for sub, name in (("classA", "v1"), ("classB", "v2")):
        d = tmp_path / "in" / sub
        d.mkdir(parents=True)
        vw = cv2.VideoWriter(str(d / f"{name}.avi"), cv2.VideoWriter_fourcc(*"XVID"),
                             30, (48, 36), False)
        base = rng.integers(50, 200, (36, 48), dtype=np.uint8)
        for i in range(8):
            vw.write(np.roll(base, i * 2, axis=1))
        vw.release()
    flags = ["--disable_slomo", "--dvs_h5", "", "--dvs_text", "ev.txt",
             "--output_width", "48", "--output_height", "36",
             "--refractory_period", "0"] + QUIET
    for name, tool, kw in (("jax", jax_batch.main, {}),
                           ("port", batch_convert.main, {"device": "cpu"})):
        assert tool(["-i", str(tmp_path / "in"), "-o", str(tmp_path / name)] + flags, **kw) == 0
    assert batch_convert.find_videos(str(tmp_path / "in"), {".avi"}) == \
        jax_batch.find_videos(str(tmp_path / "in"), {".avi"})
    for sub, name in (("classA", "v1"), ("classB", "v2")):
        n = [np.loadtxt(tmp_path / k / sub / name / "ev.txt", comments="#").reshape(-1, 4)
             .shape[0] for k in ("jax", "port")]
        assert n[0] > 0 and abs(n[1] - n[0]) <= RTOL_EVENTS * n[0], (sub, n)
