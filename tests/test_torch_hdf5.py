"""The port's HDF5 sink (v2e_tpu_torch/io/hdf5.py) against v2e_tpu's: the
same events and frames give the same datasets, with and without the DDD
frame storage; and the package imports with no h5py.
"""
import subprocess
import sys

import h5py
import numpy as np
import pytest

from v2e_tpu.io.hdf5 import DVSH5Output as JaxH5
from v2e_tpu_torch.io.hdf5 import DVSH5Output

REPO = __file__.rsplit("/tests/", 1)[0]
H, W = 20, 28


def feed(cls, path, ddd: bool, n_frames: int = 6):
    rng = np.random.default_rng(0)
    out = cls(str(path))
    if ddd:
        out.prepare_frame_storage(None, None, H, W)
    t = 0.0
    for f in range(n_frames):
        frame = rng.uniform(-20, 280, (H, W)).astype(np.float32)  # clipped to uint8
        n = int(rng.integers(0, 50))
        ev = np.empty((n, 4))
        ev[:, 0] = t + np.sort(rng.uniform(0, 1 / 30, n))
        ev[:, 1] = rng.integers(0, W, n)
        ev[:, 2] = rng.integers(0, H, n)
        ev[:, 3] = rng.choice([-1.0, 1.0], n)
        out.appendFrame(frame, ts=t, ev_idx=out.numEventsWritten + n)
        out.appendEvents(ev)
        t += 1 / 30
    out.close()
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}


@pytest.mark.parametrize("ddd", [False, True], ids=["events", "ddd"])
def test_datasets_equal_v2e_tpu(tmp_path, ddd):
    port = feed(DVSH5Output, tmp_path / "p.h5", ddd)
    ref = feed(JaxH5, tmp_path / "j.h5", ddd)
    assert sorted(port) == sorted(ref)
    assert sorted(port) == (["events", "frame", "frame_idx", "frame_ts"] if ddd else ["events"])
    for k in port:
        assert port[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert port["events"].shape[1] == 4 and port["events"].shape[0] > 0
    if ddd:
        assert port["frame"].shape == (6, H, W)
        assert port["frame_idx"][-1] == port["events"].shape[0]


def test_io_imports_without_h5py():
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import v2e_tpu_torch.io, v2e_tpu_torch.models.slomo_cache\n"
            "from v2e_tpu_torch.io import DVSH5Output\n"
            "try:\n    DVSH5Output('x.h5')\nexcept ImportError:\n    pass\n"
            "else:\n    sys.exit('opened an HDF5 file without h5py')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
