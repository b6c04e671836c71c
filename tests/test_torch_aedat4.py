"""The port's AEDAT-4 writer and readers (v2e_tpu_torch/io/aedat4.py)
against v2e_tpu's: the same events give byte-identical files, with and
without zstd and with 0, 1, 2 and 300 packets (the port lays the seek table
out by hand, v2e_tpu with the flatbuffers builder); the readers agree; and
the port writes with no flatbuffers package installed.
"""
import subprocess
import sys

import numpy as np
import pytest

from v2e_tpu.io import aedat4 as jax_aedat4
from v2e_tpu_torch.io import aedat4

REPO = __file__.rsplit("/tests/", 1)[0]


def packets(n_packets: int, seed: int = 0):
    """Event packets [t, x, y, p] at 346x260, sorted in time; the first
    starts at t = 0, so its start time is a flatbuffer default that the
    builder leaves out of the table."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for k in range(n_packets):
        n = int(rng.integers(1, 40))
        ev = np.empty((n, 4))
        ev[:, 0] = t + np.sort(rng.uniform(0, 2e-3, n))
        if k == 0:
            ev[0, 0] = 0.0
        ev[:, 1] = rng.integers(0, 346, n)
        ev[:, 2] = rng.integers(0, 260, n)
        ev[:, 3] = rng.choice([-1.0, 1.0], n)
        t = ev[-1, 0]
        out.append(ev)
    return out


class _ZeroedNumpy:
    """numpy with `empty` zeroed: v2e_tpu's writer builds each packet's
    event structs with np.empty, so their 3 pad bytes are whatever the
    memory held; the port zeroes them.  Giving v2e_tpu zeroed memory makes
    its files deterministic, and the comparison byte for byte."""

    empty = staticmethod(np.zeros)

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture(autouse=True)
def zeroed_jax_structs(monkeypatch):
    monkeypatch.setattr(jax_aedat4, "np", _ZeroedNumpy())


def write(module, path, pkts, compression):
    w = module.AEDat4Output(str(path), 346, 260, compression=compression)
    for ev in pkts:
        w.appendEvents(ev)
    w.appendEvents(np.empty((0, 4)))  # an empty packet writes nothing
    w.close()
    return path.read_bytes()


@pytest.mark.parametrize("compression", ["none", "zstd"])
@pytest.mark.parametrize("n_packets", [0, 1, 2, 300])
def test_files_byte_identical_and_read_back(tmp_path, compression, n_packets):
    pkts = packets(n_packets, seed=n_packets)
    port = write(aedat4, tmp_path / "p.aedat4", pkts, compression)
    ref = write(jax_aedat4, tmp_path / "j.aedat4", pkts, compression)
    assert port == ref
    ev = aedat4.read_aedat4(str(tmp_path / "p.aedat4"))
    np.testing.assert_array_equal(ev, jax_aedat4.read_aedat4(str(tmp_path / "p.aedat4")))
    want = np.concatenate(pkts) if pkts else np.empty((0, 4))
    assert ev.shape == want.shape
    np.testing.assert_array_equal(ev[:, 1:], want[:, 1:])
    np.testing.assert_array_equal(ev[:, 0], (want[:, 0] * 1e6).astype(np.int64) * 1e-6)
    table = aedat4.read_aedat4_data_table(str(tmp_path / "p.aedat4"))
    assert table == jax_aedat4.read_aedat4_data_table(str(tmp_path / "p.aedat4"))
    assert [e["num_elements"] for e in table] == [len(p) for p in pkts]
    if n_packets:
        assert table[0]["timestamp_start"] == 0


def test_seek_table_equals_the_flatbuffers_builder():
    """Seek tables with every int64 field at its default 0 in some entries
    (fields left out, vtables shared only among equal layouts)."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 17):
        entries = []
        for _ in range(n):
            off, num, ts0, ts1 = (int(v) for v in rng.integers(0, 3, 4) * rng.integers(1, 1 << 40, 4))
            entries.append((off, int(rng.integers(0, 2)), int(rng.integers(0, 1 << 20)), num, ts0, ts1))
        assert (aedat4._file_data_table_flatbuffer(entries)
                == jax_aedat4._file_data_table_flatbuffer(entries))


def test_writer_needs_no_flatbuffers(tmp_path):
    """A process where `import flatbuffers` fails still writes the file,
    and it reads back."""
    code = (
        "import sys; sys.modules['flatbuffers'] = None\n"
        "import numpy as np\n"
        "from v2e_tpu_torch.io.aedat4 import AEDat4Output, read_aedat4, read_aedat4_data_table\n"
        f"p = {str(tmp_path / 'x.aedat4')!r}\n"
        "w = AEDat4Output(p, 346, 260)\n"
        "w.appendEvents(np.array([[0.001, 3, 4, 1], [0.002, 5, 6, -1]]))\n"
        "w.appendEvents(np.array([[0.003, 7, 8, 1]]))\n"
        "w.close()\n"
        "assert read_aedat4(p).shape == (3, 4)\n"
        "assert [e['num_elements'] for e in read_aedat4_data_table(p)] == [2, 1]\n"
        "assert 'flatbuffers' not in {m for m in sys.modules if sys.modules[m] is not None}\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
