"""The conversion's submit and fetch on the card: no host wait.

Marked `gpu`; each test skips when no CUDA device is present.  On an H100:
    python -m pytest --noconftest tests/test_torch_submit_gpu.py -q
* a steady fused chunk (after a staged chunk and one fused chunk of its
  shape) raises nothing under torch.cuda.set_sync_debug_mode("error"),
  with K1 (the CLI's default refractory period) and with K2 (the noisy
  preset), at a small shape and at the benchmark's DAVIS346 shape (8
  pairs, U = 10, base-32 bf16 UNets);
* so does a staged chunk at fixed U, its slices consumed, after one
  warm-up chunk (which fills the resize's weight cache): its warp window
  follows from U alone, with no read of the flow;
* twelve fused chunks submitted back to back, the source's numpy buffer
  overwritten as soon as each submit returns and the chunks fetched by
  ChunkPipeline's threads, give the events of the same chunks with the
  card synchronised after every submit: the pinned staging copy is taken
  before submit returns, and each fetch waits for its own chunk.
"""
import numpy as np
import pytest
import torch

from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.emulator.pipeline import ChunkPipeline
from v2e_tpu_torch.fused import FusedConverter
from v2e_tpu_torch.models.slomo import SuperSloMo
from v2e_tpu_torch.synthetic import make_source_frames

pytestmark = pytest.mark.gpu

H, W, B, U = 96, 128, 4, 10
DAVIS346 = (260, 346, 8, 32)  # H, W, pairs, UNet base


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def converter(preset, h=H, w=W, pairs=B, base=8):
    slomo = SuperSloMo(None, upsampling_factor=U, batch_size=pairs, allow_random=True,
                       device="cuda", base=base)
    em = EventEmulator(device="cuda", seed=7, refractory_period_s=5e-4,
                       shuffle_events_within_iteration=False, output_width=w,
                       output_height=h)
    if preset:
        em.set_dvs_params(preset)
    return FusedConverter(slomo, em), em


def windows(n, h=H, w=W, pairs=B):
    src = make_source_frames(pairs * n + 1, h, w, seed=3).astype(np.uint8)
    return [(src[pairs * c: pairs * c + pairs + 1], pairs * c) for c in range(n)]


@pytest.mark.parametrize("shape", [(H, W, B, 8), DAVIS346], ids=["small", "davis346"])
@pytest.mark.parametrize("preset", [None, "noisy"])
def test_steady_fused_chunk_makes_no_host_sync(cuda, preset, shape):
    fc, em = converter(preset, *shape)
    (w0, p0), (w1, p1), (w2, p2) = windows(3, *shape[:3])
    for w, p in ((w0, p0), (w1, p1)):  # the staged chunk, then the shape's first
        handle, _, _ = fc.submit_window(w, p, 1 / 30)
        em.collect(handle)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle, _, _ = fc.submit_window(w2, p2, 1 / 30)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert handle.get("fused")
    events, _, _ = em.collect(handle)
    assert events.shape[0] > 0


def test_fixed_u_staged_chunk_makes_no_host_sync(cuda):
    fc, _ = converter(None)
    (w0, _), (w1, _) = windows(2)
    for _ in fc.slomo.interpolate_batch_slices(w0, H, W)[1]:
        pass
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, slices = fc.slomo.interpolate_batch_slices(w1, H, W)
        frames = [f for f, _ in slices]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert u == U and sum(f.shape[0] for f in frames) == B * U


def convert(preset, overwrite: bool):
    """13 windows (the staged chunk, then 12 fused ones) through one reused
    numpy buffer: overwritten with noise as soon as each submit returns
    (`overwrite`), or with the card synchronised after each submit."""
    fc, em = converter(preset)
    got = []
    pipe = ChunkPipeline(em, lambda ev, lab, off: got.append(ev), depth=6)
    buf = np.empty((B + 1, H, W), np.uint8)
    noise = np.random.default_rng(0)
    try:
        for w, p in windows(13):
            buf[:] = w
            handle, _, _ = fc.submit_window(buf, p, 1 / 30)
            if overwrite:
                buf[:] = noise.integers(0, 256, buf.shape, dtype=np.uint8)
            else:
                torch.cuda.synchronize()
            pipe.push_handle(handle)
    finally:
        pipe.close()
    assert fc.n_staged == 1
    return np.concatenate(got)


@pytest.mark.parametrize("preset", [None, "noisy"])
def test_back_to_back_chunks_equal_synchronised_ones(cuda, preset):
    ahead = convert(preset, overwrite=True)
    synced = convert(preset, overwrite=False)
    assert ahead.shape[0] > 0 and np.array_equal(ahead, synced)
