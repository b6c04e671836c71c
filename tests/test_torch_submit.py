"""The conversion's submit and fetch without host waits, on the CPU: the
resize weights cached on the device give the values the numpy matrices
gave; the staging copy of an upload is exact for every dtype and layout;
the sync-free select equals torch.nonzero truncated and padded; the
rebase by a Python float equals the rebase by a float32 tensor bit for
bit; a conversion whose chunks overflow their compaction capacity still
writes every event, recompacted in the fetch.  The card's side (no sync
under torch's sync debug mode, pinned staging against a reused buffer) is
in test_torch_submit_gpu.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from v2e_tpu_torch import tracing
from v2e_tpu_torch.device import host_copy, upload
from v2e_tpu_torch.emulator import EventEmulator
from v2e_tpu_torch.emulator.config import EmulatorConfig
from v2e_tpu_torch.emulator.core import compact_chunk, select_occupied
from v2e_tpu_torch.emulator.state import EmulatorState, rebase_state
from v2e_tpu_torch.models.resize import device_weight_matrix, resize, weight_matrix


def numpy_resize(x, out_hw, method):
    """The resize as it was: each weight matrix copied from numpy per call."""
    H, W = x.shape[-2:]
    if H != out_hw[0]:
        wh = torch.from_numpy(weight_matrix(H, out_hw[0], method)).to(x.device, x.dtype)
        x = torch.einsum("...hw,hH->...Hw", x, wh)
    if W != out_hw[1]:
        ww = torch.from_numpy(weight_matrix(W, out_hw[1], method)).to(x.device, x.dtype)
        x = torch.einsum("...hw,wW->...hW", x, ww)
    return x


@pytest.mark.parametrize("method,sizes", [("lanczos3", (260, 346, 256, 320)),
                                          ("bilinear", (256, 320, 260, 346))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_resize_weights_equal_the_numpy_path(method, sizes, dtype):
    H, W, oh, ow = sizes
    device_weight_matrix.cache_clear()
    n0 = tracing.counters().get("resize.upload", 0)
    x = torch.randn((3, H, W), generator=torch.Generator().manual_seed(1)).to(dtype)
    for _ in range(3):
        got = resize(x, (oh, ow), method)
        assert got.dtype == dtype and torch.equal(got, numpy_resize(x, (oh, ow), method))
    assert tracing.counters()["resize.upload"] == n0 + 2  # one per axis, once
    for n, m in ((H, oh), (W, ow)):
        w = device_weight_matrix(n, m, method, x.device, dtype)
        assert torch.equal(w, torch.from_numpy(weight_matrix(n, m, method)).to(dtype))
    resize(x.to(torch.float64), (oh, ow), method)  # another dtype: another key
    assert tracing.counters()["resize.upload"] == n0 + 4


def nonzero_select(occ, capacity):
    """The select as it was: torch.nonzero truncated to `capacity`, padded
    with occ.numel()."""
    idx = torch.full((capacity,), occ.numel(), dtype=torch.int32)
    found = torch.nonzero(occ).reshape(-1)[:capacity].to(torch.int32)
    idx[: found.shape[0]] = found
    return idx


@pytest.mark.parametrize("n_occ,capacity", [
    (0, 4096),      # nothing occupied
    (1000, 4096),   # below capacity
    (4096, 4096),   # at capacity
    (9000, 4096),   # above: the first 4096 in index order
    (60000, 64),    # far above
    (5, 1),
])
def test_select_occupied_equals_nonzero(n_occ, capacity):
    total = 60000
    rng = np.random.default_rng(n_occ + capacity)
    occ = np.zeros(total, bool)
    occ[rng.choice(total, n_occ, replace=False)] = True
    occ = torch.from_numpy(occ)
    got = select_occupied(occ, capacity)
    assert got.dtype == torch.int32 and torch.equal(got, nonzero_select(occ, capacity))


def test_compact_chunk_pads_with_the_plane_size():
    cfg = EmulatorConfig(shot_noise_rate_hz=5.0)
    g = torch.Generator().manual_seed(0)
    F, H, W = 3, 20, 30
    counts = (torch.randint(-2, 3, (F, H, W), generator=g)
              * (torch.rand((F, H, W), generator=g) < 0.05))
    outs = {"ev_count": counts.to(torch.int16),
            "i0": torch.randint(0, 4, (F, H, W), generator=g).to(torch.int16),
            "shot_on": torch.rand((F, H, W), generator=g) < 0.01,
            "shot_off": torch.rand((F, H, W), generator=g) < 0.01}
    occ = (outs["ev_count"] != 0) | outs["shot_on"] | outs["shot_off"]
    n = int(occ.sum())
    for cap in (n - 3, n, n + 7):
        sp = compact_chunk(cfg, outs, cap)
        idx = nonzero_select(occ.reshape(-1), cap)
        assert torch.equal(sp["idx"], idx)
        valid = idx < F * H * W
        safe = idx.clamp(max=F * H * W - 1).long()
        want = torch.where(valid, counts.reshape(-1)[safe], 0).to(torch.int16)
        assert torch.equal(sp["count"], want)
        assert not sp["shot"][~valid].any() and not sp["i0"][~valid].any()


@pytest.mark.parametrize("shift", [8.000123456789, 9.87654321, 8.5, 1e3 / 3])
def test_rebase_state_is_bit_identical_to_the_tensor_form(shift):
    g = torch.Generator().manual_seed(2)
    mem = torch.rand((30, 40), generator=g) * 12 - 1
    state = EmulatorState(base_log_frame=torch.zeros(1), lp_log_frame=torch.zeros(1),
                          photoreceptor_noise_arr=torch.zeros(1), timestamp_mem=mem,
                          t_prev=torch.tensor(10.123456, dtype=torch.float32))
    got = rebase_state(state, shift)
    s = torch.tensor(shift, dtype=torch.float32)
    want = dataclasses.replace(state, timestamp_mem=mem - s, t_prev=state.t_prev - s)
    for name in ("timestamp_mem", "t_prev"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == torch.float32 and torch.equal(a.view(torch.int32), b.view(torch.int32))


def run_conversion(capacity_hint):
    """A noisy 48x64 conversion in two 12-frame chunks; every frame changes
    most pixels, so a chunk holds far more occupied cells than 4096."""
    rng = np.random.default_rng(5)
    frames = rng.uniform(20, 230, (25, 48, 64)).astype(np.float32)
    times = np.arange(25) / 1000.0
    em = EventEmulator(device="cpu", seed=11, shot_noise_rate_hz=2.0, sigma_thres=0.03,
                       shuffle_events_within_iteration=False,
                       compaction_capacity_hint=capacity_hint)
    em.generate_events_batch(frames[:1], times[:1])
    events = [em.generate_events_batch(frames[a: a + 12], times[a: a + 12]) for a in (1, 13)]
    return np.concatenate(events), em


def test_capacity_overflow_recompacts_and_writes_every_event():
    n0 = tracing.counters().get("compact.recompact", 0)
    small, em = run_conversion(4096)
    assert tracing.counters()["compact.recompact"] >= n0 + 1
    assert em._capacity > 4096
    n1 = tracing.counters()["compact.recompact"]
    large, _ = run_conversion(1 << 20)
    assert tracing.counters()["compact.recompact"] == n1
    assert small.shape[0] > 4096 and np.array_equal(small, large)
    assert small.shape[0] == em.num_events_total


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.float64, torch.bfloat16,
                                   torch.bool])
@pytest.mark.parametrize("shape", [(9, 26, 34), (80,), (), (0, 5)])
def test_host_copy_is_an_exact_copy(dtype, shape):
    src = (torch.rand(shape, generator=torch.Generator().manual_seed(4)) * 255).to(dtype)
    got = host_copy(src)
    assert got.dtype == dtype and got.shape == src.shape
    assert torch.equal(got, src)
    if src.numel():
        assert got.data_ptr() != src.data_ptr()
    strided = src.transpose(0, -1) if src.ndim > 1 else src
    assert torch.equal(host_copy(strided), strided)


def test_upload_to_the_cpu_is_the_array_itself():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = upload(x, torch.device("cpu"))
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), x)
