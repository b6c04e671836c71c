"""k2_roofline: K2's bound (yardstick.k2_bytes) over its device time,
over its launches in the traced window (one per chunk)."""
from portbench.readers import kernel_roofline_pct
from portbench.yardstick import bound_s, k2_bytes


def read(run):
    if not run.counts.get("chunk_frames"):
        return None
    px = run.counts["pixel"]
    noisy = px["leak_rate_hz"] > 0 or px["shot_noise_rate_hz"] > 0
    b = bound_s(k2_bytes(int(run.counts["chunk_frames"]), *run.counts["hw"], noisy=noisy))
    return kernel_roofline_pct(run, "scan_persistent", b)
