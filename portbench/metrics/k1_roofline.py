"""k1_roofline: K1's bound (yardstick.k1_bytes, 13 B per pixel-frame
with leak and shot noise on) over its device time, over its launches in
the traced window (one per chunk of `chunk_frames` frames)."""
from portbench.readers import kernel_roofline_pct
from portbench.yardstick import bound_s, k1_bytes


def read(run):
    if not run.counts.get("chunk_frames"):
        return None
    px = run.counts["pixel"]
    b = bound_s(k1_bytes(int(run.counts["chunk_frames"]), *run.counts["hw"],
                         leak=px["leak_rate_hz"] > 0, shot=px["shot_noise_rate_hz"] > 0))
    return kernel_roofline_pct(run, "refr_persistent", b)
