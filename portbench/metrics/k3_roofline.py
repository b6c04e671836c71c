"""k3_roofline: K3's bound (yardstick.k3_bytes of the planes a chunk
has to warp: 2 passes x I0, I1 x U x B at the UNets' size) over its device
time, per chunk traced."""
from portbench.readers import traced_chunks
from portbench.yardstick import bound_s, k3_bytes, slomo_warp_planes


def read(run):
    n = traced_chunks(run)
    if not n or not run.counts.get("upsampling"):
        return None
    ks = run.trace_data.kernels("warp_kernel")
    t = sum(e - s for s, e, _ in ks) / 1e9
    if t <= 0:
        return None
    h, w = run.counts["unet_hw"]
    planes = slomo_warp_planes(int(run.counts["pairs"]), int(run.counts["upsampling"]))
    return 100.0 * n * bound_s(k3_bytes(planes, h, w)) / t
