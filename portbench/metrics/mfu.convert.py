"""mfu.convert: the UNets' FLOPs of the chunks done in the window
(yardstick.slomo_chunk_flops: the flow UNet per pair, the refinement UNet
per pair and intermediate time), over the window's seconds, as a share of
the H100's dense bf16 peak."""
from portbench.readers import window_done
from portbench.yardstick import PEAK_BF16_FLOP_S, slomo_chunk_flops


def read(run):
    if not run.counts.get("upsampling") or run.window_s <= 0:
        return None
    h, w = run.counts["unet_hw"]
    flops = len(window_done(run)) * slomo_chunk_flops(
        int(run.counts["pairs"]), int(run.counts["upsampling"]), h, w, int(run.counts["base"]))
    return 100.0 * flops / run.window_s / PEAK_BF16_FLOP_S
